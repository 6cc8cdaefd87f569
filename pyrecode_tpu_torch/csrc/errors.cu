// Readable text for the cudaError_t codes the kernel entry points return.

#include <cuda_runtime.h>

extern "C" const char* pr_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
