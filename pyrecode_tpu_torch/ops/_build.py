"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, for Hopper (``sm_90a``), loaded with ``ctypes``.  The
library lives in ``pyrecode_tpu_torch/_build/<hash>/``, keyed by a hash of
every file in ``csrc/``, so an edited source builds anew and an unchanged
one is built once per checkout.  The build runs at first use: importing this
module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libpyrecode_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills of each kernel).
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objects, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"     # nvcc links by the suffix
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = [(proc.communicate()[0], proc.returncode) for proc in procs]
    failed = [out for out, rc in reports if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                          capture_output=True, text=True)
    for obj in objects:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    if verbose:
        print("".join(out for out, _ in reports))
        print(f"nvcc built {lib.name} in {time.perf_counter() - t0:.1f} s "
              f"({len(objects)} sources in parallel, then one link)")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; one instance per process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.pr_bitpack12.argtypes = [p, p, i64, p]
            lib.pr_bitunpack12.argtypes = [p, p, i64, p]
            lib.pr_bitpack12_words.argtypes = [p, p, i64, p]
            lib.pr_encode_l1.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_int, i64, i64, i64,
                                         ctypes.c_int, p, p, i64, p]
            lib.pr_decode_l1.argtypes = [p, p, p, p, p, i64, i64, i64, p]
            lib.pr_tokenize.argtypes = [p, p, p, p, p, p, i64, i64, p]
            lib.pr_tokenize_compact.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i64, p]
            lib.pr_assemble.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, p, i64, i64, i64, p]
            lib.pr_rans_hist.argtypes = [p, p, p, i64, i64, p]
            lib.pr_rans_encode.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64, i64,
                                           ctypes.c_int, p]
            lib.pr_rans_encode_tokens.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, p, i64, i64,
                                                  i64, i64, p]
            lib.pr_rans_encode_state.argtypes = [p, p, p, p, i64, p]
            lib.pr_rans_decode.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, ctypes.c_int, p]
            lib.pr_posdecode.argtypes = [p, p, p, p, p, i64, i64, i64, p]
            lib.pr_label_l2l4.argtypes = [p, p, p, p, p, p, p, p, p, p, ctypes.c_int, i64, i64,
                                          i64, i64, i64, p]
            lib.pr_bitmap_positions.argtypes = [p, p, p, p, p, i64, i64, i64, p]
            lib.pr_tokens_from_pairs.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64, i64, p]
            lib.pr_assemble_split.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, p, p, i64, i64,
                                              i64, p]
            lib.pr_encode_l1_phases.argtypes = [p, p, p, p, p, p, p, p, p, i64, i64, i64,
                                                ctypes.c_int, ctypes.c_int, p]
            lib.pr_decode_l1_phases.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, ctypes.c_int,
                                                p]
            lib.pr_probe_butterfly.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, i64, i64,
                                                p]
            lib.pr_probe_f32dot.argtypes = [p, p, p, ctypes.c_int, i64, i64, i64, p]
            lib.pr_probe_mosaic.argtypes = [ctypes.c_int, p, p, p]
            for fn in (lib.pr_bitpack12, lib.pr_bitunpack12, lib.pr_bitpack12_words, lib.pr_encode_l1,
                       lib.pr_decode_l1, lib.pr_tokenize, lib.pr_tokenize_compact,
                       lib.pr_assemble, lib.pr_rans_hist, lib.pr_rans_encode,
                       lib.pr_rans_encode_tokens, lib.pr_rans_encode_state, lib.pr_rans_decode,
                       lib.pr_posdecode, lib.pr_label_l2l4,
                       lib.pr_bitmap_positions, lib.pr_tokens_from_pairs, lib.pr_assemble_split,
                       lib.pr_encode_l1_phases, lib.pr_decode_l1_phases, lib.pr_probe_butterfly,
                       lib.pr_probe_f32dot, lib.pr_probe_mosaic):
                fn.restype = ctypes.c_int
            for fn in (lib.pr_num_tiles, lib.pr_deflate_tiles, lib.pr_tokenize_tiles,
                       lib.pr_pairs_tiles, lib.pr_label_tiles):
                fn.argtypes = [i64]
                fn.restype = i64
            lib.pr_encode_scratch_words.argtypes = [i64, i64, ctypes.c_int, ctypes.c_int]
            lib.pr_encode_scratch_words.restype = i64
            lib.pr_rans_encode_scratch_words.argtypes = [i64, i64, ctypes.c_int]
            lib.pr_rans_encode_scratch_words.restype = i64
            lib.pr_positions_status_words.argtypes = [i64, i64]
            lib.pr_positions_status_words.restype = i64
            lib.pr_split_window_words.argtypes = []
            lib.pr_split_window_words.restype = i64
            lib.pr_error_string.argtypes = [ctypes.c_int]
            lib.pr_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
