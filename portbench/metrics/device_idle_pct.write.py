"""Layer: device.  100 x (1 - the union of the kernel, memcpy and memset
intervals in the trace over the traced window's wall) in a write cell; %."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s() / (run.trace.hi - run.trace.lo))
