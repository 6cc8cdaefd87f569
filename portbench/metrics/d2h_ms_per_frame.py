"""Layer: device copies.  The union of the device-to-host copies' intervals
in the trace of the window, over the frames the read calls returned; ms a
frame."""

from portbench.tracefile import union_s


def read(run):
    frames = run.frames_done()
    spans = run.trace.intervals("gpu_memcpy", "DtoH")
    return union_s(spans) / frames * 1e3 if frames and spans else None
