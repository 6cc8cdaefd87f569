"""Layer: device copies.  The union of the host-to-device copies' intervals
in the trace of the window, over the frames written; ms a frame."""

from portbench.tracefile import union_s


def read(run):
    frames = run.frames_done()
    spans = run.trace.intervals("gpu_memcpy", "HtoD")
    return union_s(spans) / frames * 1e3 if frames and spans else None
