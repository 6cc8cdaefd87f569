"""The median (numpy's) of the latency of all read calls of the window, the
benchmark's host clock around each (span ``read_frames_dense``): what a
viewer or an analysis step waits for its frames; ms."""

import numpy as np


def read(run):
    return float(np.median([s["latency_s"] for s in run.steps])) * 1e3
