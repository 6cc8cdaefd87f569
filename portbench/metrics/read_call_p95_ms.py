"""Layer: reader (``reader.py``: ``read_frames_dense``).  The 95th
percentile (numpy's linear interpolation) of the latency of all read calls
of the window, the benchmark's host clock around each (span
``read_frames_dense``); ms."""

import numpy as np


def read(run):
    return float(np.percentile([s["latency_s"] for s in run.steps], 95)) * 1e3
