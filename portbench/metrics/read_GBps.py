"""The raw 16-bit frame bytes that all read calls of the window returned,
over the window's wall time; host clock, GB/s."""


def read(run):
    return sum(s["bytes"] for s in run.done()) / run.window_s / 1e9
