"""The raw 16-bit frame bytes of every acquisition completed in the window
(server run plus merge) over the window's wall time; host clock, GB/s."""


def read(run):
    return sum(s["bytes"] for s in run.done()) / run.window_s / 1e9
