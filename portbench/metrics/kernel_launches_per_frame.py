"""Layer: launch path (``ops/_launch.py`` and the ``ops/hopper_*``
wrappers).  The change of ``kernel_launch_counts()`` over the window, summed
over the kernels, over the frames written; a count a frame."""


def read(run):
    frames = run.frames_done()
    return sum(run.launches.values()) / frames if frames else None
