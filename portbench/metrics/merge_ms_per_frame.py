"""Layer: server (``server.py``, ``reader.merge_parts``).  The benchmark's
host clock around each ``merge_parts`` call of the window (span
``merge_parts``), over the frames merged; ms a frame."""


def read(run):
    frames = run.frames_done()
    return sum(run.spans["merge_parts"]) / frames * 1e3 if frames else None
