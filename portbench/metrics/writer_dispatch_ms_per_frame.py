"""Layer: writer (``writer.py``).  The writer's run metric
``frame_thresholding_and_counting_time``, which times all of
``_dispatch_encode`` (the H2D copy, ``count_foreground``, the host wait on
its maximum and the launch), summed over the nodes and acquisitions of the
window, over the frames written; ms a frame.  Nodes overlap, so this is
not wall time."""


def read(run):
    frames = run.frames_done()
    if not frames:
        return None
    seconds = sum(m["frame_thresholding_and_counting_time"].total_seconds()
                  for step in run.done() for m in step["run_metrics"])
    return seconds / frames * 1e3
