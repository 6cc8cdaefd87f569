"""Layer: kernels, labelling (``ops/hopper_label``; ``csrc/label_l2l4.cu``).
The least time of the window's L4 label encode over the device time of its
operations in the trace.  Bytes: each frame read once and the threshold
once a launch; each frame's centroid bitmap written once."""

from portbench.roofline import bitmap_bytes, share_pct

OPS = ("label_mask_kernel", "label_link_kernel", "label_rank_kernel",
       "label_accumulate_kernel", "label_finalize_kernel")


def read(run):
    n = run.height * run.width
    moved = (run.frames_done() * (2 * n + bitmap_bytes(n))
             + run.launches.get("label_l2l4", 0) * 2 * n)
    return share_pct(run, OPS, moved)
