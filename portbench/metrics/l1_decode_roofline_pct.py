"""Layer: kernels, decode (``ops/hopper_decode``, ``hopper_bitpack``;
``csrc/decode_l1.cu``, ``bitpack12.cu``).  The least time of the window's
12-bit unpack and L1 decode over the device time of their operations in
the trace.  Bytes: each frame's bitmap and packed values read once, its
dense uint16 frame written once."""

from portbench.roofline import bitmap_bytes, packed_bytes, share_pct

OPS = ("bitunpack12_kernel", "decode_count_kernel", "decode_expand_kernel")


def read(run):
    n = run.height * run.width
    moved = sum(bitmap_bytes(n) + packed_bytes(run.fg_counts[z], run.bit_depth) + 2 * n
                for s in run.done() for z in range(s["start"], s["start"] + s["frames"]))
    return share_pct(run, OPS, moved)
