"""Layer: kernels, reduction (``ops/hopper_encode``, ``hopper_bitpack``;
``csrc/encode_l1.cu``, ``bitpack12.cu``).  The least time of the window's
L1 encode and 12-bit pack over the device time of their operations in the
trace.  Bytes: each frame read once and the threshold once a launch; each
frame's bitmap and packed values written once."""

from portbench.roofline import bitmap_bytes, packed_bytes, share_pct

OPS = ("encode_tile_kernel", "encode_place_kernel", "bitpack12_kernel")


def read(run):
    n = run.height * run.width
    moved = sum(2 * n + bitmap_bytes(n) + packed_bytes(run.fg_counts[z], run.bit_depth)
                for s in run.done() for z in range(s["offset"], s["offset"] + s["frames"]))
    moved += run.launches.get("encode_l1", 0) * 2 * n
    return share_pct(run, OPS, moved)
