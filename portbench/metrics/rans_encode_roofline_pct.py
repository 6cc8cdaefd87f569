"""Layer: kernels, rANS encode (``ops/hopper_rans``; ``csrc/rans_hist.cu``,
``csrc/rans_encode.cu``).  The least time of the window's scheme-12
histograms and interleaved encodes over the device time of their
operations in the trace.  Bytes, from the header of every stream of every
acquisition the window wrote that the card coded (1024 or 8192 lanes, not
stored): its m symbols (the bitmap's gaps, or the 12-bit values) read once,
as the 4-byte integers the kernels take, and its body written once."""

from pathlib import Path

from portbench.plain_reader import PlainContainer
from portbench.roofline import share_pct

OPS = ("rans_hist_kernel", "rans_chain_kernel", "rans_place_kernel")
KERNEL_LANES = (1024, 8192)


def coded_bytes(stream: bytes) -> int:
    """Symbols in and body out of one scheme-12 stream the card coded, else 0."""
    if len(stream) < 20 or stream[3] & 1 or (1 << stream[2]) not in KERNEL_LANES:
        return 0
    m = int.from_bytes(stream[8:12], "little")
    return 4 * m + int.from_bytes(stream[12:16], "little")


def read(run):
    moved = 0
    for step in run.done():
        container = PlainContainer(step["merged"])
        raw = Path(step["merged"]).read_bytes()
        for at, meta in zip(container.offsets, container.meta):
            moved += coded_bytes(raw[at:at + meta[0]])
            moved += coded_bytes(raw[at + meta[0]:at + meta[0] + meta[1]])
    return share_pct(run, OPS, moved) if moved else None
