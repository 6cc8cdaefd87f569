"""Layer: kernels, rANS decode (``ops/hopper_rans``, ``hopper_decode``;
``csrc/rans_decode.cu``, ``csrc/posdecode.cu``): the scheme-12 gap chain of
``read_frames_dense``.  The least time of the window's calls over the
device time of the chain's kernels in the trace.  Bytes: each frame's two
coded streams (their sizes in the container's table) read once, its dense
uint16 frame written once."""

from portbench.plain_reader import PlainContainer
from portbench.roofline import share_pct

OPS = ("rans_decode_kernel", "posdecode_kernel")


def read(run):
    path = run.tmp / "container" / f"acq.rc{run.level}"
    if not path.exists():
        return None
    meta = PlainContainer(path).meta
    moved = sum(meta[z][0] + meta[z][1] + 2 * run.height * run.width
                for s in run.done() for z in range(s["start"], s["start"] + s["frames"]))
    return share_pct(run, OPS, moved)
