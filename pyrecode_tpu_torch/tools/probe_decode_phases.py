"""Phase cost split of the L1 decode on the card (kernel P2).

Port of tools/probe_decode_phases.py.  The TPU probe built truncated copies
of its Pallas decode kernel that stop after each internal phase (bitmap /
cumsum / offsets / fetch / level2 / full).  The port's phases are the
passes of its own kernel, ``csrc/decode_l1.cu``, cut after each
(``hopper_decode.decode_l1_phases``):

    store : the expand pass storing the bitmap's 0/1 mask (the HBM floor; TPU bitmap)
    count : pass 1: set bits a tile                  (TPU cumsum)
    scan  : + the expand pass's offsets step: tile offsets, counts,
            overflow (TPU offsets; the decode has no scan pass of its own)
    full  : + the expand: every pixel stored, each foreground pixel's value
            gathered by its rank: the production decode_l1 (TPU fetch, level2, full)

``store`` is the floor and not a prefix of ``count``: the delta printed for
``count`` is against it, as the TPU probe's ``cumsum`` delta is against its
``bitmap`` floor.  Each line: the phase's ms a batch (CUDA events), GB/s of
raw frames, the delta, and the phase's bound: the bytes it must move
(inputs read once, outputs written once) at 3.35 TB/s.  Each phase is held
against its plain twin, and ``full`` against ``decode_l1`` and the frames.

Usage: python -m pyrecode_tpu_torch.tools.probe_decode_phases [--size 4096]
       [--batch 4] [--occupancy 0.01] [--reps 20] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import hopper_decode, hopper_encode
from ..ops.encode import count_foreground
from ..writer import _bucket_for
from . import _common

PHASES = hopper_decode.PHASES
TPU_PHASES = {"store": "bitmap", "count": "cumsum", "scan": "offsets",
              "full": "fetch, level2, full"}


def run(device="cuda", size: int = 4096, batch: int = 4, occupancy: float = 0.01,
        reps: int = 20) -> dict:
    """The phase split of decoding ``batch`` frames of ``size``^2 at
    ``occupancy`` (bitmaps and values from the production encode).  Returns
    {"lines", "rows": [{phase, ms, gbps, delta_ms, bound_ms, bytes,
    max_abs_err}]}; ms and the rates are None on the CPU.  Raises if a phase
    disagrees with its twin, or ``full`` with ``decode_l1`` or the frames."""
    dev = _common.device_of(device)
    frames_np, thr_np = _common.sparse_batch(batch, size, occupancy)
    frames, thr = torch.from_numpy(frames_np).to(dev), torch.from_numpy(thr_np).to(dev)
    out_size = _bucket_for(int(count_foreground(frames, thr).max()), size * size)
    bitmap, values, _, overflow = hopper_encode.encode_l1(frames, thr, out_size)
    if bool(overflow.any()):
        raise AssertionError("encode overflow although the buffer holds the largest count")
    raw = frames.numel() * 2
    lines = [f"decode phase split: {batch}x{size}^2, occupancy {occupancy}, value buffer "
             f"{out_size}, on {dev}",
             "port phase -> TPU phases: " + ", ".join(f"{p} -> {TPU_PHASES[p]}" for p in PHASES)]
    rows, prev = [], None
    for phase in PHASES:
        got = hopper_decode.decode_l1_phases(bitmap, values, size, size, phase)
        err = _common.max_abs_err(got, hopper_decode.decode_l1_phases_plain(
            bitmap, values, size, size, phase))
        if phase == "full":
            err = max(err, _common.max_abs_err(got, hopper_decode.decode_l1(bitmap, values,
                                                                            size, size)))
            if not np.array_equal(got[0].cpu().numpy(), np.where(frames_np > thr_np,
                                                                 frames_np - thr_np, 0)):
                raise AssertionError("the decode of the encode differs from the frames")
        if err:
            raise AssertionError(f"decode phase {phase!r} differs from its twin by {err}")
        ms = _common.device_ms(lambda p=phase: hopper_decode.decode_l1_phases(
            bitmap, values, size, size, p), dev, reps)
        inputs = (bitmap,) if phase != "full" else (bitmap, values)
        n_bytes = _common.nbytes(*inputs, *got)
        row = {"phase": phase, "ms": ms, "gbps": None if ms is None else raw / ms / 1e6,
               "delta_ms": None if ms is None or prev is None else ms - prev,
               "bound_ms": _common.bound_ms(n_bytes), "bytes": n_bytes, "max_abs_err": err}
        rows.append(row)
        prev = ms
        rate = "" if ms is None else f" {row['gbps']:7.2f} GB/s"
        delta = "" if row["delta_ms"] is None else f"  ({row['delta_ms']:+.4f} ms)"
        lines.append(f"{phase:6s} {_common.fmt_ms(ms)}/batch{rate}{delta}  bound "
                     f"{row['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} MB at 3.35 TB/s); "
                     "equal to its twin" + (", to decode_l1 and to the frames"
                                            if phase == "full" else ""))
    return {"lines": lines, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Phase split of the L1 decode on the card.  The TPU probe's --bucket is "
                    "gone: the port's decode has one value capacity and no buckets.")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--occupancy", type=float, default=0.01)
    ap.add_argument("--reps", type=int, default=20, help="launches timed between two events")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain twins")
    args = ap.parse_args(argv)
    print("\n".join(run(args.device, args.size, args.batch, args.occupancy, args.reps)["lines"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
