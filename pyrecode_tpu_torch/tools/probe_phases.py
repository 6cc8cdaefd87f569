"""Phase cost split of the fused L1 encode on the card (kernel P1).

Port of tools/probe_phases.py.  The TPU probe built truncated copies of its
Pallas kernel that stop after each of the TPU kernel's internal phases
(load / bitmap / cumsum / select / offsets / concat / full).  The port's
phases are the passes of its own kernel, ``csrc/encode_l1.cu``, launched
unchanged and cut after each (``hopper_encode.encode_l1_phases``):

    load   : frame and threshold read once, summed a tile   (the HBM floor)
    bitmap : the dense pass: bitmap bytes, tile counts      (TPU bitmap)
    scan   : + the placing kernel's offsets, counts, overflow (TPU cumsum, offsets)
    full   : + staged values placed, zeros: encode_l1       (TPU select, concat, full)

Each line: the phase's ms a batch (CUDA events), GB/s of raw frames, the
delta against the phase before it, and the phase's bound: the bytes it must
move (inputs read once, outputs written once) at 3.35 TB/s.  Each phase is
also held against its plain twin, and ``full`` against ``encode_l1``.

Usage: python -m pyrecode_tpu_torch.tools.probe_phases [--size 4096]
       [--batch 4] [--occupancy 0.01] [--phases load bitmap scan full]
       [--reps 20] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _launch, hopper_encode
from ..ops.encode import count_foreground
from ..writer import _bucket_for
from . import _common

PHASES = hopper_encode.PHASES
# the TPU kernel's phases that each of the port's passes stands for
TPU_PHASES = {"load": "load", "bitmap": "bitmap", "scan": "cumsum, offsets",
              "full": "select, concat, full"}


def run(device="cuda", size: int = 4096, batch: int = 4, occupancy: float = 0.01,
        phases=PHASES, reps: int = 20) -> dict:
    """The phase split on ``batch`` frames of ``size``^2 at ``occupancy``.
    Returns {"lines": what main prints, "rows": [{phase, ms, gbps, delta_ms,
    bound_ms, bytes, max_abs_err}], "out_size": the value buffer}; ms and
    the rates are None on the CPU.  Raises if a phase disagrees with its
    twin or ``full`` with ``encode_l1``."""
    dev = _common.device_of(device)
    frames_np, thr_np = _common.sparse_batch(batch, size, occupancy)
    frames, thr = torch.from_numpy(frames_np).to(dev), torch.from_numpy(thr_np).to(dev)
    out_size = _bucket_for(int(count_foreground(frames, thr).max()), size * size)
    raw = frames.numel() * 2
    lines = [f"encode phase split: {batch}x{size}^2, occupancy {occupancy}, value buffer "
             f"{out_size}, {-(-size * size // _launch.TILE_PIXELS)} tiles a frame, on {dev}",
             "port phase -> TPU phases: " + ", ".join(f"{p} -> {TPU_PHASES[p]}" for p in PHASES)]
    rows, prev = [], None
    for phase in phases:
        got = hopper_encode.encode_l1_phases(frames, thr, out_size, True, phase)
        err = _common.max_abs_err(got, hopper_encode.encode_l1_phases_plain(
            frames, thr, out_size, True, phase))
        if phase == "full":
            err = max(err, _common.max_abs_err(got, hopper_encode.encode_l1(frames, thr, out_size)))
        if err:
            raise AssertionError(f"encode phase {phase!r} differs from its twin by {err}")
        ms = _common.device_ms(lambda p=phase: hopper_encode.encode_l1_phases(
            frames, thr, out_size, True, p), dev, reps)
        n_bytes = _common.nbytes(frames, thr, *got)
        row = {"phase": phase, "ms": ms, "gbps": None if ms is None else raw / ms / 1e6,
               "delta_ms": None if ms is None or prev is None else ms - prev,
               "bound_ms": _common.bound_ms(n_bytes), "bytes": n_bytes, "max_abs_err": err}
        rows.append(row)
        prev = ms
        rate = "" if ms is None else f" {row['gbps']:7.2f} GB/s"
        delta = "" if row["delta_ms"] is None else f"  ({row['delta_ms']:+.4f} ms)"
        lines.append(f"{phase:7s} {_common.fmt_ms(ms)}/batch{rate}{delta}  bound "
                     f"{row['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} MB at 3.35 TB/s); "
                     "equal to its twin" + (" and to encode_l1" if phase == "full" else ""))
    return {"lines": lines, "rows": rows, "out_size": out_size}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Phase split of the fused L1 encode on the card.  The TPU probe's "
                    "--bucket is gone: the port's encode has one value capacity and no "
                    "buckets; its --scan pool is --reps launches between CUDA events.")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--occupancy", type=float, default=0.01)
    ap.add_argument("--phases", nargs="*", default=list(PHASES), choices=PHASES)
    ap.add_argument("--reps", type=int, default=20, help="launches timed between two events")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain twins")
    args = ap.parse_args(argv)
    print("\n".join(run(args.device, args.size, args.batch, args.occupancy, args.phases,
                        args.reps)["lines"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
