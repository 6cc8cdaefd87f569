"""The TPU lowering probes of tools/probe_mosaic.py on the card (kernel P3).

There, each probe compiled a tiny Pallas kernel that exercised one feature
the deflate kernels wanted and asked whether Mosaic could lower it:

    (a) an NT dot_general contracting the lanes of both operands;
    (b) an in-kernel 2-D transpose;
    (c) i32 % and // by a constant on vectors;
    (d) a lane -> sublane reshape merge (4,512) -> (1,2048);
    (e) a strided sublane slice x[0::2];
    (f) pltpu.roll along sublanes by a shift traced from SMEM;
    (g) scalar SMEM arithmetic with % on a reduced sum;
    (h) i32 shifts by per-element amounts.

On the card every construct is ordinary CUDA (``csrc/probe_mosaic.cu``,
``hopper_probes.mosaic``: an FMA loop, a shared-memory tile, floored integer
division, index arithmetic, a block reduction, per-thread shifts), so the
question here is only whether each result is exact.  Each is checked
against numpy (the JAX probe left (h) unchecked; here it is checked) and
against its plain twin.  Prints OK or FAIL per probe, as the
JAX probe does.

Usage: python -m pyrecode_tpu_torch.tools.probe_mosaic [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import hopper_probes
from . import _common


def cases() -> dict:
    """letter -> (numpy inputs, numpy expected outputs), the JAX probe's."""
    a32 = np.arange(32 * 128, dtype=np.float32).reshape(32, 128)
    c = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 37
    d = np.arange(4 * 512, dtype=np.int32).reshape(4, 512)
    e = np.arange(16 * 128, dtype=np.int32).reshape(16, 128)
    f = np.arange(32 * 128, dtype=np.int32).reshape(32, 128)
    g = np.full((8, 128), 1234, np.int32)
    h = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    return {
        "a": ((np.ones((8, 128), np.float32), np.ones((32, 128), np.float32)),
              (np.full((8, 32), 128, np.float32),)),
        "b": ((a32,), (a32.T.copy(),)),
        "c": ((c,), (c % 258, c // 258)),
        "d": ((d,), (d.reshape(1, 2048),)),
        "e": ((e,), (e[0::2].copy(),)),
        "f": ((f, np.array([3], np.int32)), (np.roll(f, 3, axis=0),)),
        "g": ((g,), (np.array([[(1234 * 8 * 128) % 65521]], np.int32),)),
        "h": ((h, h), ((h << (h & 7)) | (h >> (8 - (h & 7))),)),
    }


def run(device="cuda", reps: int = 20) -> dict:
    """The eight probes.  Returns {"lines", "status": {letter: "OK" or "FAIL
    ..."}, "ms": {letter: ms or None}, "all_ms": the eight launches' ms
    together or None, "bytes": what the eight move, "max_abs_err": the
    largest difference of a probe from its twin}."""
    dev = _common.device_of(device)
    lines, status, times, n_bytes, worst = [f"lowering probes, on {dev}"], {}, {}, 0, 0
    inputs = {}
    for letter, (ins, want) in cases().items():
        label = hopper_probes.MOSAIC_PROBES[letter][0]
        ts = [torch.from_numpy(x).to(dev) for x in ins]
        inputs[letter] = ts
        got = hopper_probes.mosaic(letter, *ts)
        n_bytes += _common.nbytes(*ts, *got)
        bad = [f"output {i} differs from numpy" for i, (g, w) in enumerate(zip(got, want))
               if not np.array_equal(g.cpu().numpy(), w)]
        err = _common.max_abs_err(got, hopper_probes.mosaic_plain(letter, *ts))
        if err:
            bad.append("differs from its twin")
        worst = max(worst, err)
        times[letter] = _common.device_ms(lambda: hopper_probes.mosaic(letter, *ts), dev, reps)
        status[letter] = "OK" if not bad else "FAIL " + "; ".join(bad)
        lines.append(f"({letter}) {label}: {status[letter]} {[tuple(g.shape) for g in got]} "
                     f"({_common.fmt_ms(times[letter])})")

    def all_eight():
        for letter, ts in inputs.items():
            hopper_probes.mosaic(letter, *ts)

    all_ms = _common.device_ms(all_eight, dev, reps)
    lines.append(f"the eight launches together: {_common.fmt_ms(all_ms)}")
    return {"lines": lines, "status": status, "ms": times, "all_ms": all_ms, "bytes": n_bytes,
            "max_abs_err": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Lowering probes of the TPU port, on the card")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain twins")
    args = ap.parse_args(argv)
    result = run(args.device)
    print("\n".join(result["lines"]))
    return 0 if all(s == "OK" for s in result["status"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
