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
against its plain twin, alone (``mosaic``) and with the other seven in one
launch (``mosaic_all``, what the JAX probe's main() runs).  Prints OK or
FAIL per probe, as the JAX probe does, with its time and, where one PyTorch
call computes the same (a yardstick the port never calls), that call's.

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


def library_calls(inputs: dict) -> dict:
    """letter -> one PyTorch call that computes what the probe computes, on
    ``inputs`` (as for ``hopper_probes.mosaic_all``), or None where none
    does: (a) ``a @ b.T`` in float32 (TF32 off), (b) ``a.T.contiguous()``,
    (d) ``a.reshape(1, 2048).clone()``, (e) ``a[0::2].contiguous()``, (f)
    ``torch.roll`` by the shift read once on the host (the kernel reads it
    on the device)."""
    a = {k: ts[0] for k, ts in inputs.items()}
    shift = int(inputs["f"][1][0])

    def nt_dot():
        with _common.full_fp32():
            return a["a"] @ inputs["a"][1].T

    return {"a": nt_dot, "b": lambda: a["b"].T.contiguous(), "c": None,
            "d": lambda: a["d"].reshape(1, 2048).clone(), "e": lambda: a["e"][0::2].contiguous(),
            "f": lambda: torch.roll(a["f"], shift, 0), "g": None, "h": None}


def run(device="cuda", reps: int = 20) -> dict:
    """The eight probes, each alone and all eight in one launch.  Returns
    {"lines", "status": {letter: "OK" or "FAIL ..."}, "ms": {letter: ms or
    None}, "library_ms": {letter: ms of library_calls' call, or None},
    "all_ms": ms of the eight in one mosaic_all call or None, "bytes": what
    the eight move, "max_abs_err": the largest difference of a probe, alone
    or in mosaic_all, from its twin}."""
    dev = _common.device_of(device)
    lines, status, times, n_bytes, worst = [f"lowering probes, on {dev}"], {}, {}, 0, 0
    expected = {letter: want for letter, (_, want) in cases().items()}
    inputs = {letter: [torch.from_numpy(x).to(dev) for x in ins]
              for letter, (ins, _) in cases().items()}
    together = hopper_probes.mosaic_all(inputs)
    library = library_calls(inputs)
    library_ms = {}
    for letter, ts in inputs.items():
        label = hopper_probes.MOSAIC_PROBES[letter][0]
        got = hopper_probes.mosaic(letter, *ts)
        n_bytes += _common.nbytes(*ts, *got)
        bad = [f"{how} output {i} differs from numpy"
               for how, outs in (("its", got), ("mosaic_all's", together[letter]))
               for i, (g, w) in enumerate(zip(outs, expected[letter]))
               if not np.array_equal(g.cpu().numpy(), w)]
        twin = hopper_probes.mosaic_plain(letter, *ts)
        err = max(_common.max_abs_err(got, twin), _common.max_abs_err(together[letter], twin))
        if err:
            bad.append("differs from its twin")
        worst = max(worst, err)
        times[letter] = _common.device_ms(lambda: hopper_probes.mosaic(letter, *ts), dev, reps)
        library_ms[letter] = (_common.device_ms(library[letter], dev, reps)
                              if library[letter] is not None else None)
        status[letter] = "OK" if not bad else "FAIL " + "; ".join(bad)
        yardstick = ("no one library call" if library[letter] is None
                     else f"one library call {_common.fmt_ms(library_ms[letter])}")
        lines.append(f"({letter}) {label}: {status[letter]} {[tuple(g.shape) for g in got]} "
                     f"({_common.fmt_ms(times[letter])}; {yardstick})")

    all_ms = _common.device_ms(lambda: hopper_probes.mosaic_all(inputs), dev, reps)
    lines.append(f"the eight in one launch (mosaic_all): {_common.fmt_ms(all_ms)}")
    return {"lines": lines, "status": status, "ms": times, "library_ms": library_ms,
            "all_ms": all_ms, "bytes": n_bytes, "max_abs_err": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Lowering probes of the TPU port, on the card")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain twins")
    args = ap.parse_args(argv)
    result = run(args.device)
    print("\n".join(result["lines"]))
    return 0 if all(s == "OK" for s in result["status"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
