"""Probe: are the four butterfly left-pack formulations exact on the card?
(kernel P5)

Port of tools/probe_butterfly.py.  There, a log-shift stable compaction
(monotone distances, LSB-first power-of-two conditional moves: provably
collision-free, exact in numpy and in interpret mode) diverged on a real
v5e at >= 25% foreground density, and the probe ran four formulations of
the same routing against the stable-compaction oracle so that the hardware
could localize Mosaic's miscompile.  Here the same four formulations run
as ``csrc/probe_butterfly.cu``: a warp a row, the row in registers, each
formulation alone (``hopper_probes.butterfly``) and the four in one launch
(``hopper_probes.butterfly_all``, what the JAX probe's main() runs).  All
four are expected to equal the oracle at every density, both ways; a
mismatch is a kernel bug, not a finding about the card.

Prints, per SUB and variant, OK or FAIL dens=...(cells), as the JAX probe
does, with the variant's own time on the card, and per SUB the time of the
four in one butterfly_all call.

Usage: python -m pyrecode_tpu_torch.tools.probe_butterfly [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import hopper_probes
from . import _common

S = 8                               # rows
SUBS = (512, 2048)                  # lanes a row
DENSITIES = (0.1, 0.25, 0.6, 0.95)


def make_cases(rng, sub: int) -> list:
    """(density, mask (S, sub) int32, values (S, sub) int32) per density,
    drawn as the JAX probe draws them."""
    cases = []
    for dens in DENSITIES:
        m = (rng.random((S, sub)) < dens).astype(np.int32)
        v = rng.integers(1, 513, (S, sub)).astype(np.int32) * m
        cases.append((dens, m, v))
    return cases


def oracle(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The stable compaction: each row's foreground values at its front."""
    want = np.zeros_like(v)
    for r in range(m.shape[0]):
        fgv = v[r][m[r].astype(bool)]
        want[r, :fgv.size] = fgv
    return want


def run(device="cuda", reps: int = 20) -> dict:
    """Every variant at SUB 512 and 2048 on the four densities of
    ``default_rng(1)``, alone and through butterfly_all, each result also
    held against the twin.  Returns {"lines", "status": {(sub, variant):
    "OK" or "FAIL ..."}, "ms": {(sub, variant): ms of one butterfly call at
    density 0.95, or None}, "all_ms": {sub: ms of one butterfly_all call
    there, or None}, "timed": {sub: the (mask, values) timed},
    "max_abs_err": the largest difference from the twin}."""
    dev = _common.device_of(device)
    rng = np.random.default_rng(1)
    lines, status, times, all_ms, timed = [f"butterfly left-pack, S={S}, on {dev}"], {}, {}, {}, {}
    worst = 0
    for sub in SUBS:
        cases = [(d, torch.from_numpy(m).to(dev), torch.from_numpy(v).to(dev), oracle(m, v))
                 for d, m, v in make_cases(rng, sub)]
        together = [hopper_probes.butterfly_all(m, v) for _, m, v, _ in cases]
        for name in hopper_probes.BUTTERFLY_VARIANTS:
            bad = []
            for (dens, m, v, want), four in zip(cases, together):
                twin = hopper_probes.butterfly_plain(m, v, name)
                for how, got in (("", hopper_probes.butterfly(m, v, name)),
                                 ("all ", four[name])):
                    err = _common.max_abs_err([got], [twin])
                    if err:
                        bad.append(f"dens={dens}({how}twin)")
                    worst = max(worst, err)
                    cells = int((got.cpu().numpy() != want).sum())
                    if cells:
                        bad.append(f"dens={dens}({how}{cells})")
            _, m, v, _ = cases[-1]
            timed[sub] = m, v
            times[sub, name] = _common.device_ms(lambda: hopper_probes.butterfly(m, v, name),
                                                 dev, reps)
            status[sub, name] = "OK" if not bad else "FAIL " + ", ".join(bad)
            lines.append(f"SUB={sub} {name}: {status[sub, name]} "
                         f"({_common.fmt_ms(times[sub, name])} at density {DENSITIES[-1]})")
        m, v = timed[sub]
        all_ms[sub] = _common.device_ms(lambda: hopper_probes.butterfly_all(m, v), dev, reps)
        lines.append(f"SUB={sub} the four in one launch (butterfly_all): "
                     f"{_common.fmt_ms(all_ms[sub])} at density {DENSITIES[-1]}")
    return {"lines": lines, "status": status, "ms": times, "all_ms": all_ms, "timed": timed,
            "max_abs_err": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain twin")
    args = ap.parse_args(argv)
    result = run(args.device)
    print("\n".join(result["lines"]))
    return 0 if all(s == "OK" for s in result["status"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
