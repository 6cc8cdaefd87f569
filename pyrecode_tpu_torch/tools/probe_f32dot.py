"""Probe: is an f32 product exact for 21-bit integer values on the card?
(kernel P4)

Port of tools/probe_f32dot.py.  There the question was whether an f32
``dot_general`` inside a Pallas kernel honours ``precision=HIGH /
HIGHEST``: the deflate assembler wanted one full-value f32 one-hot matmul
for its three bf16 byte-plane matmuls, sound only if Mosaic runs >= 3 bf16
passes (24 mantissa bits, enough below 2**21).  On the card the three
precisions map to its three ways of running an f32 product, each in the
kernel's own body (``csrc/probe_f32dot.cu``, ``hopper_probes.f32dot``):

    default -> tf32   : one TF32 tensor-core pass (mma.sync), 11 significant bits;
    high    -> 3xtf32 : big/small TF32 split, three passes;
    highest -> fp32   : an FMA loop, no tensor core.

It is the card's evidence for the precision lesson: integer-exact work
never runs through a matmul that rounds.  Prints, per precision,
``compiled, exact=..., maxerr=...`` against ``lut[:, idx]`` on the JAX
probe's inputs, whether the kernel equals its twin bit for bit, its time,
and the time of ``torch.matmul`` in fp32 on the same inputs (a yardstick the
port never calls).

Usage: python -m pyrecode_tpu_torch.tools.probe_f32dot [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import hopper_probes
from . import _common

MODES = {"default": "tf32", "high": "3xtf32", "highest": "fp32"}   # JAX precision -> mode


def make_inputs(m: int = 48, k: int = 32, n: int = 2048, seed: int = 0):
    """(lut (m, k) f32 of integers below 2**21, oh (n, k) f32 one-hot rows,
    want = lut[:, idx]); the defaults are the JAX probe's inputs, built as it
    builds them."""
    rng = np.random.default_rng(seed)
    lut = rng.integers(0, 1 << 21, size=(m, k)).astype(np.float32)
    idx = rng.integers(0, k, size=n).astype(np.int32)
    oh = (idx[:, None] == np.arange(k)[None, :]).astype(np.float32)
    return lut, oh, lut[:, idx]


def run(device="cuda", reps: int = 20) -> dict:
    """The three modes on the probe's inputs.  Returns {"lines", "modes":
    {mode: {exact, maxerr, twin_equal, twin_err, ms}}, "library_ms"}, where
    twin_err is the largest |kernel - twin|; times are None on the CPU."""
    dev = _common.device_of(device)
    lut_np, oh_np, want = make_inputs()
    lut, oh = torch.from_numpy(lut_np).to(dev), torch.from_numpy(oh_np).to(dev)
    lines, modes = [f"f32 dot (48,32).(2048,32)^T of 21-bit integers, on {dev}"], {}
    for precision, mode in MODES.items():
        got = hopper_probes.f32dot(lut, oh, mode)
        twin = hopper_probes.f32dot_plain(lut, oh, mode)
        host = got.cpu().numpy()
        r = {"exact": bool(np.array_equal(host, want)),
             "maxerr": float(np.abs(host - want).max()),
             "twin_equal": torch.equal(got.view(torch.int32), twin.view(torch.int32)),
             "twin_err": float((got - twin).abs().max()),
             "ms": _common.device_ms(lambda m=mode: hopper_probes.f32dot(lut, oh, m), dev, reps)}
        modes[mode] = r
        lines.append(f"precision={precision} ({mode}): compiled, exact={r['exact']}, "
                     f"maxerr={r['maxerr']}; twin {'equal' if r['twin_equal'] else 'DIFFERS'} "
                     f"bit for bit; {_common.fmt_ms(r['ms'])}")
    with _common.full_fp32():
        library_ms = _common.device_ms(lambda: lut @ oh.T, dev, reps)
    lines.append(f"torch.matmul fp32 (allow_tf32=False), not used by the port: "
                 f"{_common.fmt_ms(library_ms)}")
    return {"lines": lines, "modes": modes, "library_ms": library_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain twins")
    args = ap.parse_args(argv)
    result = run(args.device)
    print("\n".join(result["lines"]))
    return 0 if all(r["twin_equal"] for r in result["modes"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
