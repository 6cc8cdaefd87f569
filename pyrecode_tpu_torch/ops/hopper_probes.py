"""The hardware probes' kernels (``csrc/probe_*.cu``) and their twins.

Kernels P3-P5 of the port, the counterparts of the TPU probes in
``tools/`` that reach ``pl.pallas_call`` themselves; the developer tools in
:mod:`pyrecode_tpu_torch.tools` drive them.

* :func:`butterfly` and :func:`butterfly_all` (P5, ``csrc/probe_butterfly.cu``;
  replaces the kernel of tools/probe_butterfly.py:127): the LSB-first
  log-shift left-pack of each row's foreground values, in one of the JAX
  probe's four formulations (:data:`BUTTERFLY_VARIANTS`) or all four in one
  launch, a block a (formulation, row);
* :func:`f32dot` (P4, ``csrc/probe_f32dot.cu``; replaces
  tools/probe_f32dot.py:build): lut . oh^T in float32 on the tensor cores
  in one TF32 pass or in 3xTF32, or by FMA (:data:`F32DOT_MODES`);
* :func:`mosaic` and :func:`mosaic_all` (P3, ``csrc/probe_mosaic.cu``;
  replaces the kernels of tools/probe_mosaic.py:20,95,114): the eight
  lowering probes (a)-(h) at their fixed shapes (:data:`MOSAIC_PROBES`), one
  probe or all eight in one launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _launch

BUTTERFLY_LAUNCHES = _launch.LaunchCounter()
F32DOT_LAUNCHES = _launch.LaunchCounter()
MOSAIC_LAUNCHES = _launch.LaunchCounter()

# the JAX probe's names, in the kernel's variant order
BUTTERFLY_VARIANTS = ("packed_add (reverted)", "packed_or", "two_array", "select_merge")
# the card's three ways of running an f32 product, for the JAX precisions
# DEFAULT, HIGH and HIGHEST
F32DOT_MODES = ("tf32", "3xtf32", "fp32")

_I32, _F32 = torch.int32, torch.float32
# letter -> (the JAX probe's label, input (shape, dtype)s, output (shape, dtype)s)
MOSAIC_PROBES = {
    "a": ("NT dot (8,128)x(32,128)->(8,32)", [((8, 128), _F32), ((32, 128), _F32)],
          [((8, 32), _F32)]),
    "b": ("transpose (32,128)->(128,32)", [((32, 128), _F32)], [((128, 32), _F32)]),
    "c": ("i32 % and // by 258", [((8, 128), _I32)], [((8, 128), _I32), ((8, 128), _I32)]),
    "d": ("reshape (4,512)->(1,2048)", [((4, 512), _I32)], [((1, 2048), _I32)]),
    "e": ("sublane stride-2 slice", [((16, 128), _I32)], [((8, 128), _I32)]),
    "f": ("roll axis=0 by a runtime shift", [((32, 128), _I32), ((1,), _I32)],
          [((32, 128), _I32)]),
    "g": ("scalar sum % 65521", [((8, 128), _I32)], [((1, 1), _I32)]),
    "h": ("vector-amount shifts", [((8, 128), _I32), ((8, 128), _I32)], [((8, 128), _I32)]),
}


def _check_rows(mask: torch.Tensor, vals: torch.Tensor) -> None:
    _launch.require(mask, "mask", torch.int32, 2)
    _launch.require(vals, "vals", torch.int32, 2)
    if mask.shape != vals.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and vals {tuple(vals.shape)} differ")
    rows, sub = mask.shape
    if rows < 1:
        raise ValueError("mask and vals must hold at least one row")
    if sub < 32 or sub > 2048 or sub & (sub - 1):
        raise ValueError(f"rows must hold a power of two of 32..2048 lanes, got {sub}")


def butterfly_plain(mask: torch.Tensor, vals: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`butterfly` (``torch.roll`` for
    ``pltpu.roll``), on any device."""
    _check_rows(mask, vals)
    sub = mask.shape[1]
    fg = mask > 0
    rank1 = torch.cumsum(fg.to(torch.int32), dim=1, dtype=torch.int32) - 1
    lane = torch.arange(sub, dtype=torch.int32, device=mask.device).expand_as(mask)
    dist = torch.where(fg, lane - rank1, 0)
    zero = torch.zeros_like(vals)
    if variant == "two_array":
        carry = torch.where(fg, vals, 0)
    else:
        carry = torch.where(fg, (dist << 16) | (vals & 0xFFFF), 0)
    k = 1
    while k < sub:
        if variant == "two_array":
            moving = (dist & k) > 0
            vmv = torch.where(moving, carry, zero)
            dmv = torch.where(moving, dist - k, zero)
            carry = torch.where(moving, zero, carry) + torch.roll(vmv, sub - k, 1)
            dist = torch.where(moving, zero, dist) + torch.roll(dmv, sub - k, 1)
        else:
            moving = ((carry >> 16) & k) > 0
            inc = torch.roll(torch.where(moving, carry - (k << 16), zero), sub - k, 1)
            stay = torch.where(moving, zero, carry)
            if variant == "packed_add (reverted)":
                carry = stay + inc
            elif variant == "packed_or":
                carry = stay | inc
            else:
                carry = torch.where(inc != 0, inc, stay)
        k *= 2
    return carry & 0xFFFF


def _launch_butterfly(mask: torch.Tensor, vals: torch.Tensor, out: torch.Tensor, first: int,
                      count: int) -> None:
    """One launch of formulations first .. first + count - 1 on every row
    into ``out`` ((count, S, SUB) int32 words)."""
    rows, sub = mask.shape
    _launch.launch(BUTTERFLY_LAUNCHES, "pr_probe_butterfly", mask.device, _launch.ptr(mask),
                   _launch.ptr(vals), _launch.ptr(out), first, count, rows, sub)


def butterfly(mask: torch.Tensor, vals: torch.Tensor, variant: str) -> torch.Tensor:
    """mask, vals (S, SUB) int32 -> (S, SUB) int32: each row's values at its
    foreground lanes (mask > 0) packed to the row's front in lane order,
    zeros behind, each ``& 0xFFFF``, by the formulation ``variant`` (one of
    BUTTERFLY_VARIANTS).  S >= 1; SUB a power of two in 32..2048; values
    below 2**16 (the packed variants carry the distance in the high half)."""
    if variant not in BUTTERFLY_VARIANTS:
        raise ValueError(f"variant must be one of {BUTTERFLY_VARIANTS}, got {variant!r}")
    _check_rows(mask, vals)
    if _launch.on_host(mask, vals):
        return butterfly_plain(mask, vals, variant)
    out = torch.empty_like(vals)
    _launch_butterfly(mask, vals, out, BUTTERFLY_VARIANTS.index(variant), 1)
    return out


def butterfly_all_plain(mask: torch.Tensor, vals: torch.Tensor) -> dict:
    """Plain PyTorch version of :func:`butterfly_all`, on any device: each
    variant's :func:`butterfly_plain`."""
    return {name: butterfly_plain(mask, vals, name) for name in BUTTERFLY_VARIANTS}


def butterfly_all(mask: torch.Tensor, vals: torch.Tensor) -> dict:
    """The four formulations in one launch, as the JAX probe's main() runs
    all four on the same cases: mask, vals as for :func:`butterfly` ->
    {variant: (S, SUB) int32} for every name in BUTTERFLY_VARIANTS.  The
    outputs are views of one allocation."""
    _check_rows(mask, vals)
    if _launch.on_host(mask, vals):
        return butterfly_all_plain(mask, vals)
    out = torch.empty((len(BUTTERFLY_VARIANTS), *vals.shape), dtype=torch.int32,
                      device=vals.device)
    _launch_butterfly(mask, vals, out, 0, len(BUTTERFLY_VARIANTS))
    return dict(zip(BUTTERFLY_VARIANTS, out))


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: on the int32 view, add half of the
    13 dropped bits' unit and clear them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _check_f32dot(lut: torch.Tensor, oh: torch.Tensor, mode: str) -> None:
    if mode not in F32DOT_MODES:
        raise ValueError(f"mode must be one of {F32DOT_MODES}, got {mode!r}")
    _launch.require(lut, "lut", torch.float32, 2)
    _launch.require(oh, "oh", torch.float32, 2)
    if lut.shape[1] != oh.shape[1]:
        raise ValueError(f"lut {tuple(lut.shape)} and oh {tuple(oh.shape)} differ in depth")
    m, k = lut.shape
    n = oh.shape[0]
    if mode != "fp32" and (m % 16 or n % 8 or k % 8):
        raise ValueError(f"the mma modes take m % 16 == n % 8 == k % 8 == 0, got {m, n, k}")


def f32dot_plain(lut: torch.Tensor, oh: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`f32dot`, on any device: the operands
    rounded as the kernel rounds them, multiplied in float32 with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (set here and restored),
    so that a CUDA product does not round them again."""
    _check_f32dot(lut, oh, mode)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if mode == "fp32":
            return lut @ oh.T
        big_l, big_o = rna_tf32(lut), rna_tf32(oh)
        out = big_l @ big_o.T
        if mode == "3xtf32":
            small_l, small_o = rna_tf32(lut - big_l), rna_tf32(oh - big_o)
            out = out + big_l @ small_o.T + small_l @ big_o.T
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def f32dot(lut: torch.Tensor, oh: torch.Tensor, mode: str) -> torch.Tensor:
    """lut (M, K) float32 . oh (N, K)^T -> (M, N) float32 in ``mode``:
    "tf32" (one mma.sync TF32 pass), "3xtf32" (big/small TF32 split, three
    passes) or "fp32" (FMA, no tensor core).  The mma modes need M % 16 ==
    N % 8 == K % 8 == 0."""
    _check_f32dot(lut, oh, mode)
    if _launch.on_host(lut, oh):
        return f32dot_plain(lut, oh, mode)
    m, k = lut.shape
    n = oh.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=lut.device)
    _launch.launch(F32DOT_LAUNCHES, "pr_probe_f32dot", lut.device, _launch.ptr(lut),
                   _launch.ptr(oh), _launch.ptr(out), F32DOT_MODES.index(mode), m, n, k)
    return out


def mosaic_plain(probe: str, *inputs: torch.Tensor) -> tuple:
    """Plain PyTorch version of :func:`mosaic`, on any device."""
    _check_mosaic(probe, inputs)
    a = inputs[0]
    if probe == "a":
        return ((a[:, None, :] * inputs[1][None, :, :]).sum(dim=2),)
    if probe == "b":
        return (a.T.contiguous(),)
    if probe == "c":
        return torch.remainder(a, 258), torch.div(a, 258, rounding_mode="floor")
    if probe == "d":
        return (a.reshape(1, 2048),)
    if probe == "e":
        return (a[0::2].contiguous(),)
    if probe == "f":
        return (torch.roll(a, int(inputs[1][0]), 0),)
    if probe == "g":
        return ((a.to(torch.int64).sum() % 65521).to(torch.int32).reshape(1, 1),)
    k = inputs[1] & 7
    return ((a << k) | (a >> (8 - k)),)


def _check_mosaic(probe: str, inputs) -> None:
    if probe not in MOSAIC_PROBES:
        raise ValueError(f"probe must be one of {sorted(MOSAIC_PROBES)}, got {probe!r}")
    specs = MOSAIC_PROBES[probe][1]
    if len(inputs) != len(specs):
        raise ValueError(f"probe ({probe}) takes {len(specs)} inputs, got {len(inputs)}")
    for i, (t, (shape, dtype)) in enumerate(zip(inputs, specs)):
        _launch.require(t, f"input {i}", dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"probe ({probe}) input {i} must be {shape}, got {tuple(t.shape)}")


def _launch_mosaic(jobs) -> None:
    """One launch of the probes ``jobs`` [(letter, inputs, outputs)], a block
    each; the kernel loads and stores 16 bytes at a time."""
    ptrs = []   # input 0, input 1, output 0, output 1 a probe; null where it has none
    for _, ins, outs in jobs:
        ptrs += [t.data_ptr() for t in ins] + [None] * (2 - len(ins))
        ptrs += [t.data_ptr() for t in outs] + [None] * (2 - len(outs))
    if any(p % 16 for p in ptrs if p is not None):
        raise ValueError("the mosaic kernel takes arrays that start on a 16-byte boundary")
    order = sorted(MOSAIC_PROBES)
    probes = (ctypes.c_int32 * len(jobs))(*(order.index(letter) for letter, _, _ in jobs))
    _launch.launch(MOSAIC_LAUNCHES, "pr_probe_mosaic", jobs[0][1][0].device, len(jobs), probes,
                   (ctypes.c_void_p * len(ptrs))(*ptrs))


def mosaic(probe: str, *inputs: torch.Tensor) -> tuple:
    """Probe ``probe`` ("a".."h", MOSAIC_PROBES) on its fixed shapes:

    (a) a (8,128) . b (32,128)^T by FMA; (b) the transpose of (32,128);
    (c) a % 258 and a // 258, floored; (d) (4,512) -> (1,2048) in row order;
    (e) rows 0, 2, .., 14 of (16,128); (f) ``torch.roll(a, s[0], 0)`` of
    (32,128) with the shift s (1,) int32 read on the device; (g) the sum of
    (8,128) % 65521 as (1,1); (h) ``(a << (s & 7)) | (a >> (8 - (s & 7)))``.

    Returns the tuple of outputs.  On the card the inputs must start on a
    16-byte boundary, as every fresh allocation does."""
    _check_mosaic(probe, inputs)
    if _launch.on_host(*inputs):
        return mosaic_plain(probe, *inputs)
    dev = inputs[0].device
    outs = tuple(torch.empty(shape, dtype=dtype, device=dev)
                 for shape, dtype in MOSAIC_PROBES[probe][2])
    _launch_mosaic([(probe, inputs, outs)])
    return outs


def _check_mosaic_all(inputs: dict) -> None:
    missing = sorted(set(MOSAIC_PROBES) - set(inputs))
    unknown = sorted(set(inputs) - set(MOSAIC_PROBES))
    if missing or unknown:
        raise ValueError(f"mosaic_all takes every probe once: missing {missing}, "
                         f"unknown {unknown}")
    for probe, ins in inputs.items():
        _check_mosaic(probe, tuple(ins))


def mosaic_all_plain(inputs: dict) -> dict:
    """Plain PyTorch version of :func:`mosaic_all`, on any device: each
    probe's :func:`mosaic_plain`."""
    _check_mosaic_all(inputs)
    return {probe: mosaic_plain(probe, *inputs[probe]) for probe in sorted(MOSAIC_PROBES)}


def _mosaic_all_layout():
    """[(probe, offset in int32 words, shape, strides, dtype)] of every output
    in mosaic_all's one buffer, each at a 16-byte boundary, and the buffer's
    words."""
    layout, words = [], 0
    for probe in sorted(MOSAIC_PROBES):
        for shape, dtype in MOSAIC_PROBES[probe][2]:
            layout.append((probe, words, shape, (shape[1], 1), dtype))
            words += -(-math.prod(shape) // 4) * 4
    return layout, words


_MOSAIC_ALL_LAYOUT, _MOSAIC_ALL_WORDS = _mosaic_all_layout()


def mosaic_all(inputs: dict) -> dict:
    """Every probe of MOSAIC_PROBES in one launch, as the JAX probe's main()
    runs all eight: ``inputs`` {letter: the probe's inputs, as for
    :func:`mosaic`} -> {letter: the tuple of its outputs}.  The outputs are
    views of one allocation."""
    _check_mosaic_all(inputs)
    tensors = [t for ins in inputs.values() for t in ins]
    if _launch.on_host(*tensors):
        return mosaic_all_plain(inputs)
    buf = torch.empty(_MOSAIC_ALL_WORDS, dtype=torch.int32, device=tensors[0].device)
    typed = {torch.int32: buf, torch.float32: buf.view(torch.float32)}
    outs = {probe: [] for probe in sorted(MOSAIC_PROBES)}
    for probe, at, shape, strides, dtype in _MOSAIC_ALL_LAYOUT:
        outs[probe].append(typed[dtype].as_strided(shape, strides, at))
    _launch_mosaic([(probe, tuple(inputs[probe]), outs[probe]) for probe in outs])
    return {probe: tuple(o) for probe, o in outs.items()}
