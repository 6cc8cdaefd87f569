"""Bit packing in plain PyTorch, for every bit depth 1-16.

Port of pyrecode_tpu/ops/bitpack.py with the same wire format:

* binary maps: row-major pixel order, LSB-first within each byte;
* value streams: value ``i`` occupies bits ``[i*b, (i+1)*b)`` of an LSB-first
  bitstream, each value's own bits LSB-first.

A ``b``-bit stream repeats every ``lcm(8, b)`` bits, so values go in groups
of ``lcm(8, b) / b`` values -> ``lcm(8, b) / 8`` bytes with a few static
shifts.  These functions are the plain twins of the 12-bit kernels in
:mod:`.hopper_bitpack` and the path for every other bit depth.
"""

from __future__ import annotations

import math

import torch

_U32 = 0xFFFFFFFF


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 tensor (..., n) with n % 8 == 0 into bytes (..., n // 8).

    LSB-first within each byte: bit k of byte j is element ``j*8 + k``.
    """
    *lead, n = bits.shape
    if n % 8:
        raise ValueError(f"pack_bits needs a multiple of 8 elements, got {n}")
    b = bits.reshape(*lead, n // 8, 8).to(torch.int32)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: bytes (..., m) -> 0/1 uint8 (..., m * 8)."""
    *lead, m = packed.shape
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32).unsqueeze(-1) >> shifts) & 1
    return bits.to(torch.uint8).reshape(*lead, m * 8)


def packed_group_shape(bit_depth: int):
    """(values per group, bytes per group) for a ``bit_depth``-bit stream."""
    l = math.lcm(8, bit_depth)
    return l // bit_depth, l // 8


def packed_size_bytes(n_values: int, bit_depth: int) -> int:
    return -(-n_values * bit_depth // 8)


def _check_depth(bit_depth: int) -> None:
    if not 1 <= bit_depth <= 16:
        raise ValueError(f"bit_depth must be in 1..16, got {bit_depth}")


def bitpack_values(values: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Pack (..., n) unsigned values into a ``bit_depth``-bit stream (..., n*b/8).

    ``n`` must be a multiple of ``lcm(8, bit_depth) / bit_depth``.  Values are
    read as unsigned 32-bit integers (as the JAX version casts to uint32);
    bits above ``bit_depth`` spill into the next byte exactly as there.
    """
    _check_depth(bit_depth)
    g_vals, g_bytes = packed_group_shape(bit_depth)
    *lead, n = values.shape
    if n % g_vals:
        raise ValueError(f"n={n} must be a multiple of the value group size {g_vals}")
    v = (values.to(torch.int64) & _U32).reshape(*lead, n // g_vals, g_vals)
    out_bytes = []
    for j in range(g_bytes):
        acc = None
        for k in range(g_vals):
            lo, hi = k * bit_depth, (k + 1) * bit_depth  # bit span of value k
            if hi <= 8 * j or lo >= 8 * (j + 1):
                continue
            shift = lo - 8 * j
            piece = v[..., k] << shift if shift >= 0 else v[..., k] >> (-shift)
            piece = piece & 0xFF
            acc = piece if acc is None else acc | piece
        out_bytes.append(acc)
    out = torch.stack(out_bytes, dim=-1).to(torch.uint8)
    return out.reshape(*lead, (n // g_vals) * g_bytes)


def packed_word_group_shape(bit_depth: int):
    """(values per group, 32-bit words per group) for a ``bit_depth``-bit stream."""
    l = math.lcm(32, bit_depth)
    return l // bit_depth, l // 32


def bitpack_values_words(values: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Word-oriented :func:`bitpack_values`: each group of ``lcm(32, b) /
    b`` values is combined into ``lcm(32, b) / 32`` little-endian uint32
    words, returned as their bytes (..., n*b/8) uint8.  ``n`` must be a
    multiple of the word group size.  Values are read as uint32 and ORed
    unmasked into their words, as the JAX version does: the bytes equal
    :func:`bitpack_values`' for values that fit ``bit_depth`` bits."""
    _check_depth(bit_depth)
    g_vals, g_words = packed_word_group_shape(bit_depth)
    *lead, n = values.shape
    if n % g_vals:
        raise ValueError(f"n={n} must be a multiple of the word group size {g_vals}")
    v = (values.to(torch.int64) & _U32).reshape(*lead, n // g_vals, g_vals)
    out_words = []
    for j in range(g_words):
        acc = None
        for k in range(g_vals):
            lo, hi = k * bit_depth, (k + 1) * bit_depth  # bit span of value k
            if hi <= 32 * j or lo >= 32 * (j + 1):
                continue
            shift = lo - 32 * j
            piece = (v[..., k] << shift) & _U32 if shift >= 0 else v[..., k] >> (-shift)
            acc = piece if acc is None else acc | piece
        out_words.append(acc)
    w = torch.stack(out_words, dim=-1)                   # (..., G, g_words)
    by = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], dim=-1).to(torch.uint8)
    return by.reshape(*lead, (n // g_vals) * g_words * 4)


def bitunpack_values(packed: torch.Tensor, bit_depth: int,
                     out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Unpack a ``bit_depth``-bit stream (..., m) into values (..., m*8/b).

    ``m`` must be a multiple of ``lcm(8, bit_depth) / 8``.  The JAX version
    returns uint32 by default; values of at most 16 bits fit int32 exactly.
    """
    _check_depth(bit_depth)
    g_vals, g_bytes = packed_group_shape(bit_depth)
    *lead, m = packed.shape
    if m % g_bytes:
        raise ValueError(f"m={m} must be a multiple of the byte group size {g_bytes}")
    b = packed.reshape(*lead, m // g_bytes, g_bytes).to(torch.int32)
    mask = (1 << bit_depth) - 1
    out_vals = []
    for k in range(g_vals):
        lo, hi = k * bit_depth, (k + 1) * bit_depth
        acc = None
        for j in range(g_bytes):
            if hi <= 8 * j or lo >= 8 * (j + 1):
                continue
            shift = lo - 8 * j  # inverse of the pack shift
            piece = b[..., j] >> shift if shift >= 0 else b[..., j] << (-shift)
            acc = piece if acc is None else acc | piece
        out_vals.append(acc & mask)
    out = torch.stack(out_vals, dim=-1)
    return out.reshape(*lead, (m // g_bytes) * g_vals).to(out_dtype)


def bitpack_values_device(values: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """:func:`bitpack_values` through the 12-bit pack kernel where it applies
    (2-D int32 values, 12 bits), the plain version otherwise."""
    from .hopper_bitpack import bitpack12

    if bit_depth == 12 and values.dim() == 2 and values.dtype == torch.int32:
        return bitpack12(values.contiguous())
    return bitpack_values(values, bit_depth)


def bitunpack_values_device(packed: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """:func:`bitunpack_values` to int32 through the 12-bit unpack kernel
    where it applies (2-D uint8 streams, 12 bits)."""
    from .hopper_bitpack import bitunpack12

    if bit_depth == 12 and packed.dim() == 2 and packed.dtype == torch.uint8:
        return bitunpack12(packed.contiguous())
    return bitunpack_values(packed, bit_depth, out_dtype=torch.int32)
