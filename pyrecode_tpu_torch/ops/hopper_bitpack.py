"""12-bit pack / unpack kernels (``csrc/bitpack12.cu``) and their twins.

``bitpack12`` replaces pyrecode_tpu/ops/pallas_bitpack.py:bitpack12_pallas,
``bitunpack12`` replaces bitunpack12_pallas and ``bitpack12_words``
replaces bitpack12_words_pallas.  The JAX kernels need ``n % 262144 ==
0``, an artefact of their TPU tiling; these take any even number of values
(any multiple of 3 bytes; any multiple of 8 values for the words).  The
twins are :func:`.bitpack.bitpack_values` / :func:`.bitpack.bitunpack_values`
/ :func:`.bitpack.bitpack_values_words` at 12 bits.  ``bitpack12_words`` is
an alternate of ``bitpack12``, as in the JAX package: nothing on the
writer's path calls it.
"""

from __future__ import annotations

import torch

from . import _launch
from .bitpack import bitpack_values, bitpack_values_words, bitunpack_values

PACK_LAUNCHES = _launch.LaunchCounter()
UNPACK_LAUNCHES = _launch.LaunchCounter()
WORDS_LAUNCHES = _launch.LaunchCounter()


def bitpack12_plain(values: torch.Tensor) -> torch.Tensor:
    return bitpack_values(values, 12)


def bitunpack12_plain(packed: torch.Tensor) -> torch.Tensor:
    return bitunpack_values(packed, 12, out_dtype=torch.int32)


def bitpack12(values: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 values, n even -> (B, 3n/2) uint8 LSB-first 12-bit stream."""
    _launch.require(values, "values", torch.int32, 2)
    B, n = values.shape
    if n % 2:
        raise ValueError(f"n={n} must be even (2 values per 3-byte group)")
    if _launch.on_host(values):
        return bitpack12_plain(values)
    out = torch.empty((B, 3 * n // 2), dtype=torch.uint8, device=values.device)
    _launch.launch(PACK_LAUNCHES, "pr_bitpack12", values.device,
                   _launch.ptr(values), _launch.ptr(out), B * n // 2)
    return out


def bitpack12_words_plain(values: torch.Tensor) -> torch.Tensor:
    return bitpack_values_words(values, 12).view(torch.int32)


def bitpack12_words(values: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 values, n % 8 == 0 -> (B, 3n/8) int32 little-endian
    words of the 12-bit stream: ``w0 = v0 | v1 << 12 | v2 << 24``, ``w1 = v2
    >> 8 | v3 << 4 | v4 << 16 | v5 << 28``, ``w2 = v5 >> 4 | v6 << 8 | v7 <<
    20`` in uint32 for each group of 8.  ``out.view(torch.uint8)`` is
    ``bitpack_values_words(values, 12)`` for any input, and ``bitpack12``'s
    bytes for values below 4096."""
    _launch.require(values, "values", torch.int32, 2)
    B, n = values.shape
    if n % 8:
        raise ValueError(f"n={n} must be a multiple of 8 (8 values per 3-word group)")
    if _launch.on_host(values):
        return bitpack12_words_plain(values)
    out = torch.empty((B, 3 * n // 8), dtype=torch.int32, device=values.device)
    _launch.launch(WORDS_LAUNCHES, "pr_bitpack12_words", values.device,
                   _launch.ptr(values), _launch.ptr(out), B * n // 8)
    return out


def bitunpack12(packed: torch.Tensor) -> torch.Tensor:
    """(B, m) uint8 12-bit stream, m % 3 == 0 -> (B, 2m/3) int32 values."""
    _launch.require(packed, "packed", torch.uint8, 2)
    B, m = packed.shape
    if m % 3:
        raise ValueError(f"m={m} must be a multiple of 3 (3 bytes per 2 values)")
    if _launch.on_host(packed):
        return bitunpack12_plain(packed)
    out = torch.empty((B, 2 * m // 3), dtype=torch.int32, device=packed.device)
    _launch.launch(UNPACK_LAUNCHES, "pr_bitunpack12", packed.device,
                   _launch.ptr(packed), _launch.ptr(out), B * m // 3)
    return out
