"""12-bit pack / unpack kernels (``csrc/bitpack12.cu``) and their twins.

``bitpack12`` replaces pyrecode_tpu/ops/pallas_bitpack.py:bitpack12_pallas
and ``bitunpack12`` replaces bitunpack12_pallas.  The JAX kernels need
``n % 262144 == 0``, an artefact of their TPU tiling; these take any even
number of values (any multiple of 3 bytes).  The twins are
:func:`.bitpack.bitpack_values` / :func:`.bitpack.bitunpack_values` at 12
bits.
"""

from __future__ import annotations

import torch

from . import _launch
from .bitpack import bitpack_values, bitunpack_values

PACK_LAUNCHES = _launch.LaunchCounter()
UNPACK_LAUNCHES = _launch.LaunchCounter()


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
