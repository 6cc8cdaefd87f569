"""Bitmap -> set-bit positions kernel (``csrc/bitmap_positions.cu``) and its twin.

Replaces pyrecode_tpu/ops/pallas_gaps.py:bitmap_positions_pallas with one
capacity, ``out_size``: the TPU kernel's per-sub-row capacity buckets are
VMEM sizes and have no counterpart here, and its NB % 8192 == 0 rule is its
chunking.  For bitmaps (B, NB) uint8, LSB-first (bit k of byte j is index
8j + k), it returns positions (B, out_size) int32 ascending with zeros from
the count on, counts (B,) int32 clipped to ``out_size``, and overflow (B,)
bool = set bits > out_size.
"""

from __future__ import annotations

import torch

from . import _build, _launch
from .bitpack import unpack_bits
from .compact import stream_compact

LAUNCHES = _launch.LaunchCounter()


def _check(bitmaps: torch.Tensor, out_size: int) -> None:
    _launch.require(bitmaps, "bitmaps", torch.uint8, 2)
    B, NB = bitmaps.shape
    if not 0 < B < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {B}")
    if not 0 < NB < 1 << 28:
        raise ValueError(f"bitmaps must have 1 to 2**28 - 1 bytes a row, got {NB}")
    if out_size < 0:
        raise ValueError(f"out_size must be >= 0, got {out_size}")


def bitmap_positions_plain(bitmaps: torch.Tensor, out_size: int):
    """Plain PyTorch version of :func:`bitmap_positions`, on any device."""
    _check(bitmaps, out_size)
    bits = unpack_bits(bitmaps)
    index = torch.arange(bits.shape[1], dtype=torch.int32, device=bitmaps.device)
    pos, total = stream_compact(index.expand_as(bits), bits, out_size)
    return pos, total.clamp(max=out_size), total > out_size


def bitmap_positions(bitmaps: torch.Tensor, out_size: int):
    """Returns (positions, counts, overflow) as described above."""
    _check(bitmaps, out_size)
    if _launch.on_host(bitmaps):
        return bitmap_positions_plain(bitmaps, out_size)
    B, NB = bitmaps.shape
    dev = bitmaps.device
    pos = torch.empty((B, out_size), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    # the tiles' status words and the ticket, zeroed by the call's memset
    status = torch.empty(int(_build.load().pr_positions_status_words(B, NB)), dtype=torch.int64,
                         device=dev)
    _launch.launch(LAUNCHES, "pr_bitmap_positions", dev,
                   _launch.ptr(bitmaps), _launch.ptr(pos), _launch.ptr(counts),
                   _launch.ptr(overflow), _launch.ptr(status), B, NB, out_size)
    return pos, counts, overflow
