"""L1 decode kernels (``csrc/decode_l1.cu``, ``csrc/posdecode.cu``) and their twins.

Replaces pyrecode_tpu/ops/pallas_decode.py:decode_l1_pallas after the
unpack: for a bitmap (B, ceil(H*W/8)) uint8 and unpacked values (B, V)
int32 it returns

* dense (B, H, W) uint16 with ``dense[p] = values[rank(p)]`` (modulo 2**16)
  where bit ``p`` is set and ``rank(p) < V``, else 0; ``rank`` is the number
  of set bits before ``p`` in the frame;
* overflow (B,) bool: the frame's set bits outnumber ``V``.

The TPU kernel's capacity-bucket ladder has no counterpart: the values'
width is the only capacity.

:func:`posdecode` replaces pyrecode_tpu/ops/pallas_decode.py:
decode_l1_from_positions, the end of the scheme-12 gap read chain: for
ascending pixel positions (B, OUT) int32 and rank-aligned values (B, OUT)
int32 it returns dense (B, H, W) uint16 with ``dense[pos[k]] = values[k]``
(modulo 2**16) for k < counts, else 0, and overflow (B,) bool: a count
above OUT, or a position outside the frame or not above the one before it
(a corrupt stream; the dense frame is then unspecified).  The TPU kernel's
capacity-bucket ladder collapses to this one call.
"""

from __future__ import annotations

import torch

from . import _launch
from .bitpack import unpack_bits

LAUNCHES = _launch.LaunchCounter()
POSDECODE_LAUNCHES = _launch.LaunchCounter()
# output pixels one block of the positions decode owns (csrc/posdecode.cu:
# SPAN), for batteries that put positions on the spans' edges
POSDECODE_SPAN = 8192
# pixels one block of the decode's expand pass owns (csrc/decode_l1.cu:
# EXPAND_TILES tiles of _launch.TILE_PIXELS), for batteries on its edges
EXPAND_PIXELS = 16 * _launch.TILE_PIXELS
PHASES_LAUNCHES = _launch.LaunchCounter()      # the phase probe's cut-offs (P2)
PHASES = ("store", "count", "scan", "full")     # decode_l1_phases' cut-offs, in order


def _check(bitmap: torch.Tensor, values: torch.Tensor, height: int, width: int) -> None:
    _launch.require(bitmap, "bitmap", torch.uint8, 2)
    _launch.require(values, "values", torch.int32, 2)
    n = height * width
    if bitmap.shape[1] != (n + 7) // 8:
        raise ValueError(f"bitmap has {bitmap.shape[1]} bytes per frame, "
                         f"a {height}x{width} frame needs {(n + 7) // 8}")
    if values.shape[0] != bitmap.shape[0]:
        raise ValueError("bitmap and values hold different numbers of frames")
    if n >= 1 << 31:
        raise ValueError("frames of 2**31 pixels or more are not supported")
    if not 0 < bitmap.shape[0] < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {bitmap.shape[0]}")


def decode_l1_plain(bitmap: torch.Tensor, values: torch.Tensor, height: int, width: int):
    """Plain PyTorch version of :func:`decode_l1`, on any device."""
    _check(bitmap, values, height, width)
    B, V = values.shape
    n = height * width
    mask = unpack_bits(bitmap)[:, :n].to(torch.int32)
    rank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    counts = mask.sum(dim=1)
    if V == 0:
        dense = torch.zeros((B, n), dtype=torch.int32, device=bitmap.device)
    else:
        gathered = torch.gather(values, 1, rank.clamp(0, V - 1).to(torch.int64))
        dense = torch.where((mask > 0) & (rank < V), gathered, 0)
    return _launch.i32_to_u16(dense).reshape(B, height, width), counts > V


def decode_l1(bitmap: torch.Tensor, values: torch.Tensor, height: int, width: int):
    """Returns (dense (B, H, W) uint16, overflow (B,) bool)."""
    _check(bitmap, values, height, width)
    if _launch.on_host(bitmap, values):
        return decode_l1_plain(bitmap, values, height, width)
    B, V = values.shape
    n = height * width
    dev = bitmap.device
    dense = torch.empty((B, height, width), dtype=torch.uint16, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    tiles = torch.empty((B, _launch.num_tiles(n)), dtype=torch.int32, device=dev)
    _launch.launch(LAUNCHES, "pr_decode_l1", dev,
                   _launch.ptr(bitmap), _launch.ptr(values), _launch.ptr(dense),
                   _launch.ptr(overflow), _launch.ptr(tiles), B, n, V)
    return dense, overflow


def decode_l1_phases_plain(bitmap: torch.Tensor, values: torch.Tensor, height: int, width: int,
                           stop_after: str = "full"):
    """Plain PyTorch version of :func:`decode_l1_phases`, on any device."""
    _check(bitmap, values, height, width)
    if stop_after == "full":
        return decode_l1_plain(bitmap, values, height, width)
    B, V = values.shape
    n = height * width
    mask = unpack_bits(bitmap)[:, :n]
    if stop_after == "store":
        return (mask.to(torch.int16).view(torch.uint16).reshape(B, height, width),)
    tiles = _launch.tile_sums(mask.to(torch.int32), -(-n // _launch.TILE_PIXELS)).to(torch.int32)
    if stop_after == "count":
        return (tiles,)
    counts = tiles.sum(dim=1, dtype=torch.int32)
    return (torch.cumsum(tiles, dim=1) - tiles).to(torch.int32), counts, counts > V


def decode_l1_phases(bitmap: torch.Tensor, values: torch.Tensor, height: int, width: int,
                     stop_after: str = "full"):
    """The decode cut after one of its passes (PHASES), for the phase probe
    (``pyrecode_tpu_torch.tools.probe_decode_phases``; kernel P2, replacing
    the truncated kernels of tools/probe_decode_phases.py:build_phase_kernel).
    Returns

    * "store": (mask (B, H, W) uint16,), the bitmap's 0/1 mask: the dense
      store alone;
    * "count": (tiles (B, n_tiles) int32,), each tile's set bits;
    * "scan": (tile offsets (B, n_tiles) int32, counts (B,) int32, overflow
      (B,) bool);
    * "full": :func:`decode_l1`'s outputs.
    """
    if stop_after not in PHASES:
        raise ValueError(f"stop_after must be one of {PHASES}, got {stop_after!r}")
    _check(bitmap, values, height, width)
    if _launch.on_host(bitmap, values):
        return decode_l1_phases_plain(bitmap, values, height, width, stop_after)
    B, V = values.shape
    n = height * width
    dev = bitmap.device
    dense = torch.empty((B, height, width), dtype=torch.uint16, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    tiles = torch.empty((B, _launch.num_tiles(n)), dtype=torch.int32, device=dev)
    offsets = torch.empty_like(tiles)
    _launch.launch(PHASES_LAUNCHES, "pr_decode_l1_phases", dev,
                   _launch.ptr(bitmap), _launch.ptr(values), _launch.ptr(dense),
                   _launch.ptr(overflow), _launch.ptr(counts), _launch.ptr(tiles),
                   _launch.ptr(offsets), B, n, V, PHASES.index(stop_after))
    return {"store": (dense,), "count": (tiles,), "scan": (offsets, counts, overflow),
            "full": (dense, overflow)}[stop_after]


def _check_positions(positions: torch.Tensor, values: torch.Tensor, counts: torch.Tensor,
                     height: int, width: int) -> None:
    _launch.require(positions, "positions", torch.int32, 2)
    _launch.require(values, "values", torch.int32, 2)
    _launch.require(counts, "counts", torch.int32, 1)
    if tuple(values.shape) != tuple(positions.shape):
        raise ValueError(f"values {tuple(values.shape)} and positions "
                         f"{tuple(positions.shape)} differ in shape")
    if counts.shape[0] != positions.shape[0]:
        raise ValueError("counts and positions hold different numbers of frames")
    if height * width >= 1 << 31:
        raise ValueError("frames of 2**31 pixels or more are not supported")
    if not 0 < positions.shape[0] < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {positions.shape[0]}")


def posdecode_plain(positions: torch.Tensor, values: torch.Tensor, counts: torch.Tensor,
                    height: int, width: int):
    """Plain PyTorch version of :func:`posdecode`, on any device."""
    _check_positions(positions, values, counts, height, width)
    B, out = positions.shape
    n = height * width
    dense = torch.zeros((B, n), dtype=torch.int32, device=positions.device)
    overflow = torch.zeros(B, dtype=torch.bool, device=positions.device)
    for b in range(B):
        c = int(counts[b])
        if not 0 <= c <= out:
            overflow[b] = True
        c = min(max(c, 0), out)
        p = positions[b, :c].to(torch.int64)
        ok = (p >= 0) & (p < n)
        ok[1:] &= p[1:] > p[:-1]
        if not bool(ok.all()):
            overflow[b] = True
        dense[b, p[ok]] = values[b, :c][ok]
    return _launch.i32_to_u16(dense).reshape(B, height, width), overflow


def posdecode(positions: torch.Tensor, values: torch.Tensor, counts: torch.Tensor,
              height: int, width: int):
    """Returns (dense (B, H, W) uint16, overflow (B,) bool)."""
    _check_positions(positions, values, counts, height, width)
    if _launch.on_host(positions, values, counts):
        return posdecode_plain(positions, values, counts, height, width)
    B, out = positions.shape
    dev = positions.device
    dense = torch.empty((B, height, width), dtype=torch.uint16, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    _launch.launch(POSDECODE_LAUNCHES, "pr_posdecode", dev, _launch.ptr(positions),
                   _launch.ptr(values), _launch.ptr(counts), _launch.ptr(dense),
                   _launch.ptr(overflow), B, out, height * width)
    return dense, overflow
