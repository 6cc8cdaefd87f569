"""Fused L2/L4 encode kernel (``csrc/label_l2l4.cu``) and its twin.

Replaces pyrecode_tpu/ops/pallas_label.py:encode_l2l4_pallas.  For frames
(B, H, W) uint16, a threshold (H, W) uint16 and one of the modes

    l2max, l2sum          L2: per-puddle max or sum of the raw values
    l4w, l4u, l4m         L4: weighted_average, unweighted or max centroids

it returns (bitmap (B, ceil(H*W/8)) uint8, stats (B, out_size) int32 or
None, counts (B,) int32, overflow (B,) bool):

* bitmap: the foreground mask (L2) or the centroid map (L4), LSB-first;
* stats (L2): puddle k's statistic at slot k, puddles numbered in raster
  order of their first pixel as scipy.ndimage.label numbers them,
  saturated at ``stat_limit``, zeros from the count on;
* counts: puddles per frame; overflow: count > out_size.

Unlike the TPU kernel it has no halo and no capacity ladder: any puddle
size and shape is exact, and any H x W is taken.
"""

from __future__ import annotations

import torch

from . import _build, _launch
from .bitpack import pack_bits
from .cc_label import label_components
from .segment import centroid_pixels_to_mask, l2_summary_stats, l4_centroid_pixels

LAUNCHES = _launch.LaunchCounter()
# the dense pass's tile (csrc/label_l2l4.cu: TILE_H rows of TILE_W pixels,
# runs of set bits taken within each row's TILE_W segment), for batteries
# that put puddles across its borders
TILE_H, TILE_W = 32, 256

MODES = {"l2max": 0, "l2sum": 1, "l4w": 2, "l4u": 3, "l4m": 4}
# (reduction level, L2 statistic or L4 scheme) -> mode, as pallas_label._MODE_BY_CONFIG
MODE_BY_CONFIG = {
    (2, "max"): "l2max",
    (2, "sum"): "l2sum",
    (4, "weighted_average"): "l4w",
    (4, "unweighted"): "l4u",
    (4, "max"): "l4m",
}
CONFIG_BY_MODE = {mode: config for config, mode in MODE_BY_CONFIG.items()}


def _check(frames: torch.Tensor, threshold: torch.Tensor, mode: str, out_size: int,
           stat_limit: int) -> None:
    _launch.require(frames, "frames", torch.uint16, 3)
    _launch.require(threshold, "threshold", torch.uint16, 2)
    if tuple(threshold.shape) != tuple(frames.shape[1:]):
        raise ValueError(f"threshold shape {tuple(threshold.shape)} does not match "
                         f"frames {tuple(frames.shape)}")
    B, H, W = frames.shape
    if not 0 < H * W < 1 << 31:
        raise ValueError(f"frames must have 1 to 2**31 - 1 pixels, got {H}x{W}")
    if not 0 < B < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {B}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if out_size < 0:
        raise ValueError(f"out_size must be >= 0, got {out_size}")
    if not 0 <= stat_limit < 1 << 31:
        raise ValueError(f"stat_limit must be in 0..2**31 - 1, got {stat_limit}")


def encode_l2l4_plain(frames: torch.Tensor, threshold: torch.Tensor, mode: str, out_size: int,
                      stat_limit: int):
    """Plain PyTorch version of :func:`encode_l2l4`, on any device."""
    _check(frames, threshold, mode, out_size, stat_limit)
    B, H, W = frames.shape
    n = H * W
    mask = _launch.u16_to_i32(frames) > _launch.u16_to_i32(threshold)[None]
    labels, counts = label_components(mask)
    overflow = counts > out_size
    if mode.startswith("l2"):
        stats = l2_summary_stats(labels, frames, out_size, mode[2:], stat_limit)
        bitmap_mask = mask
        stats = stats.to(torch.int32)
    else:
        pixels = l4_centroid_pixels(labels, frames, out_size, CONFIG_BY_MODE[mode][1])
        bitmap_mask = centroid_pixels_to_mask(pixels, counts.clamp(max=out_size), H, W)
        stats = None
    flat = torch.nn.functional.pad(bitmap_mask.reshape(B, n).to(torch.uint8), (0, -n % 8))
    return pack_bits(flat), stats, counts, overflow


def encode_l2l4(frames: torch.Tensor, threshold: torch.Tensor, mode: str, out_size: int,
                stat_limit: int):
    """Returns (bitmap, stats or None, counts, overflow) as described above."""
    _check(frames, threshold, mode, out_size, stat_limit)
    if _launch.on_host(frames, threshold):
        return encode_l2l4_plain(frames, threshold, mode, out_size, stat_limit)
    B, H, W = frames.shape
    n = H * W
    n_bytes = (n + 7) // 8
    dev = frames.device
    is_l2 = mode.startswith("l2")
    # L4 ORs centroid bits into 32-bit words of the whole buffer, whose bytes
    # the kernel zeroes first; no buffer here needs a fill
    words = torch.empty(-(-B * n_bytes // 4), dtype=torch.int32, device=dev)
    bitmap = words.view(torch.uint8)[:B * n_bytes].view(B, n_bytes)
    mask = bitmap if is_l2 else torch.empty((B, n_bytes), dtype=torch.uint8, device=dev)
    parent = torch.empty((B, n), dtype=torch.int32, device=dev)
    tiles = torch.empty((B, int(_build.load().pr_label_tiles(n))), dtype=torch.int32,
                        device=dev)
    n_acc = 3 if mode in ("l4w", "l4u") else 1
    acc = torch.empty((B, out_size, n_acc), dtype=torch.int64, device=dev)
    stats = torch.empty((B, out_size), dtype=torch.int32, device=dev) if is_l2 else None
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    _launch.launch(LAUNCHES, "pr_label_l2l4", dev,
                   _launch.ptr(frames), _launch.ptr(threshold), _launch.ptr(mask),
                   _launch.ptr(words), _launch.ptr(parent), _launch.ptr(tiles),
                   _launch.ptr(acc), _launch.ptr(stats) if is_l2 else None,
                   _launch.ptr(counts), _launch.ptr(overflow), MODES[mode], B, H, W, out_size,
                   stat_limit)
    return bitmap, stats, counts, overflow
