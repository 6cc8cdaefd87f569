"""Per-puddle reductions in plain PyTorch: L2 summary statistics, L4
centroids and the centroid bitmap.

Port of pyrecode_tpu/ops/segment.py over the compact component ids of
:func:`.cc_label.label_components`: slot ``k`` (0-based) holds puddle
``k + 1``; slots from the frame's count on are zero, and puddles past
``max_puddles`` are dropped.  Sums are int64 where the JAX XLA path takes
uint32 (which wraps for heavy puddles at high row indices); the judge,
``oracle.l4_centroid_pixels``, sums in uint64.  Statistics and weights are
the RAW frame values, as the oracle takes them.
"""

from __future__ import annotations

import torch

from . import _launch


def _values(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W) unsigned intensities -> (B, H*W) int64."""
    B = frames.shape[0]
    v = _launch.u16_to_i32(frames) if frames.dtype == torch.uint16 else frames
    return v.reshape(B, -1).to(torch.int64)


def _slots(labels: torch.Tensor, max_puddles: int) -> torch.Tensor:
    """(B, H, W) ids -> (B, H*W) int64 scatter columns: id for ids 1..max_puddles,
    a dump column max_puddles + 1 for the background and dropped puddles."""
    ids = labels.reshape(labels.shape[0], -1).to(torch.int64)
    return torch.where((ids >= 1) & (ids <= max_puddles), ids, max_puddles + 1)


def _segment(op: str, data: torch.Tensor, slots: torch.Tensor, max_puddles: int) -> torch.Tensor:
    """Per-slot ``op`` ("sum", "amax", "amin") of (B, N) int64 data; (B,
    max_puddles), 0 where a slot has no member (for "amin", the identity)."""
    identity = torch.iinfo(torch.int64).max if op == "amin" else 0
    out = torch.full((data.shape[0], max_puddles + 2), identity, dtype=torch.int64,
                     device=data.device)
    out.scatter_reduce_(1, slots, data, reduce=op, include_self=True)
    return out[:, 1:max_puddles + 1]


def l2_summary_stats(labels: torch.Tensor, frames: torch.Tensor, max_puddles: int,
                     statistic: str = "max", stat_limit: int = (1 << 16) - 1) -> torch.Tensor:
    """Per-puddle 'max' or 'sum' of the raw values, (B, max_puddles) int64,
    saturated at ``stat_limit`` (the smaller of the source dtype's max and
    ``2**bit_depth - 1``, as oracle.reduce_frame saturates)."""
    if statistic not in ("max", "sum"):
        raise ValueError("Only allowed values for summary stats are: 'sum' and 'max'")
    out = _segment("amax" if statistic == "max" else "sum", _values(frames),
                   _slots(labels, max_puddles), max_puddles)
    return out.clamp(max=stat_limit)


def l4_centroids(labels: torch.Tensor, frames: torch.Tensor, max_puddles: int,
                 scheme: str = "weighted_average") -> torch.Tensor:
    """Per-puddle (row, col) centroids, float64 (B, max_puddles, 2): the
    weighted or unweighted mean position, or the first raster-order maximum
    ('max').  Empty slots are (0, 0)."""
    if scheme == "max":
        return l4_centroid_pixels(labels, frames, max_puddles, "max").to(torch.float64)
    wsum, rsum, csum = _moments(labels, frames, max_puddles, scheme)
    den = wsum.clamp(min=1).to(torch.float64)
    return torch.stack([rsum / den, csum / den], dim=-1)


def _moments(labels, frames, max_puddles: int, scheme: str):
    """Per-puddle int64 sums of w, w*row and w*col."""
    if scheme not in ("weighted_average", "unweighted"):
        raise ValueError(f"Unknown centroiding scheme: {scheme}")
    B, H, W = labels.shape
    lin = torch.arange(H * W, dtype=torch.int64, device=labels.device)
    w = _values(frames) if scheme == "weighted_average" else \
        torch.ones((B, H * W), dtype=torch.int64, device=labels.device)
    slots = _slots(labels, max_puddles)
    return tuple(_segment("sum", x, slots, max_puddles) for x in (w, w * (lin // W), w * (lin % W)))


def _round_div_half_even(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Exact round-half-to-even of num / den for non-negative int64."""
    den = den.clamp(min=1)
    q = torch.div(num, den, rounding_mode="floor")
    rem = num - q * den
    down = den - rem
    up = (rem > down) | ((rem == down) & (q % 2 == 1))
    return q + up.to(torch.int64)


def l4_centroid_pixels(labels: torch.Tensor, frames: torch.Tensor, max_puddles: int,
                       scheme: str = "weighted_average") -> torch.Tensor:
    """Per-puddle centroid pixel (row, col) as exact integers, (B,
    max_puddles, 2) int64: round-half-even of the integer moments, or the
    first raster-order maximum pixel ('max')."""
    B, H, W = labels.shape
    if scheme == "max":
        n = H * W
        vals = _values(frames)
        slots = _slots(labels, max_puddles)
        vmax = _segment("amax", vals, slots, max_puddles)
        per_pixel = torch.gather(torch.nn.functional.pad(vmax, (1, 1), value=-1), 1, slots)
        lin = torch.arange(n, dtype=torch.int64, device=labels.device).expand(B, n)
        cand = torch.where(vals == per_pixel, lin, n)
        first = _segment("amin", cand, slots, max_puddles).clamp(max=n - 1)
        return torch.stack([first // W, first % W], dim=-1)
    wsum, rsum, csum = _moments(labels, frames, max_puddles, scheme)
    return torch.stack([_round_div_half_even(rsum, wsum), _round_div_half_even(csum, wsum)],
                       dim=-1)


def centroid_pixels_to_mask(pixels: torch.Tensor, counts: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """Rasterize integer centroid pixels (B, P, 2) into a bool (B, H, W)
    map; each is clipped to the frame, slots from ``counts`` on are dropped,
    and puddles that share a centroid pixel set it once."""
    B, P, _ = pixels.shape
    r = pixels[..., 0].clamp(0, height - 1)
    c = pixels[..., 1].clamp(0, width - 1)
    valid = torch.arange(P, device=pixels.device)[None, :] < counts.to(torch.int64)[:, None]
    lin = torch.where(valid, r * width + c, height * width)
    out = torch.zeros((B, height * width + 1), dtype=torch.bool, device=pixels.device)
    out.scatter_(1, lin, True)
    return out[:, :height * width].reshape(B, height, width)
