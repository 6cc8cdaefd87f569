"""Batched encode at every reduction level: threshold -> reduce -> pack.

Port of pyrecode_tpu/ops/encode.py.  :func:`encode_frames_auto` takes
uint16 frames: L1/L3 go through the fused encode kernel
(:mod:`.hopper_encode`) and, for L1, the value pack; L2/L4 through the
fused label kernel (:mod:`.hopper_label`) and, for L2, the pack of the
per-puddle statistics.  8- and 16-bit unsigned sources widen to uint16;
int8/int16 L1/L3 frames take the kernels through
:func:`signed_to_kernel_frames`, as the JAX writer sends them to its Pallas
kernel.  :func:`encode_frames` is the XLA path's counterpart for int8/int16
L2/L4 frames, in plain PyTorch in their own dtype: their statistics are of
the signed values, which the label kernel does not take.  Variable-length
streams come back in max-bound buffers with true counts, and the host
writer slices ``packed[i, :packed_len[i]]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _launch
from .bitpack import bitpack_values, bitpack_values_device, pack_bits, packed_group_shape
from .cc_label import label_components
from .hopper_encode import encode_l1
from .hopper_label import MODE_BY_CONFIG, encode_l2l4
from .segment import centroid_pixels_to_mask, l2_summary_stats, l4_centroid_pixels


@dataclass
class EncodeResult:
    """Tensors produced by one encode batch.

    bitmap : (B, ceil(H*W/8)) uint8 — bit-packed binary map
    packed : (B, max_packed_bytes) uint8 or None — packed L1 residual or L2
        summary-stat stream, zero-padded beyond packed_len
    counts : (B,) int32 — foreground pixels (L1/L3) or puddles (L2/L4)
    packed_len : (B,) int32 or None — valid bytes of ``packed`` per frame
    overflow : (B,) bool — the count exceeded the buffer bound
    positions : (B, max_values) int32 or None — each value's pixel index
        (``with_positions``), zeros from the count on
    """

    bitmap: torch.Tensor
    packed: Optional[torch.Tensor]
    counts: torch.Tensor
    packed_len: Optional[torch.Tensor]
    overflow: torch.Tensor
    positions: Optional[torch.Tensor] = None


def encode_frames_auto(frames: torch.Tensor, threshold: torch.Tensor, reduction_level: int,
                       bit_depth: int, max_values: int, with_positions: bool = False,
                       l2_statistic: str = "max", l4_scheme: str = "weighted_average",
                       stat_limit: Optional[int] = None) -> EncodeResult:
    """Encode (B, H, W) uint16 frames against an (H, W) uint16 threshold.

    ``max_values`` bounds the values per frame: foreground pixels (L1) or
    puddles (L2/L4), rounded up to the pack group where values are packed;
    a frame above it is flagged in ``overflow``.  ``with_positions`` (L1)
    also returns each value's pixel index, with the values masked to
    ``bit_depth`` bits, as the JAX writer asks the TPU kernel for scheme-12
    device entropy.  L2 statistics saturate at ``stat_limit`` (default
    ``2**bit_depth - 1``; the writer passes the smaller of that and the
    source dtype's max, as oracle.reduce_frame saturates).
    """
    if reduction_level not in (1, 2, 3, 4):
        raise ValueError(f"Unknown reduction level: {reduction_level}")
    if with_positions and reduction_level != 1:
        raise ValueError("positions come with the values of L1")
    g_vals, _ = packed_group_shape(bit_depth)
    if reduction_level in (2, 4):
        mode = MODE_BY_CONFIG[(reduction_level,
                               l2_statistic if reduction_level == 2 else l4_scheme)]
        if stat_limit is None:
            stat_limit = (1 << bit_depth) - 1
        out_size = -(-max_values // g_vals) * g_vals if reduction_level == 2 else max_values
        bitmap, stats, counts, overflow = encode_l2l4(frames, threshold, mode, out_size,
                                                      stat_limit)
        if stats is None:
            return EncodeResult(bitmap, None, counts, None, overflow)
        return EncodeResult(bitmap, bitpack_values_device(stats, bit_depth), counts,
                            (counts * bit_depth + 7) // 8, overflow)
    with_values = reduction_level == 1
    out_size = -(-max_values // g_vals) * g_vals if with_values else 0
    out = encode_l1(frames, threshold, out_size, with_values, with_positions,
                    bit_depth if with_positions else 0)
    bitmap, comp, counts, overflow = out[:4]
    if not with_values:
        return EncodeResult(bitmap, None, counts, None, overflow)
    packed = bitpack_values_device(comp, bit_depth)
    packed_len = (counts * bit_depth + 7) // 8
    return EncodeResult(bitmap, packed, counts, packed_len, overflow,
                        out[4] if with_positions else None)


def signed_to_kernel_frames(frames: torch.Tensor) -> torch.Tensor:
    """int8/int16 frames (or a threshold) as the uint16 frames the encode
    kernels take: widened to int16 with the sign bit flipped, x + 32768.
    The shift keeps the order of any two values and their difference, so
    ``frames > threshold``, the residuals (exact wherever the mask is set)
    and the positions are what the JAX Pallas kernel gives, which compares
    and subtracts in int32."""
    return (frames.to(torch.int16) ^ -0x8000).view(torch.uint16)


def _pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, ceil(H*W/8)) uint8, the bit tail zero-padded."""
    flat = mask.reshape(mask.shape[0], -1)
    return pack_bits(torch.nn.functional.pad(flat, (0, -flat.shape[1] % 8)))


def encode_frames(frames: torch.Tensor, threshold: torch.Tensor, reduction_level: int,
                  bit_depth: int, max_values: int, l2_statistic: str = "max",
                  l4_scheme: str = "weighted_average",
                  stat_limit: Optional[int] = None) -> EncodeResult:
    """Port of pyrecode_tpu/ops/encode.py:encode_frames at L2 and L4 for
    (B, H, W) frames and an (H, W) threshold in the source's own integer
    dtype.

    Foreground is ``frames > threshold``, compared in the dtype's sign.  L2
    statistics and L4 centroids are the port's :mod:`.segment` reductions
    of the raw values (int64 sums, saturated at ``stat_limit``, default
    ``2**bit_depth - 1``), which agree with the JAX XLA path where its
    uint32 sums neither wrap nor see a negative value.
    """
    if reduction_level not in (2, 4):
        raise ValueError(f"encode_frames takes reduction levels 2 and 4, not {reduction_level}: "
                         "L1/L3 frames take the encode kernel (signed_to_kernel_frames)")
    B, H, W = frames.shape
    mask = frames > threshold[None]
    labels, counts = label_components(mask)
    if reduction_level == 2:
        g_vals, _ = packed_group_shape(bit_depth)
        limit = (1 << bit_depth) - 1 if stat_limit is None else stat_limit
        stats = l2_summary_stats(labels, frames, -(-max_values // g_vals) * g_vals,
                                 l2_statistic, limit)
        return EncodeResult(_pack_mask(mask), bitpack_values(stats, bit_depth), counts,
                            (counts * bit_depth + 7) // 8, counts > stats.shape[-1])
    pixels = l4_centroid_pixels(labels, frames, max_values, l4_scheme)
    return EncodeResult(_pack_mask(centroid_pixels_to_mask(pixels, counts, H, W)), None, counts,
                        None, counts > max_values)


def count_foreground(frames: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Per-frame foreground pixel counts (B,) int32, the writer's cheap
    first pass that sizes the encode's value buffer; compared in the
    frames' own sign (uint16 through int32, as PyTorch implements few uint16
    operations on CUDA)."""
    if frames.dtype == torch.uint16:
        frames, threshold = _launch.u16_to_i32(frames), _launch.u16_to_i32(threshold)
    f = frames.reshape(frames.shape[0], -1)
    return (f > threshold.reshape(1, -1)).sum(dim=1, dtype=torch.int32)
