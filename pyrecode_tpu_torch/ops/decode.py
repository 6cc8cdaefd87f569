"""Batched decode in plain PyTorch: packed streams -> dense frames.

Port of pyrecode_tpu/ops/decode.py.  The gather formulation:

    mask  = unpack_bits(bitmap)                     (B, H*W)
    rank  = cumsum(mask) - 1                        position among fg pixels
    vals  = bitunpack_values(packed, b)             (B, max_vals)
    dense = vals[rank] * mask                       one gather

The device path of the reader goes through the unpack and decode kernels
(:mod:`.hopper_bitpack`, :mod:`.hopper_decode`) instead.
"""

from __future__ import annotations

import torch

from .bitpack import bitunpack_values, unpack_bits


def decode_l1_frames(bitmap: torch.Tensor, packed: torch.Tensor, height: int, width: int,
                     bit_depth: int, out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Decode L1 frames to dense (B, H, W) residual images.

    bitmap : (B, ceil(H*W/8)) uint8 bit-packed binary maps
    packed : (B, m) uint8 packed intensity streams, zero-padded; ``m*8`` must
        be >= max foreground count * bit_depth and a multiple of the byte
        group size
    The JAX version defaults to uint16 output; PyTorch implements few uint16
    operations, so the default here is int32 with the same values.
    """
    B = bitmap.shape[0]
    n = height * width
    mask = unpack_bits(bitmap)[:, :n].to(torch.int64)
    rank = torch.cumsum(mask, dim=-1) - 1
    vals = bitunpack_values(packed, bit_depth, out_dtype=torch.int64)
    max_vals = vals.shape[-1]
    gathered = torch.gather(vals, -1, rank.clamp(0, max_vals - 1))
    return (gathered * mask).to(out_dtype).reshape(B, height, width)


def decode_bitmap_frames(bitmap: torch.Tensor, height: int, width: int,
                         out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Decode L2/L3/L4 bitmaps to dense 0/1 frames (value 1 per set bit)."""
    B = bitmap.shape[0]
    n = height * width
    return unpack_bits(bitmap)[:, :n].to(out_dtype).reshape(B, height, width)
