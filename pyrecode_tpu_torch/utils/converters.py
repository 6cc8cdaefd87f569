"""Reduction-level converters on the device.

Port of pyrecode_tpu/utils/converters.py:l1_to_l4_batch, through the fused
L2/L4 label kernel (:func:`..ops.hopper_label.encode_l2l4`) with a zero
threshold: the foreground is ``dense > 0`` and the centroid weights are the
raw values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bitpack import unpack_bits
from ..ops.hopper_label import MODE_BY_CONFIG, encode_l2l4


def l1_to_l4_batch(dense_frames: np.ndarray, method: str = "weighted_average",
                   max_puddles: Optional[int] = None, device="cuda") -> np.ndarray:
    """Centroid maps (B, H, W) bool of a batch of dense L1 frames (B, H, W).

    ``method`` is the L4 scheme ('weighted_average', 'unweighted' or 'max').
    ``max_puddles`` bounds the puddles of a frame; the default, the largest
    foreground count of the batch, never drops one.  A frame with more
    puddles than ``max_puddles`` raises.  ``device`` is "cuda" (the kernel)
    or "cpu" (its plain twin).
    """
    dense = np.asarray(dense_frames)
    if dense.ndim != 3:
        raise ValueError(f"dense_frames must be (B, H, W), got shape {dense.shape}")
    if not np.issubdtype(dense.dtype, np.integer) or (dense.size and (
            int(dense.min()) < 0 or int(dense.max()) > 0xFFFF)):
        raise ValueError("dense_frames must hold integers in 0..65535")
    B, H, W = dense.shape
    dev = resolve_device(device)
    frames = torch.from_numpy(np.ascontiguousarray(dense, dtype=np.uint16)).to(dev)
    threshold = torch.zeros((H, W), dtype=torch.uint16, device=dev)
    if max_puddles is None:
        max_puddles = max(int((dense > 0).reshape(B, -1).sum(axis=1).max()), 1)
    bitmap, _, _, overflow = encode_l2l4(frames, threshold, MODE_BY_CONFIG[(4, method)],
                                         max_puddles, 0)
    if bool(overflow.any()):
        raise ValueError(f"a frame holds more than max_puddles={max_puddles} puddles")
    return unpack_bits(bitmap)[:, :H * W].reshape(B, H, W).cpu().numpy().astype(bool)
