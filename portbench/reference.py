"""The plain reference: what a frame should read back as, from the frame and
its dark level alone.

NumPy and ``scipy.ndimage.label``; nothing of the program.  It works out
again everything the program derives: the threshold, the foreground mask,
L1's residuals and L4's puddles and centroids.

* threshold = dark + epsilon, saturated at the source dtype's maximum;
* L1: a pixel above its threshold reads frame - threshold, every other 0;
* L4: the foreground's 8-connected puddles; a puddle's centroid is the
  intensity-weighted mean of its row and column indices (weights: the raw
  frame values), each rounded half to even in exact integer arithmetic; the
  frame reads 1 at each centroid and 0 elsewhere.

``drop_bits`` > 0 computes the same in a lower precision, the control:
values (L1) or weights (L4) lose their lowest ``drop_bits`` bits.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

EIGHT_CONNECTED = np.ones((3, 3), dtype=bool)


def threshold(dark: np.ndarray, epsilon: int) -> np.ndarray:
    top = np.iinfo(dark.dtype).max
    return np.minimum(dark.astype(np.int64) + epsilon, top).astype(dark.dtype)


def expected(level: int, frame: np.ndarray, thr: np.ndarray, drop_bits: int = 0) -> np.ndarray:
    """The dense frame that reading back a frame of reduction ``level`` gives."""
    if level == 1:
        return l1_dense(frame, thr, drop_bits)
    if level == 4:
        return l4_dense(frame, thr, drop_bits)
    raise ValueError(f"the reference covers L1 and L4, not L{level}")


def l1_dense(frame: np.ndarray, thr: np.ndarray, drop_bits: int = 0) -> np.ndarray:
    above = frame > thr
    residual = np.where(above, frame - np.where(above, thr, 0), 0).astype(np.uint16)
    return (residual >> drop_bits) << drop_bits


def l4_dense(frame: np.ndarray, thr: np.ndarray, drop_bits: int = 0) -> np.ndarray:
    ny, nx = frame.shape
    labels, n = ndimage.label(frame > thr, structure=EIGHT_CONNECTED)
    out = np.zeros(ny * nx, dtype=np.uint16)
    if n == 0:
        return out.reshape(ny, nx)
    flat = labels.reshape(-1)
    idx = np.flatnonzero(flat)
    lab = flat[idx]
    w = (frame.reshape(-1)[idx].astype(np.int64) >> drop_bits) << drop_bits
    wsum = _int_bincount(lab, w, n + 1)
    rsum = _int_bincount(lab, w * (idx // nx), n + 1)
    csum = _int_bincount(lab, w * (idx % nx), n + 1)
    r = _round_half_even(rsum[1:], wsum[1:])
    c = _round_half_even(csum[1:], wsum[1:])
    out[np.clip(r, 0, ny - 1) * nx + np.clip(c, 0, nx - 1)] = 1
    return out.reshape(ny, nx)


def _int_bincount(labels: np.ndarray, weights: np.ndarray, length: int) -> np.ndarray:
    """Exact int64 sums by label (np.bincount sums weights in float64)."""
    out = np.zeros(length, dtype=np.int64)
    np.add.at(out, labels, weights)
    return out


def _round_half_even(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    den = np.maximum(den, 1)
    q, rem = np.divmod(num, den)
    down = den - rem
    up = (rem > down) | ((rem == down) & (q % 2 == 1))
    return q + up
