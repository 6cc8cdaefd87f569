"""CPU oracle: a small, correct, vectorized-numpy ReCoDe codec.

The port's own copy of pyrecode_tpu/oracle.py: the port imports nothing of the
JAX package.

This module defines the *semantics* the TPU kernels are tested against, and
doubles as the host fallback encode/decode path.  It reproduces the reference
wire format exactly where the reference is exercised (L1/L3, modes 0/1) and
implements the documented spec for L2/L4 where the reference code is defective
(see SURVEY.md §5.1: the reference's in-writer L4 path crashes and its L2
summary-stat pack/unpack loops are broken).

Bit order facts (reference c_extensions/reader.h:2 ``SetBit`` and
recode_writer.py:622-652):

* binary map: row-major pixel order, LSB-first within each byte — identical to
  ``np.packbits(..., bitorder='little')``;
* packed intensities: value ``i`` occupies bit range ``[i*b, (i+1)*b)`` of an
  LSB-first bitstream, with each value's bits stored LSB-first.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import scipy.ndimage as nd

_EIGHT_CONNECTED = np.ones((3, 3), dtype=bool)  # nd.generate_binary_structure(2, 2)


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def pack_binary_frame(binary_frame: np.ndarray) -> np.ndarray:
    """Bit-pack a boolean frame to bytes, row-major, LSB-first per byte.

    Semantics of reference ``_pack_binary_frame`` (recode_writer.py:622-634).
    """
    flat = np.ascontiguousarray(binary_frame, dtype=np.uint8).reshape(-1)
    n_bytes = (flat.size + 7) // 8
    packed = np.packbits(flat, bitorder="little")
    if packed.size < n_bytes:  # only when flat.size % 8 != 0 and all-zero tail
        packed = np.pad(packed, (0, n_bytes - packed.size))
    return packed


def unpack_binary_frame(packed: np.ndarray, n_pixels: int) -> np.ndarray:
    """Inverse of :func:`pack_binary_frame`; returns flat uint8 0/1 array."""
    arr = np.frombuffer(bytes(packed), dtype=np.uint8)
    return np.unpackbits(arr, bitorder="little")[:n_pixels]


def bit_pack(values: np.ndarray, bit_depth: int) -> np.ndarray:
    """Pack unsigned integer values into a ``bit_depth``-bit LSB-first stream.

    Semantics of reference ``_bit_pack`` (recode_writer.py:637-652) /
    ``_bit_pack_pixel_intensities`` (reader.h:105-140).
    """
    values = np.asarray(values)
    n = values.size
    n_packed = int(math.ceil(n * bit_depth / 8.0))
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    # expand each value to its bit_depth bits, LSB-first: (n, bit_depth)
    shifts = np.arange(bit_depth, dtype=np.uint64)
    bits = (values.astype(np.uint64)[:, None] >> shifts) & np.uint64(1)
    bitstream = bits.reshape(-1).astype(np.uint8)
    packed = np.packbits(bitstream, bitorder="little")
    if packed.size < n_packed:
        packed = np.pad(packed, (0, n_packed - packed.size))
    return packed[:n_packed]


def bit_unpack(packed: np.ndarray, bit_depth: int, n_values: int, dtype=np.uint64) -> np.ndarray:
    """Unpack ``n_values`` ``bit_depth``-bit values from an LSB-first stream.

    Correct version of reference ``_bit_unpack_pixel_intensities``
    (reader.h:74-99, whose loop head is defective).
    """
    if n_values == 0:
        return np.zeros(0, dtype=dtype)
    arr = np.frombuffer(bytes(packed), dtype=np.uint8)
    bits = np.unpackbits(arr, bitorder="little")
    needed = n_values * bit_depth
    if bits.size < needed:
        bits = np.pad(bits, (0, needed - bits.size))
    bits = bits[:needed].reshape(n_values, bit_depth).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(bit_depth, dtype=np.uint64))
    return (bits * weights).sum(axis=1).astype(dtype)


# ---------------------------------------------------------------------------
# reduction
# ---------------------------------------------------------------------------

def threshold_frame(frame: np.ndarray, threshold: np.ndarray) -> np.ndarray:
    """Foreground mask: ``frame > dark + epsilon`` (recode_writer.py:437)."""
    return frame > threshold


def l1_residuals(frame: np.ndarray, threshold: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Row-major foreground residual intensities (recode_writer.py:440)."""
    return (frame[mask] - threshold[mask])


def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected component labeling, labels in row-major first-encounter order.

    Matches ``scipy.ndimage.label`` with a full 3x3 structure
    (recode_writer.py:166, 443).
    """
    labels, num = nd.label(mask, structure=_EIGHT_CONNECTED)
    return labels, int(num)


def l2_summary_stats(labels: np.ndarray, frame: np.ndarray, num_features: int,
                     statistic: str = "max") -> np.ndarray:
    """Per-puddle summary statistic ('max' or 'sum'), puddle order = label order.

    Correct implementation of the semantics of ``get_summary_stats_nb``
    (converters.py:262-297).  Sums are clipped to the frame dtype's max so the
    result still fits the declared bit depth.
    """
    if statistic not in ("max", "sum"):
        raise ValueError("Only allowed values for summary stats are: 'sum' and 'max'")
    if num_features == 0:
        return np.zeros(0, dtype=frame.dtype)
    idx = labels.reshape(-1)
    vals = frame.reshape(-1).astype(np.float64)
    if statistic == "max":
        stats = nd.maximum(frame, labels=labels, index=np.arange(1, num_features + 1))
        stats = np.asarray(stats, dtype=np.float64)
    else:
        stats = np.bincount(idx, weights=vals, minlength=num_features + 1)[1:]
    info = np.iinfo(frame.dtype) if np.issubdtype(frame.dtype, np.integer) else None
    if info is not None:
        stats = np.clip(stats, info.min, info.max)
    return stats.astype(frame.dtype)


def l4_centroids(labels: np.ndarray, frame: np.ndarray, num_features: int,
                 scheme: str = "weighted_average") -> np.ndarray:
    """Per-puddle (row, col) centroids, puddle order = label order.

    Correct implementation of the semantics of ``get_centroids_2D_nb``
    (converters.py:157-259, whose scheme dispatch is defective: all branches
    test 'weighted_average').  Schemes: 'weighted_average' (intensity-weighted
    mean position), 'unweighted' (mean position), 'max' (position of the first
    maximum-intensity pixel in raster order).
    """
    if num_features == 0:
        return np.zeros((0, 2), dtype=np.float64)
    ny, nx = frame.shape
    index = np.arange(1, num_features + 1)
    rows, cols = np.mgrid[0:ny, 0:nx]
    if scheme == "weighted_average":
        w = frame.astype(np.float64)
        wsum = nd.sum_labels(w, labels=labels, index=index)
        r = nd.sum_labels(w * rows, labels=labels, index=index) / wsum
        c = nd.sum_labels(w * cols, labels=labels, index=index) / wsum
    elif scheme == "unweighted":
        count = nd.sum_labels(np.ones_like(frame, dtype=np.float64), labels=labels, index=index)
        r = nd.sum_labels(rows.astype(np.float64), labels=labels, index=index) / count
        c = nd.sum_labels(cols.astype(np.float64), labels=labels, index=index) / count
    elif scheme == "max":
        flat_labels = labels.reshape(-1)
        flat_vals = frame.reshape(-1)
        # first raster-order argmax per puddle
        vmax = nd.maximum(frame, labels=labels, index=index)
        lin = np.arange(flat_vals.size)
        r = np.empty(num_features, dtype=np.float64)
        c = np.empty(num_features, dtype=np.float64)
        is_max = flat_vals == np.asarray(vmax)[np.clip(flat_labels - 1, 0, num_features - 1)]
        is_max &= flat_labels > 0
        cand = np.where(is_max, lin, flat_vals.size)
        first = nd.minimum(cand, labels=flat_labels, index=index)
        first = np.asarray(first, dtype=np.int64)
        r = (first // nx).astype(np.float64)
        c = (first % nx).astype(np.float64)
    else:
        raise ValueError(f"Unknown centroiding scheme: {scheme}")
    return np.stack([r, c], axis=1)


def l4_centroid_pixels(labels: np.ndarray, frame: np.ndarray, num_features: int,
                       scheme: str = "weighted_average") -> np.ndarray:
    """Rounded centroid pixel (row, col) per puddle via exact integer math.

    Mirrors ops.segment.l4_centroid_pixels: integer sums + round-half-even
    division, so the encoded L4 bitmap is identical across CPU oracle and TPU
    kernels (float division would differ in the last ulp near .5).
    """
    if num_features == 0:
        return np.zeros((0, 2), dtype=np.int64)
    ny, nx = frame.shape
    index = np.arange(1, num_features + 1)
    rows, cols = np.mgrid[0:ny, 0:nx]
    if scheme in ("weighted_average", "unweighted"):
        w = frame.astype(np.uint64) if scheme == "weighted_average" else np.ones_like(frame, dtype=np.uint64)
        wsum = np.asarray(nd.sum_labels(w, labels=labels, index=index)).astype(np.uint64)
        rsum = np.asarray(nd.sum_labels(w * rows, labels=labels, index=index)).astype(np.uint64)
        csum = np.asarray(nd.sum_labels(w * cols, labels=labels, index=index)).astype(np.uint64)

        def round_div(num, den):
            den = np.maximum(den, 1)
            q = num // den
            rem = num - q * den
            down = den - rem
            up = (rem > down) | ((rem == down) & (q % 2 == 1))
            return (q + up).astype(np.int64)

        return np.stack([round_div(rsum, wsum), round_div(csum, wsum)], axis=1)
    if scheme == "max":
        c = l4_centroids(labels, frame, num_features, "max")
        return c.astype(np.int64)
    raise ValueError(f"Unknown centroiding scheme: {scheme}")


def centroids_to_binary_map(centroids: np.ndarray, ny: int, nx: int) -> np.ndarray:
    """Rasterize rounded centroids into a boolean (ny, nx) map.

    Correct version of ``make_binary_map`` (converters.py:300-309, which
    allocates a 2-element vector instead of an (nx, ny) map).  Uses numpy's
    round-half-to-even like the offline converter (converters.py:92).
    """
    out = np.zeros((ny, nx), dtype=bool)
    if centroids.size:
        r = np.clip(np.round(centroids[:, 0]).astype(np.int64), 0, ny - 1)
        c = np.clip(np.round(centroids[:, 1]).astype(np.int64), 0, nx - 1)
        out[r, c] = True
    return out


# ---------------------------------------------------------------------------
# frame encode (reduction + packing, no entropy stage)
# ---------------------------------------------------------------------------

def reduce_frame(frame: np.ndarray, threshold: np.ndarray, reduction_level: int,
                 bit_depth: int, l2_statistic: str = "max",
                 l4_scheme: str = "weighted_average") -> dict:
    """Reduce one frame; returns packed streams ready for the container.

    Returns a dict with keys:
      ``packed_binary_map`` (bytes), ``packed_pixvals`` (bytes or None),
      ``n_foreground`` (int), ``mask`` (bool ndarray, pre-centroiding for L4
      dose statistics).
    """
    mask = threshold_frame(frame, threshold)
    packed_pixvals = None
    n_fg = int(mask.sum())

    if reduction_level == 1:
        vals = l1_residuals(frame, threshold, mask)
        packed_pixvals = bit_pack(vals, bit_depth) if bit_depth % 8 else vals.tobytes()
        bitmap_mask = mask
    elif reduction_level == 2:
        labels, num = label_components(mask)
        # per reference semantics stats are over raw frame values
        # (recode_writer.py:446 passes `frame`, not the residual)
        stats = l2_summary_stats(labels, frame, num, l2_statistic)
        # saturate at the declared bit depth: bit-packing would otherwise
        # silently truncate high bits of large puddle sums
        if np.issubdtype(stats.dtype, np.integer) and bit_depth < 64:
            stats = np.minimum(stats, (1 << bit_depth) - 1).astype(stats.dtype)
        packed_pixvals = bit_pack(stats, bit_depth) if bit_depth % 8 else stats.tobytes()
        bitmap_mask = mask
    elif reduction_level == 3:
        bitmap_mask = mask
    elif reduction_level == 4:
        labels, num = label_components(mask)
        pixels = l4_centroid_pixels(labels, frame, num, l4_scheme)
        bitmap_mask = np.zeros(frame.shape, dtype=bool)
        if pixels.size:
            r = np.clip(pixels[:, 0], 0, frame.shape[0] - 1)
            c = np.clip(pixels[:, 1], 0, frame.shape[1] - 1)
            bitmap_mask[r, c] = True
    else:
        raise ValueError(f"Unknown reduction level: {reduction_level}")

    return {
        "packed_binary_map": pack_binary_frame(bitmap_mask).tobytes(),
        "packed_pixvals": bytes(packed_pixvals) if packed_pixvals is not None else None,
        "n_foreground": n_fg,
        "mask": mask,
    }


# ---------------------------------------------------------------------------
# frame decode
# ---------------------------------------------------------------------------

def decode_frame_sparse(packed_binary_map: bytes, packed_pixvals: Optional[bytes],
                        ny: int, nx: int, bit_depth: int, reduction_level: int,
                        dtype=np.uint16) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode packed streams to sparse (rows, cols, values) triplets.

    Semantics of the C decode hot loop ``_unpack_frame_sparse``
    (reader.h:10-68): scan the bitmap row-major; for L1 each set bit consumes
    the next ``bit_depth``-bit intensity, otherwise the value is 1.
    """
    mask = unpack_binary_frame(packed_binary_map, ny * nx)
    idx = np.flatnonzero(mask)
    rows = (idx // nx).astype(np.uint64)
    cols = (idx % nx).astype(np.uint64)
    if reduction_level == 1:
        if bit_depth % 8:
            vals = bit_unpack(packed_pixvals, bit_depth, idx.size, dtype=dtype)
        else:
            itemsize = np.dtype(dtype).itemsize
            vals = np.frombuffer(packed_pixvals[: idx.size * itemsize], dtype=dtype).copy()
    else:
        vals = np.ones(idx.size, dtype=dtype)
    return rows, cols, vals


def decode_summary_stats(packed: bytes, bit_depth: int, n_values: int, dtype=np.uint16) -> np.ndarray:
    """Decode an L2 per-puddle summary-stat stream."""
    if bit_depth % 8:
        return bit_unpack(packed, bit_depth, n_values, dtype=dtype)
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer(packed[: n_values * itemsize], dtype=dtype).copy()


# ---------------------------------------------------------------------------
# synthetic fixtures
# ---------------------------------------------------------------------------

def synthetic_frames(n: int, height: int, width: int, occupancy: float = 0.01,
                     bit_depth: int = 12, distribution: str = "peaked",
                     scale: float = 6.0, rng=None) -> np.ndarray:
    """Synthetic post-threshold detector frames (residuals on a zero dark).

    ``distribution="peaked"`` draws foreground residuals from
    ``min(1 + floor(Exp(scale)), 2^bit_depth - 1)`` — the single-electron
    regime the codec is built for (Datta et al. 2021: sparse puddles whose
    dark-subtracted intensities decay fast from small values), which is what
    makes the pixel-value stream entropy-codable.  ``"uniform"`` draws
    uniformly over the full bit range (incompressible pixvals; stresses the
    stored-block path).  Returns (n, height, width) uint16.
    """
    rng = np.random.default_rng(rng)
    shape = (n, height, width)
    mask = rng.random(shape) < occupancy
    top = (1 << bit_depth) - 1
    if distribution == "peaked":
        vals = 1 + np.floor(rng.exponential(scale, shape)).astype(np.int64)
        vals = np.minimum(vals, top)
    elif distribution == "uniform":
        vals = rng.integers(1, top + 1, shape)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    return np.where(mask, vals, 0).astype(np.uint16)
