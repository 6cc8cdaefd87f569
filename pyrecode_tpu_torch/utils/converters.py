"""Offline post-processing of decoded L1 sparse frames.

The port of pyrecode_tpu/utils/converters.py (capability parity with the
reference ``utils/converters.py``):

* ``recalibrate_l1`` — re-threshold decoded L1 frames against a new dark
  reference by adding ``old - (new + eps)`` in float64 with dtype clipping
  (converters.py:15-56);
* ``l1_to_l4_converter`` — connected-component label + centroid each frame,
  returning boolean COO centroid maps (converters.py:59-123), with the
  centroid-scheme dispatch fixed (the reference tests 'weighted_average' in
  every branch, converters.py:159-164);
* ``apply_DE16_common_mode_correction`` — per-256-column even/odd median
  subtraction (converters.py:320-325);
* ``read_dark_ref`` (converters.py:312-317);
* ``l1_to_l4_batch`` — whole frame batches through the fused L2/L4 label
  kernel (:func:`..ops.hopper_label.encode_l2l4`) with a zero threshold: the
  foreground is ``dense > 0`` and the centroid weights are the raw values.

The first four are host code on numpy, scipy and the port's oracle.
"""

from __future__ import annotations

import copy
from datetime import datetime
from typing import Optional

import numpy as np
import torch
from scipy.sparse import coo_matrix

from .. import oracle
from ..device import resolve_device
from ..ops.bitpack import unpack_bits
from ..ops.hopper_label import MODE_BY_CONFIG, encode_l2l4


def _deep_copy_frame_metadata(src, target, frame_id):
    target[frame_id] = {}
    for key, value in src[frame_id].items():
        if key != "data":
            target[frame_id][key] = copy.deepcopy(value)


def recalibrate_l1(l1_frames, n_frames=-1, original_calibration_frame=None,
                   new_calibration_frame=None, epsilon=0.0, in_place=False,
                   verbose=False):
    """Re-threshold decoded L1 frames with a new dark reference."""
    if n_frames < 1:
        n_frames = len(l1_frames)

    calibration_diff = original_calibration_frame.astype(np.float64) - (
        new_calibration_frame.astype(np.float64) + epsilon)

    first = next(iter(l1_frames))
    dtype = l1_frames[first]["data"].dtype
    if np.issubdtype(dtype, np.integer):
        lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    elif np.issubdtype(dtype, np.floating):
        lo, hi = np.finfo(dtype).min, np.finfo(dtype).max
    else:
        raise ValueError("Unknown kind of frame dtype. Expected 'u', 'i', or 'f'.")

    out = {}
    start = datetime.now()
    for frame_count, key in enumerate(l1_frames):
        dense = np.asarray(l1_frames[key]["data"].todense(), dtype=np.float64)
        was_foreground = dense > 0
        dense = dense + calibration_diff
        dense = np.clip(dense, lo, hi)
        dense[~was_foreground] = 0  # only previously-kept pixels carry signal
        dense[dense < 0] = 0
        recal = dense.astype(dtype)

        if in_place:
            out[key] = l1_frames[key]
        else:
            _deep_copy_frame_metadata(l1_frames, out, key)
        out[key]["data"] = coo_matrix(recal, dtype=dtype)

        if 0 < n_frames == frame_count:
            break
    if verbose:
        print("Total processing time:", datetime.now() - start)
    return out


def l1_to_l4_converter(l1_frames, frame_shape, n_frames=-1, area_threshold=0,
                       verbosity=0, method="weighted_average", in_place=False):
    """Convert decoded L1 frames to L4 centroid maps (boolean COO)."""
    max_dim = int(np.max(frame_shape))
    centroids_dtype = None
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_dim < np.iinfo(dt).max:
            centroids_dtype = dt
            break
    if centroids_dtype is None:
        raise ValueError("Unable to identify data type for centroids")

    n_pixels = float(frame_shape[0] * frame_shape[1])
    out = {}
    avg_dose_rate = 0.0
    start = datetime.now()

    for frame_count, key in enumerate(l1_frames):
        dense = np.asarray(l1_frames[key]["data"].todense())
        mask = dense > 0
        labels, num = oracle.label_components(mask)
        cents = oracle.l4_centroids(labels, dense, num, method)
        if area_threshold > 0 and num:
            areas = np.bincount(labels.reshape(-1), minlength=num + 1)[1:]
            cents = cents[areas > area_threshold]
        cents = np.round(cents).astype(centroids_dtype)

        if in_place:
            out[key] = l1_frames[key]
        else:
            _deep_copy_frame_metadata(l1_frames, out, key)

        if len(cents) > 0:
            ones = np.ones(len(cents), dtype=bool)
            out[key]["data"] = coo_matrix(
                (ones, (cents[:, 0], cents[:, 1])),
                shape=(frame_shape[0], frame_shape[1]), dtype=bool)
        else:
            out[key]["data"] = coo_matrix((frame_shape[0], frame_shape[1]), dtype=bool)

        if verbosity > 0:
            print(key, "Dose Rate =", num / n_pixels)
        else:
            avg_dose_rate += num / n_pixels
        if 0 < n_frames == frame_count:
            break

    if verbosity > 0:
        print("Total processing time:", datetime.now() - start)
    return out


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


def read_dark_ref(fname, shape, dtype):
    """Load a raw binary dark reference (converters.py:312-317)."""
    with open(fname, "rb") as binary_file:
        data = binary_file.read()
    return np.frombuffer(data, dtype=dtype, count=shape[0] * shape[1]).reshape(shape)


def apply_DE16_common_mode_correction(frame: np.ndarray) -> np.ndarray:
    """DE-16 per-256-column-block even/odd median subtraction
    (converters.py:320-325)."""
    corrected = frame.astype(np.float64).copy()
    for c in range(0, frame.shape[1], 256):
        even = corrected[:, c:c + 256:2]
        odd = corrected[:, c + 1:c + 256:2]
        corrected[:, c:c + 256:2] = even - np.median(even)
        corrected[:, c + 1:c + 256:2] = odd - np.median(odd)
    return corrected.astype(frame.dtype) if np.issubdtype(frame.dtype, np.floating) \
        else corrected
