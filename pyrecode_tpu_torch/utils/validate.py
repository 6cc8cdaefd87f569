"""Validation-frame verification (the port of pyrecode_tpu/utils/validate.py).

The writer archives every ``validation_frame_gap``-th raw frame next to the
compressed stream (reference recode_writer.py:206-210, 402-405) so decoded
output can be diffed against ground truth after the fact.  The reference
stores the frames but ships no checker; this closes that loop (SURVEY.md §4
"validation-frame subsystem doubles as online self-test").
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..reader import ReCoDeReader


def load_validation_frames(path: str, ny: int, nx: int, dtype=np.uint16) -> np.ndarray:
    """Load a ``*_validation_frames.bin`` file written by the writer."""
    raw = np.fromfile(path, dtype=dtype)
    return raw.reshape(-1, ny, nx)


def verify_against_validation_frames(recode_file: str, validation_file: str,
                                     validation_frame_gap: int,
                                     dark: Optional[np.ndarray] = None,
                                     epsilon: int = 0,
                                     frame_offset: int = 0, device="cuda") -> dict:
    """Decode the container with the port's reader on ``device`` and
    compare against archived raw frames.

    For L1 with threshold ``dark + epsilon`` the decoded residuals must equal
    ``raw - threshold`` exactly on foreground pixels.  Returns a report dict
    with per-frame booleans and an overall flag.
    """
    reader = ReCoDeReader(recode_file, device=device)
    reader.open()
    nz, ny, nx = reader.get_shape()
    validation = load_validation_frames(validation_file, ny, nx)

    if dark is None:
        dark = np.zeros((ny, nx), dtype=validation.dtype)
    threshold = (dark.astype(np.int64) + epsilon).astype(validation.dtype)

    results = {}
    for k in range(validation.shape[0]):
        z = frame_offset + k * validation_frame_gap
        if z >= nz:
            break
        decoded = np.asarray(reader.get_frame(z)[z]["data"].todense())
        raw = validation[k]
        mask = raw > threshold
        expected = np.where(mask, raw - threshold, 0)
        results[z] = bool(np.array_equal(decoded, expected))
    reader.close()

    return {"frames": results, "all_match": all(results.values()) if results else False}
