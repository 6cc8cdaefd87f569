"""Small file helpers (capability parity with reference fileutils.py:4-8).

The port's own copy of pyrecode_tpu/fileutils.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np


def read_file(fileid, n_rows: int, n_cols: int, dtype) -> np.ndarray:
    """Read a raw binary 2-D array (row-major) from a file."""
    with open(fileid, "rb") as f:
        flat = np.frombuffer(f.read(), dtype=dtype)
    return flat.reshape((n_rows, n_cols))
