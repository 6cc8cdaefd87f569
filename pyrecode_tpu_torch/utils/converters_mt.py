"""Parallel offline L1 -> L4 conversion over many frames.

Capability parity with the reference ``utils/converters_mt.py``: ``L1_to_L4``
converts a range of decoded frames; ``L1_to_L4_mt`` fans the frame range out
(``np.array_split``) and collects results in order (converters_mt.py:45-79).

The port of pyrecode_tpu/utils/converters_mt.py: the reference forks one OS
process per split and runs numba pixel loops; here each split is a device
batch through the fused L2/L4 label kernel (``l1_to_l4_batch``), and the
splits run on a thread pool that overlaps the host-side densify/sparsify
with device work.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np
from scipy.sparse import coo_matrix

from .converters import l1_to_l4_batch


def L1_to_L4(l1_frames: Dict[int, dict], frame_shape, frame_ids: Sequence[int] = None,
             method: str = "weighted_average", batch_size: int = 32,
             device="cuda") -> Dict[int, dict]:
    """Convert the given frames (ids default to all) to L4 centroid maps on
    ``device`` ("cuda" or "cpu")."""
    if frame_ids is None:
        frame_ids = sorted(l1_frames.keys())
    out: Dict[int, dict] = {}
    ids = list(frame_ids)
    for start in range(0, len(ids), batch_size):
        chunk_ids = ids[start:start + batch_size]
        dense = np.stack([
            np.asarray(l1_frames[i]["data"].todense()) for i in chunk_ids
        ])
        cmasks = l1_to_l4_batch(dense, method=method, device=device)
        for i, frame_id in enumerate(chunk_ids):
            rows, cols = np.nonzero(cmasks[i])
            data = coo_matrix((np.ones(rows.size, dtype=bool), (rows, cols)),
                              shape=tuple(frame_shape), dtype=bool)
            out[frame_id] = {"metadata": l1_frames[frame_id].get("metadata"),
                             "data": data}
    return out


def L1_to_L4_mt(l1_frames: Dict[int, dict], frame_shape, n_workers: int = 4,
                method: str = "weighted_average", batch_size: int = 32,
                device="cuda") -> Dict[int, dict]:
    """Fan the frame range over a worker pool; results merged in frame order."""
    ids = sorted(l1_frames.keys())
    splits: List[np.ndarray] = [s for s in np.array_split(ids, n_workers) if s.size]

    def work(split):
        return L1_to_L4(l1_frames, frame_shape, frame_ids=list(split),
                        method=method, batch_size=batch_size, device=device)

    out: Dict[int, dict] = {}
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        for result in pool.map(work, splits):
            out.update(result)
    return dict(sorted(out.items()))
