"""Stream compaction: gather masked elements to a dense, zero-padded prefix.

Port of pyrecode_tpu/ops/compact.py (``method="scatter"``): positions from
an inclusive cumsum of the mask, one scatter into a max-bound buffer, the
true count returned beside it.  The plain twins of the kernels that compact
(the L1 encode's values and positions, the bitmap -> positions kernel) place
their results at each element's rank with it.
"""

from __future__ import annotations

import torch


def stream_compact(values: torch.Tensor, mask: torch.Tensor, out_size: int):
    """Compact ``values[mask]`` (row-major order along the last axis) into a
    buffer of ``out_size``, zero beyond the count.

    Elements past ``out_size`` are dropped; the returned count (int32, one
    per row) still reports the true total, so callers can detect overflow.
    """
    mask = mask.to(torch.bool)
    count = mask.sum(dim=-1, dtype=torch.int32)
    lead = values.shape[:-1]
    flat_vals = values.reshape(-1, values.shape[-1])
    flat_mask = mask.reshape(-1, mask.shape[-1])
    pos = torch.cumsum(flat_mask, dim=-1) - 1
    # background and overflowing elements go to a dump column, cut off below
    idx = torch.where(flat_mask & (pos < out_size), pos, out_size)
    out = torch.zeros((flat_vals.shape[0], out_size + 1), dtype=values.dtype,
                      device=values.device)
    out.scatter_(1, idx, flat_vals)
    return out[:, :out_size].contiguous().reshape(*lead, out_size), count
