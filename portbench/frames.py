"""The one frame generator: detector frames made on the device from a seed.

A traffic file's ``frames`` object sets the model, and nothing else does:

* ``dark_max``: the per-pixel dark level is uniform in 0..dark_max;
* the background stays at or below dark + epsilon (uniform in dark..dark+epsilon);
* an electron lands at each of ``events_per_frame`` uniform centres a 4096^2
  frame (scaled to the frame's area); each of the centre's eight neighbours
  joins its puddle with ``neighbour_p``, so 0.3 gives puddles of 1-9 pixels
  that sometimes merge;
* a foreground pixel reads dark + epsilon + 1 + floor(Exp(``excess_mean``)),
  clipped to the bit depth.

Every seed draws the same sizes; only the positions and values change.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 8   # frames generated a call: a few large calls, little device memory


def make(model: dict, n: int, height: int, width: int, bit_depth: int, epsilon: int,
         seed: int, device: torch.device):
    """Returns (frames (n, h, w) uint16 numpy, dark (h, w) uint16 numpy,
    foreground counts (n,) int64 numpy)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    top = (1 << bit_depth) - 1
    dark = torch.randint(0, int(model["dark_max"]) + 1, (height, width), generator=gen,
                         device=device, dtype=torch.int32)
    thr = dark + epsilon
    frames = np.empty((n, height, width), dtype=np.uint16)
    counts = np.empty(n, dtype=np.int64)
    host = torch.from_numpy(frames.view(np.int16))
    for start in range(0, n, CHUNK):
        c = min(CHUNK, n - start)
        fg = _foreground(model, c, height, width, gen, device)
        excess = torch.empty((c, height, width), device=device).exponential_(
            1.0 / float(model["excess_mean"]), generator=gen)
        background = dark + torch.randint(0, epsilon + 1, (c, height, width), generator=gen,
                                          device=device, dtype=torch.int32)
        hit = torch.clamp(thr + 1 + excess.floor().to(torch.int32), max=top)
        chunk = torch.where(fg, hit, background)
        counts[start:start + c] = (chunk > thr).sum(dim=(1, 2)).cpu().numpy()
        host[start:start + c].copy_(chunk.to(torch.int16))
        del fg, excess, background, hit, chunk
    return frames, dark.to(torch.int16).cpu().numpy().view(np.uint16), counts


def _foreground(model: dict, c: int, height: int, width: int, gen, device) -> torch.Tensor:
    p = float(model["neighbour_p"])
    k = max(1, round(float(model["events_per_frame"]) * height * width / 4096 ** 2))
    rows = torch.randint(0, height, (c, k), generator=gen, device=device).reshape(-1)
    cols = torch.randint(0, width, (c, k), generator=gen, device=device).reshape(-1)
    frame_ids = torch.arange(c, device=device).repeat_interleave(k)
    fg = torch.zeros(c * height * width, dtype=torch.bool, device=device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            keep = torch.rand(rows.shape, generator=gen, device=device) \
                < (1.0 if dr == dc == 0 else p)
            r, q = rows + dr, cols + dc
            keep &= (r >= 0) & (r < height) & (q >= 0) & (q < width)
            fg[((frame_ids * height + r) * width + q)[keep]] = True
    return fg.reshape(c, height, width)
