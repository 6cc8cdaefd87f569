"""Backscattering estimation for fine detector calibration.

Re-implements the analysis of the reference's fine-calibration workflow
(examples/Fine_Calibration_with_Backscattering.ipynb, "Estimating
backscattering"): simulate primary + backscattered electron events per
frame, compare nearest-neighbor distance distributions against the observed
events with a two-sample Kolmogorov-Smirnov statistic, sweep the
primary-to-backscattered ratio and the exponential distance scale, and
combine repeated simulations with Fisher's method.

The port of pyrecode_tpu/utils/backscatter.py.  The nearest-neighbor
distances (the hot loop when sweeping hundreds of simulations over
thousands of frames) run batched in PyTorch on the device, in float32 as the
JAX package computes them: frames are padded to a fixed event capacity and
the pairwise-distance min reduces over a (B, cap, cap) tensor; everything
else is O(parameters) host work in numpy.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "simulate_events",
    "nn_distances",
    "nn_distances_batch",
    "ks_statistic",
    "sweep_backscatter_params",
    "fisher_combined",
]


def simulate_events(n_events: Sequence[int], ratio: float, scale: float,
                    shape: Tuple[int, int], shift: float = 0.0,
                    rng: Optional[np.random.Generator] = None):
    """Simulate per-frame event coordinates with backscattering.

    ``n_events[i]`` — total events in frame i.  ``ratio`` — primary to
    backscattered count ratio (ratio r => n/(1+1/r) primaries).  Each
    backscattered event sits at an exponential(scale)+shift distance from a
    randomly chosen primary, in a uniform direction (the notebook's model).
    Returns a list of (n_i, 2) float arrays (row, col), clipped to ``shape``.
    """
    rng = rng or np.random.default_rng()
    H, W = shape
    frames = []
    for n in n_events:
        n = int(n)
        n_back = int(round(n / (1.0 + ratio)))
        n_prim = n - n_back
        prim = np.column_stack([rng.uniform(0, H, n_prim),
                                rng.uniform(0, W, n_prim)])
        if n_back and n_prim:
            src = prim[rng.integers(0, n_prim, n_back)]
            dist = rng.exponential(scale, n_back) + shift
            theta = rng.uniform(0, 2 * np.pi, n_back)
            back = src + np.column_stack([dist * np.sin(theta),
                                          dist * np.cos(theta)])
            back[:, 0] = np.clip(back[:, 0], 0.0, np.nextafter(float(H), 0.0))
            back[:, 1] = np.clip(back[:, 1], 0.0, np.nextafter(float(W), 0.0))
            coords = np.concatenate([prim, back])
        else:
            coords = prim
        frames.append(coords)
    return frames


def nn_distances(coords: np.ndarray) -> np.ndarray:
    """Nearest-neighbor distance per event within one frame (numpy)."""
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    if n < 2:
        return np.zeros(0)
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sqrt(d2.min(axis=1))


def _pad_frames(frames, cap):
    B = len(frames)
    out = np.full((B, cap, 2), np.nan, np.float32)
    counts = np.zeros(B, np.int32)
    for i, c in enumerate(frames):
        n = min(len(c), cap)
        out[i, :n] = c[:n]
        counts[i] = n
    return out, counts


def nn_distances_batch(frames, cap: Optional[int] = None, device="cuda") -> np.ndarray:
    """Nearest-neighbor distances for a batch of frames on the device.

    ``frames`` — list of (n_i, 2) coordinate arrays.  Frames are padded to
    ``cap`` events (default: max n_i) and the (B, cap, cap) pairwise
    distances reduce on ``device`` in float32.  Returns the concatenated
    valid distances (same multiset as mapping :func:`nn_distances` over
    frames).
    """
    if not frames:
        return np.zeros(0)
    cap = int(cap or max((len(c) for c in frames), default=0))
    if cap < 2:
        return np.zeros(0)
    padded, counts = _pad_frames(frames, cap)
    p = torch.from_numpy(padded).to(resolve_device(device))
    x = torch.nan_to_num(p, nan=1e9)
    valid = ~torch.isnan(p[..., 0])
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    eye = torch.eye(cap, dtype=torch.bool, device=p.device)[None]
    pairs = valid[:, :, None] & valid[:, None, :] & ~eye
    d2 = torch.where(pairs, d2, float("inf"))
    dmat = torch.sqrt(d2.min(dim=2).values).cpu().numpy()
    keep = []
    for i, n in enumerate(counts):
        if n >= 2:
            keep.append(dmat[i, :n])
    return np.concatenate(keep) if keep else np.zeros(0)


def ks_statistic(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """Two-sample Kolmogorov-Smirnov (D, p) — the notebook's comparison.

    Uses scipy when present; otherwise the exact D with the asymptotic
    Kolmogorov p approximation.
    """
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    try:  # pragma: no cover - environment dependent
        from scipy.stats import ks_2samp

        r = ks_2samp(a, b)
        return float(r.statistic), float(r.pvalue)
    except Exception:
        pass
    allv = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, allv, side="right") / max(a.size, 1)
    cdf_b = np.searchsorted(b, allv, side="right") / max(b.size, 1)
    d = float(np.abs(cdf_a - cdf_b).max()) if allv.size else 0.0
    ne = a.size * b.size / max(a.size + b.size, 1)
    lam = (math.sqrt(ne) + 0.12 + 0.11 / math.sqrt(max(ne, 1e-9))) * d
    p = 2.0 * sum((-1) ** (k - 1) * math.exp(-2.0 * (lam * k) ** 2)
                  for k in range(1, 101))
    return d, float(min(max(p, 0.0), 1.0))


def fisher_combined(p_values: Sequence[float]) -> float:
    """Fisher's method: combined p-value over independent simulations."""
    p = np.clip(np.asarray(p_values, np.float64), 1e-300, 1.0)
    stat = -2.0 * np.log(p).sum()
    k = 2 * p.size
    try:  # pragma: no cover - environment dependent
        from scipy.stats import chi2

        return float(chi2.sf(stat, k))
    except Exception:
        # Wilson-Hilferty chi^2 approximation, adequate for ranking q-values
        z = ((stat / k) ** (1.0 / 3) - (1 - 2.0 / (9 * k))) / math.sqrt(
            2.0 / (9 * k))
        return float(0.5 * math.erfc(z / math.sqrt(2)))


def sweep_backscatter_params(observed_frames, ratios: Sequence[float],
                             scales: Sequence[float], shape: Tuple[int, int],
                             n_sims: int = 10, shift: float = 0.0,
                             rng: Optional[np.random.Generator] = None,
                             device=True) -> Dict:
    """Parameter sweep: which (ratio, scale) best explains the observed
    nearest-neighbor distance distribution?

    For each grid point, ``n_sims`` simulations are generated with the
    observed per-frame event counts, their pooled NN distances are compared
    to the observed pooled NN distances with the KS test, and the runs
    combine via Fisher's method.  Returns {'best': (ratio, scale),
    'D': (len(ratios), len(scales)) mean D grid, 'q': combined p grid}.

    ``device``: True takes the distances on "cuda", a device name ("cuda",
    "cpu") on that device, False maps :func:`nn_distances` over the frames
    in numpy.

    Mirrors the reference notebook's sweep (ratio 6..13 step 0.1, exponential
    scale sweep, 100 runs, Fisher-combined q) at configurable resolution.
    """
    rng = rng or np.random.default_rng(0)
    if device is False:
        def nn_fn(fs):
            return np.concatenate([nn_distances(c) for c in fs]) if fs else np.zeros(0)
    else:
        target = "cuda" if device is True else device

        def nn_fn(fs):
            return nn_distances_batch(fs, device=target)
    obs = nn_fn(observed_frames)
    counts = [len(c) for c in observed_frames]
    D = np.zeros((len(ratios), len(scales)))
    Q = np.zeros_like(D)
    for i, r in enumerate(ratios):
        for j, s in enumerate(scales):
            ds, ps = [], []
            for _ in range(n_sims):
                sim = simulate_events(counts, r, s, shape, shift=shift,
                                      rng=rng)
                d, p = ks_statistic(obs, nn_fn(sim))
                ds.append(d)
                ps.append(p)
            D[i, j] = float(np.mean(ds))
            Q[i, j] = fisher_combined(ps)
    bi, bj = np.unravel_index(np.argmin(D), D.shape)
    return {"best": (float(ratios[bi]), float(scales[bj])), "D": D, "q": Q}
