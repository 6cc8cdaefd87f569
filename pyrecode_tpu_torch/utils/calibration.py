"""Calibration tool: per-pixel thresholds from flat-field frames.

The port of pyrecode_tpu/utils/calibration.py (capability parity with the
reference ``utils/calibration.py``): ``make_calibration_frames`` computes the
per-pixel median and std over a flat-field stack, fits a global Gaussian
sigma to the zero-centered intensity histogram (calibration.py:60-84), emits
threshold frames ``floor(median + i*sigma)`` for i in 0..n_sigmas-1 with
dose-rate statistics per sigma (calibration.py:113-128), and optionally an
"accurate" per-pixel threshold from top-k order statistics
(``_get_pixel_thresh_2``, calibration.py:26-45).

The median, std and top-k sort over the time axis run in PyTorch on the
caller's device ("cuda" by default, "cpu" on the host), in float32 as the JAX
package computes them: the median of an even frame count is the mean of the
two middle values (``jnp.median``; ``torch.median`` would return the lower
one), taken from a ``torch.sort`` because ``torch.quantile`` refuses inputs
above 2^24 elements; the std is the population std.  The histogram
curve-fit and the event counts stay on the host (scipy).
"""

from __future__ import annotations

import os
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

try:
    from scipy.optimize import curve_fit
except ImportError:  # pragma: no cover
    curve_fit = None

from ..constants import rc_cfg as rc
from ..device import resolve_device
from ..oracle import label_components


def _stack_on(frames, device) -> torch.Tensor:
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    return frames.to(resolve_device(device)).float()


def pixel_median_std(frames: np.ndarray, device="cuda"):
    """Per-pixel median and population std over the time axis, float32
    numpy arrays.  ``frames`` is a (T, H, W) numpy array or tensor.

    Replaces the numba ``_median_std_nb`` pixel loop (calibration.py:48-57).
    """
    d = _stack_on(frames, device)
    n = d.shape[0]
    ordered = torch.sort(d, dim=0).values
    med = ordered[n // 2] if n % 2 else (ordered[n // 2 - 1] + ordered[n // 2]) * 0.5
    del ordered
    std = torch.std(d, dim=0, correction=0)
    return med.cpu().numpy(), std.cpu().numpy()


def _gaussian(x, a, x0, sigma):
    return a * np.exp(-((x - x0) ** 2) / (2 * sigma ** 2))


def fit_global_sigma(frames: np.ndarray, median: np.ndarray, n_stats_frames: int) -> float:
    """Gaussian-fit sigma of the zero-centered intensity histogram
    (calibration.py:60-84)."""
    stats = frames[-n_stats_frames:].astype(np.float64) - median[None].astype(np.float64)
    hist, edges = np.histogram(stats.reshape(-1), bins=100, density=False)
    centers = (edges[:-1] + edges[1:]) / 2
    hn = hist / np.sum(hist)
    mean = np.average(centers, weights=hn)
    sigma = np.sqrt(np.average((centers - mean) ** 2, weights=hn))
    if curve_fit is None:
        return float(sigma)
    p0 = [np.max(hn), mean, sigma]
    popt, _ = curve_fit(_gaussian, centers, hn, p0=p0)
    return float(abs(popt[2]))


def count_events(frame: np.ndarray, threshold: np.ndarray):
    """(number of 8-connected events, number of foreground pixels)."""
    mask = frame > threshold
    _, num = label_components(mask)
    return num, int(mask.sum())


def accurate_pixel_thresholds(frames: np.ndarray, base_threshold: np.ndarray,
                              expected_n_events: int, device="cuda") -> np.ndarray:
    """Per-pixel threshold between the (k+1)-th and k-th largest
    above-baseline values (``_get_pixel_thresh_2`` semantics,
    calibration.py:26-45), as a sort over time on the device.  Pixels with
    fewer than k+1 values above the baseline keep the baseline.  ``frames``
    (T, H, W) and ``base_threshold`` (H, W) are numpy arrays or tensors."""
    d = _stack_on(frames, device)
    base = torch.as_tensor(base_threshold, dtype=torch.float32, device=d.device)
    masked = torch.where(d > base[None], d, float("-inf"))
    del d
    # descending over time; the -inf of masked-out values sorts last
    top = -torch.sort(-masked, dim=0).values
    del masked
    # the (k+1)-th largest requires k < nFrames
    k = min(expected_n_events, frames.shape[0] - 1)
    acc = (top[k] + top[k - 1]) / 2.0
    acc = torch.where(torch.isfinite(acc), acc, base)
    return acc.cpu().numpy()


def make_calibration_frames(filepath, dtype, nFrames, n_stats_frames, n_sigmas,
                            savepath="", filename_prefix="", use_acc=False,
                            sigma_acc=-1, frames=None, source_file_type=rc.FILE_TYPE_SEQ,
                            verbose=True, device="cuda"):
    """Produce calibration threshold frames from flat-field data.

    ``frames`` may be passed directly; otherwise ``filepath`` is opened with
    the EM readers (SEQ or MRC).  ``device`` runs the per-pixel median, std
    and sort ("cuda" or "cpu").  Returns a dict with
    median/std/sigma/thresholds/statistics.
    """
    start = datetime.now()
    if frames is None:
        from ..em_reader import emfile

        with emfile(str(Path(filepath)), source_file_type) as fp:
            frames = np.stack([np.squeeze(np.asarray(fp[i])) for i in range(nFrames)])
    frames = np.asarray(frames[:nFrames], dtype=dtype)

    if filename_prefix and not filename_prefix.endswith("_"):
        filename_prefix += "_"

    median, stds = pixel_median_std(frames, device)
    fit_std = fit_global_sigma(frames, median, n_stats_frames)
    if verbose:
        print("Avg. std.dev. per pixel:", float(np.average(stds)))
        print("Global intensity std. dev.:", fit_std)
        print("Calibration time:", datetime.now() - start)

    ny, nx = frames.shape[1:]
    n_pixels = nx * ny
    result = {"median": median, "std": stds, "sigma": fit_std,
              "thresholds": {}, "statistics": {}}

    for i in range(n_sigmas):
        t = np.floor(median + fit_std * i).astype(dtype)
        result["thresholds"][i] = t
        if savepath:
            t.astype(dtype).tofile(
                os.path.join(savepath, f"{filename_prefix}_dark_ref_{i}.bin"))

        n_events = 0
        p_foreground = 0.0
        for f in range(nFrames - n_stats_frames, nFrames):
            n_e, n_fp = count_events(frames[f], t)
            n_events += n_e
            p_foreground += n_fp / n_pixels
        avg_events = n_events / n_stats_frames
        stats = {
            "avg_foreground_fraction": p_foreground / n_stats_frames,
            "avg_electron_count": avg_events,
            "avg_dose_rate": avg_events / n_pixels,
        }
        result["statistics"][i] = stats
        if verbose:
            print(f"sigma={i}: fg={stats['avg_foreground_fraction']:.5f} "
                  f"events={stats['avg_electron_count']:.1f} "
                  f"dose={stats['avg_dose_rate']:.6f}")

        if use_acc and i == sigma_acc:
            expected = int(np.ceil(nFrames * stats["avg_dose_rate"]))
            if expected < 2:
                if verbose:
                    print("Unable to compute accurate thresholds: too few events in dataset")
            else:
                acc_t = accurate_pixel_thresholds(frames, median, expected, device)
                result["thresholds"][f"{i}A"] = acc_t
                if savepath:
                    acc_t.astype(dtype).tofile(
                        os.path.join(savepath, f"{filename_prefix}_dark_ref_{i}A.bin"))

    return result
