"""What the probes share: devices, device times, byte bounds, comparisons."""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..profiling import cuda_event_time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)
OUTER = 3                   # timed runs of ``reps`` launches; their median is kept
SEED = 0                    # numpy seed of the phase probes' frames


def device_of(name) -> torch.device:
    """The probe's device: "cuda" (the default; raises without CUDA) or "cpu"
    (the plain twins, no times)."""
    return resolve_device(name)


def device_ms(fn, device: torch.device, reps: int) -> Optional[float]:
    """CUDA-event ms of one call of ``fn`` on the card; None on the CPU."""
    if device.type != "cuda":
        return None
    return cuda_event_time(fn, reps, OUTER)


@contextlib.contextmanager
def full_fp32():
    """float32 products in full float32 on the card (no TF32) inside the
    block; the setting is restored after it."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def fmt_ms(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes: int) -> float:
    """The least time the card could take to move n_bytes, in ms."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def as_i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    if t.dtype == torch.float32:
        return t.view(torch.int32).to(torch.int64)   # bit patterns: equal means bit-equal
    return t.to(torch.int64)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired outputs (float32 compared by bit
    pattern); raises on a shape mismatch."""
    worst = 0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if tuple(g.shape) != tuple(w.shape):
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((as_i64(g) - as_i64(w)).abs().max()))
    return worst


def sparse_batch(batch: int, size: int, occupancy: float):
    """(frames (batch, size, size) uint16, threshold zeros (size, size)
    uint16): each pixel foreground with p = occupancy, its value uniform in
    1..4095, as the JAX phase probes build theirs (from numpy's generator)."""
    rng = np.random.default_rng(SEED)
    fg = rng.random((batch, size, size), dtype=np.float32) < occupancy
    frames = np.zeros((batch, size, size), np.uint16)
    frames[fg] = rng.integers(1, 4096, int(fg.sum()), dtype=np.uint16)
    return frames, np.zeros((size, size), np.uint16)
