"""Tracing and timing hooks on PyTorch.

Port of pyrecode_tpu/profiling.py:

* :func:`trace` — context manager around ``torch.profiler.profile`` with CPU
  and (where the build has them) CUDA activities; writes a Chrome trace
  (``*.pt.trace.json``, TensorBoard's layout) into ``log_dir``;
* :func:`annotate` — ``torch.profiler.record_function``, so that a region
  shows up named inside traces;
* :class:`StageTimer` — named wall-clock stages accumulated into a
  reference-shaped metrics dict (timedelta values), as the JAX package's;
* :func:`cuda_event_time` — the counterpart of ``delta_scan_time``: the
  device time of one launch from CUDA events around queued launches.

``enable_compile_cache`` has no counterpart: it turns on XLA's persistent
compilation cache, and PyTorch runs eagerly while the port's kernels are
built once per checkout by ``ops/_build.py``.
"""

from __future__ import annotations

import contextlib
from datetime import datetime, timedelta
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host and device profiler trace of the enclosed region
    into ``log_dir`` (created if missing)."""
    wanted = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    activities = [a for a in wanted if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                                    str(log_dir))):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Name the enclosed region inside profiler traces."""
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Accumulate named wall-clock stages, reference-metrics shaped."""

    def __init__(self, metrics: Optional[Dict[str, timedelta]] = None):
        self.metrics: Dict[str, timedelta] = metrics if metrics is not None else {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = datetime.now()
        try:
            yield
        finally:
            elapsed = datetime.now() - start
            self.metrics[name] = self.metrics.get(name, timedelta(0)) + elapsed

    def as_seconds(self) -> Dict[str, float]:
        return {k: v.total_seconds() for k, v in self.metrics.items()
                if isinstance(v, timedelta)}


def cuda_event_time(fn, reps: int = 20, outer: int = 3) -> float:
    """Device milliseconds of one call of ``fn`` (which launches on the
    current CUDA stream): one warm-up call, then ``reps`` calls queued
    between two CUDA events, their elapsed time over ``reps``; the median
    of ``outer`` such runs.  Raises without CUDA: a host clock is no device
    time."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_event_time needs CUDA: torch.cuda.is_available() is False")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(outer):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]
