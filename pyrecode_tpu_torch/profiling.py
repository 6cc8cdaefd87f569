"""Tracing and timing hooks on PyTorch.

Port of pyrecode_tpu/profiling.py:

* :func:`trace` — context manager around ``torch.profiler.profile`` with CPU
  and (where the build has them) CUDA activities; writes a Chrome trace
  (``*.pt.trace.json``, TensorBoard's layout) into ``log_dir``;
* :func:`annotate` — the program's span: while a ``torch.profiler``
  profile records anywhere in the process, a named region in the trace
  (``torch.profiler.record_function``) and a count and host seconds in a
  process-wide table (:func:`span_totals`, :func:`reset_span_totals`); with
  no profile recording, one flag check;
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
import threading
import time
from datetime import datetime, timedelta
from typing import Dict, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


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


# name -> [count, host seconds] of the spans closed while a profile recorded
_SPAN_TOTALS: Dict[str, list] = {}
_SPAN_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()


class _Span:
    """One region; see :func:`annotate`."""

    __slots__ = ("_name", "_args", "_traced", "_metrics", "_key", "_record", "_t0")

    def __init__(self, name, args, traced, metrics, key):
        self._name, self._args, self._traced = name, args, traced
        self._metrics, self._key = metrics, key
        self._record = None

    def __enter__(self):
        if self._traced:
            args = (None if self._args is None
                    else ", ".join(f"{k}={v}" for k, v in self._args.items()))
            self._record = torch.profiler.record_function(self._name, args)
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._record is not None:
            self._record.__exit__(*exc)
            with _SPAN_LOCK:
                entry = _SPAN_TOTALS.setdefault(self._name, [0, 0.0])
                entry[0] += 1
                entry[1] += seconds
        if self._metrics is not None:
            self._metrics[self._key] = (self._metrics.get(self._key, timedelta(0))
                                        + timedelta(seconds=seconds))
        return False


def annotate(name: str, args: Optional[dict] = None, metrics: Optional[dict] = None,
             key: Optional[str] = None):
    """The program's span: a context manager around one region.

    Tracing is on while a ``torch.profiler`` profile records in the process
    (from any thread), checked once on entry.  With tracing on, the region
    is a ``record_function`` named ``name`` (so it lies in the Chrome trace
    of a thread the profiler records, on the clock of the device's kernels
    and copies), with ``args`` (the identifiers that tie it to its request,
    e.g. ``{"session": ..., "node": ...}``) as its argument string; on exit
    its count and host seconds (``time.perf_counter``) are added to the
    table that :func:`span_totals` reads, also when the region raised.  With
    tracing off the span is that one check: no ``record_function``, no
    string, no lock.

    ``metrics`` and ``key``: a run-metrics dict whose ``timedelta`` entry
    ``key`` times the same region; the span's host time is added to it
    whether tracing is on or not, so the region's clock is read once.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF if metrics is None else _Span(name, None, False, metrics, key)
    return _Span(name, args, True, metrics, key)


def span_totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (count, host seconds)}`` of the spans closed while a
    profile recorded, since the last :func:`reset_span_totals`; summed over
    threads, so spans of concurrent threads add up to more than wall time."""
    with _SPAN_LOCK:
        return {name: (count, seconds) for name, (count, seconds) in _SPAN_TOTALS.items()}


def reset_span_totals() -> None:
    with _SPAN_LOCK:
        _SPAN_TOTALS.clear()


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
