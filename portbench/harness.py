"""One run of one cell: set-up, the measured window, the check, the metrics.

The program under test is ``pyrecode_tpu_torch``; this module drives it
through the cell's call pattern and takes only its outputs, its launch
counters and its run metrics.  Spans of the benchmark's own (``span``) time
the calls into each layer on the host clock and name them in a traced
window.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

import pyrecode_tpu_torch as port
from portbench import frames, reference, spec
from portbench.tracefile import Trace

WINDOW_SPAN = "portbench.window"


class Run:
    """What one run knows: its cell, its inputs, and what the window did."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device, tmp: Path):
        self.cell, self.seed, self.device, self.tmp = cell, int(seed), device, tmp
        self.device_kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else device.type)
        det, params = cell.config["detector"], cell.config["params"]
        self.height, self.width = int(det["height"]), int(det["width"])
        self.bit_depth = int(params["target_bit_depth"])
        self.level = int(params["reduction_level"])
        self.epsilon = int(params["calibration_threshold_epsilon"])
        self.nodes = int(params["num_threads"])
        self.n_frames = int(cell.config["frames_per_acquisition"])
        # the frames in host memory: a pool of whole acquisitions that the
        # call pattern takes its frames from
        self.pool_frames = self.n_frames * int(cell.traffic.get("pool_acquisitions", 1))
        self.frames = self.dark = self.thr = self.fg_counts = None
        self.steps: list = []
        self.spans = defaultdict(list)
        self.launches: dict = {}
        self.setup_s = self.window_s = None
        self.trace = None

    def rng(self, stream: int) -> np.random.Generator:
        """The seed's own stream ``stream`` of host random numbers."""
        return np.random.default_rng([self.seed % (1 << 64), stream])

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def input_params(self) -> port.InputParams:
        p = self.cell.config["params"]
        params = port.InputParams(dict(
            p, num_cols=self.width, num_rows=self.height, num_frames=self.n_frames,
            frame_offset=0, num_calibration_frames=1, calibration_frame_offset=0,
            keep_part_files=1, source_file_type=0, source_header_length=0,
            keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
            target_data_type=0))
        if not params.validate():
            raise ValueError(f"{self.cell.name}: the configuration's parameters do not validate")
        return params

    def expected(self, z: int) -> np.ndarray:
        """Frame z of the pool as the plain reference reads it back."""
        return reference.expected(self.level, self.frames[z], self.thr)

    def done(self) -> list:
        return [s for s in self.steps if s["ok"]]

    def frames_done(self) -> int:
        return sum(s["frames"] for s in self.done())


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
            t_start: float) -> dict:
    """Run the cell once; returns the result line's object, with the
    checks under ``checks`` and without the device's name."""
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _execute(cell, seed, seconds, traced, device, t_start, tmp)
    finally:
        kept = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file())
        print(f"the run's files: {kept} bytes at its end", file=sys.stderr)
        shutil.rmtree(tmp, ignore_errors=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _execute(cell, seed, seconds, traced, device, t_start, tmp):
    run = Run(cell, seed, device, tmp)
    run.frames, run.dark, run.fg_counts = frames.make(
        cell.traffic["frames"], run.pool_frames, run.height, run.width, run.bit_depth, run.epsilon,
        seed, device)
    run.thr = reference.threshold(run.dark, run.epsilon)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_frames = time.perf_counter()
    pattern = spec.pattern(cell.traffic["pattern"]).Pattern(run)
    pattern.setup()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    if traced:   # the profiler's first start in a process sets up its tracer
        with torch.profiler.profile(activities=activities):
            _sync(device)
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    print(f"set-up {run.setup_s:.3f} s: to the frames {t_frames - t_start:.3f} s, "
          f"the cell's path {run.setup_s - (t_frames - t_start):.3f} s", file=sys.stderr)

    before = port.kernel_launch_counts()
    profiler = torch.profiler.profile(activities=activities) if traced else nullcontext()
    with profiler:
        with torch.profiler.record_function(WINDOW_SPAN):
            w0 = time.perf_counter()
            while True:
                run.steps.append(pattern.step(len(run.steps)))
                if time.perf_counter() - w0 >= seconds:
                    break
            _sync(device)
            run.window_s = time.perf_counter() - w0
    times = sorted(s.get("seconds", s.get("latency_s", 0.0)) for s in run.steps)
    print(f"window {run.window_s:.3f} s, {len(run.steps)} calls of {times[0]:.4f} / "
          f"{times[len(times) // 2]:.4f} / {times[-1]:.4f} s (least / median / most)",
          file=sys.stderr)
    after = port.kernel_launch_counts()
    run.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        path = tmp / "window.pt.trace.json"
        profiler.export_chrome_trace(str(path))
        run.trace = Trace(path, WINDOW_SPAN)
        path.unlink()
        if not run.trace.device:
            raise RuntimeError("the trace of the window holds no device interval")
    pattern.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = pattern.check()
    metrics = {}
    for entry in cell.metrics(traced):
        value = spec.metric_reader(entry["name"])(run)
        if value is None:
            print(f"metric {entry['name']}: nothing to read in this run", file=sys.stderr)
        else:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(run.steps),
        "failed": len(run.steps) - len(run.done()),
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(peak)},
    }
    if traced:
        busy = run.trace.busy_s()
        result["device"].update(busy_s=busy, window_s=run.trace.hi - run.trace.lo)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result
