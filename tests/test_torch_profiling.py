"""The port's profiling module against the JAX package's on the CPU: the
stage timer, the trace and its region names, the writer's
``run(profile_dir=)``, and the CUDA-event timer's refusal without a card."""

import json
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu import profiling as jax_profiling
from pyrecode_tpu_torch import profiling
from test_torch_slice import _fixture, _params


def _stages(timer):
    for name, seconds in (("encode", 0.02), ("compress", 0.01), ("encode", 0.02)):
        with timer.stage(name):
            time.sleep(seconds)
    return timer


def test_stage_timer_matches_jax():
    """The same stages give the same metrics shape: names in first-use
    order, timedelta sums, seconds from as_seconds, non-timedelta entries
    kept in metrics and left out of as_seconds."""
    got = _stages(profiling.StageTimer({"run_frames": 3}))
    want = _stages(jax_profiling.StageTimer({"run_frames": 3}))
    assert list(got.metrics) == list(want.metrics) == ["run_frames", "encode", "compress"]
    assert got.metrics["run_frames"] == 3
    assert all(isinstance(got.metrics[k], timedelta) for k in ("encode", "compress"))
    assert set(got.as_seconds()) == set(want.as_seconds()) == {"encode", "compress"}
    assert got.as_seconds()["encode"] >= 0.04 and got.as_seconds()["compress"] >= 0.01
    with pytest.raises(ValueError):
        with got.stage("fails"):
            raise ValueError("inside a stage")
    assert "fails" in got.metrics        # the stage is timed though it raised, as in JAX


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("probe-region"):
            torch.arange(1000).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "probe-region" for e in events)


def test_writer_profile_dir_traces_the_run(tmp_path):
    """run(profile_dir=) writes a trace and the same part file as a run
    without it (scheme 0, the device entropy stage's twins)."""
    data, dark = _fixture(shape=(4, 64, 128))
    params = _params(shape=(4, 64, 128), num_threads=1)
    parts = []
    for k, profile_dir in enumerate((None, tmp_path / "trace")):
        out = tmp_path / f"out{k}"
        out.mkdir()
        w = port.ReCoDeWriter("x", dark_data=dark, output_directory=str(out), input_params=params,
                              device="cpu", device_entropy=True, buffer_size_in_frames=2)
        w.start()
        metrics = w.run(data, profile_dir=None if profile_dir is None else str(profile_dir))
        w.close()
        assert metrics["run_frames"] == 4
        parts.append((out / "x.rc1_part000").read_bytes())
    assert parts[0] == parts[1]
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1


def test_cuda_event_time_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.cuda_event_time(lambda: np.zeros(1))
