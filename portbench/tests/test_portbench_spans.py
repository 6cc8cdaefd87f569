"""The readers of the program's spans: their arithmetic on a filled span
table and a stub run, nothing (None) where a span is absent or the program
has no span table, and a value from each in a cut-down window of every cell
its entry lists, driven on the CPU under a profile."""

import types

import pytest
import torch

import pyrecode_tpu_torch as port
from portbench import frames, harness, reference, spec
from portbench.tests.small import SEED, small_cell

# metric -> the spans it sums
METRICS = {
    "server_start_ms_per_frame": ("server.start",),
    "server_close_ms_per_frame": ("server.close",),
    "writer_h2d_wait_ms_per_frame": ("writer.h2d",),
    "writer_count_wait_ms_per_frame": ("writer.count",),
    "entropy_ms_per_frame": ("writer.entropy",),
    "records_ms_per_frame": ("writer.records", "writer.flush"),
    "reader_inflate_ms_per_frame": ("reader.inflate",),
    "reader_stage_ms_per_frame": ("reader.stage",),
}

TABLE = {"server.start": (3, 0.30), "server.process": (3, 2.0), "server.close": (3, 0.12),
         "writer.h2d": (72, 1.44), "writer.count": (72, 0.36), "writer.entropy": (72, 0.72),
         "writer.records": (72, 0.096), "writer.flush": (9, 0.048),
         "reader.inflate": (10, 0.4), "reader.stage": (10, 0.16)}


def _stub_run(frames_done):
    steps = [{"ok": True, "frames": frames_done}, {"ok": False, "frames": 0}]
    return types.SimpleNamespace(steps=steps,
                                 frames_done=lambda: sum(s["frames"] for s in steps if s["ok"]))


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_reader_arithmetic(monkeypatch, name):
    monkeypatch.setattr(port, "span_totals", lambda: dict(TABLE))
    seconds = sum(TABLE[span][1] for span in METRICS[name])
    assert spec.metric_reader(name)(_stub_run(96)) == pytest.approx(seconds / 96 * 1e3)
    assert spec.metric_reader(name)(_stub_run(0)) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_reader_reads_nothing_without_its_span(monkeypatch, name):
    for span in METRICS[name]:
        table = {k: v for k, v in TABLE.items() if k != span}
        monkeypatch.setattr(port, "span_totals", lambda: table)
        assert spec.metric_reader(name)(_stub_run(96)) is None
    monkeypatch.delattr(port, "span_totals")   # a program without the span table
    assert spec.metric_reader(name)(_stub_run(96)) is None


def test_entries_name_their_readers():
    entries = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in METRICS:
        assert entries[name]["source"] == "program_span"
        assert (entries[name]["unit"], entries[name]["better"]) == ("ms", "lower")


@pytest.mark.parametrize("cell_name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_span_readers_read_a_profiled_window(tmp_path, cell_name):
    """One step of the cell's call pattern at a cut size on the CPU, under a
    profile: every span metric the cell lists reads a value."""
    cell = small_cell(cell_name)
    device = torch.device("cpu")
    run = harness.Run(cell, SEED, device, tmp_path)
    run.frames, run.dark, run.fg_counts = frames.make(
        cell.traffic["frames"], run.pool_frames, run.height, run.width, run.bit_depth,
        run.epsilon, SEED, device)
    run.thr = reference.threshold(run.dark, run.epsilon)
    pattern = spec.pattern(cell.traffic["pattern"]).Pattern(run)
    pattern.setup()
    port.reset_span_totals()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run.steps.append(pattern.step(0))
        listed = [m["name"] for m in cell.per_layer if m["name"] in METRICS]
        assert listed
        for name in listed:
            value = spec.metric_reader(name)(run)
            assert value is not None and value > 0, name
    finally:
        pattern.close()
        port.reset_span_totals()
