"""The reader of ``reader_pinned_d2h_pct``: its arithmetic on a filled span
table, nothing (None) where either span or the span table is absent, as
in a program that has no pinned route, its entry, and what it reads in a
cut-down read window on the CPU, where the reader takes the pageable
route."""

import types

import pytest
import torch

import pyrecode_tpu_torch as port
from portbench import frames, harness, reference, spec
from portbench.tests.small import SEED, small_cell

NAME = "reader_pinned_d2h_pct"
TABLE = {"reader.read_frames_dense": (10, 0.9), "reader.d2h": (10, 0.06),
         "reader.d2h_pinned": (10, 0.05), "reader.inflate": (10, 0.4)}
RUN = types.SimpleNamespace(frames_done=lambda: 80)


@pytest.mark.parametrize("pinned, share", [(10, 100.0), (7, 70.0), (0, 0.0)])
def test_arithmetic(monkeypatch, pinned, share):
    table = dict(TABLE, **{"reader.d2h_pinned": (pinned, 0.005 * pinned)})
    monkeypatch.setattr(port, "span_totals", lambda: table)
    assert spec.metric_reader(NAME)(RUN) == pytest.approx(share)


@pytest.mark.parametrize("absent", ["reader.d2h", "reader.d2h_pinned", "span table"])
def test_nothing_without_its_spans(monkeypatch, absent):
    if absent == "span table":
        monkeypatch.delattr(port, "span_totals")
    else:
        table = {k: v for k, v in TABLE.items() if k != absent}
        monkeypatch.setattr(port, "span_totals", lambda: table)
    assert spec.metric_reader(NAME)(RUN) is None


def test_entry():
    entry = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[NAME]
    assert (entry["unit"], entry["better"], entry["source"]) == ("%", "higher", "program_span")
    assert (entry["layer"], entry["moves"]) == ("device copies", "read_call_p50_ms")
    assert entry["workloads"] == ["de16_l1_zlib.read"]


def test_cpu_read_window_reads_nothing(tmp_path):
    """One call of the read cell at a cut size on the CPU, under a profile:
    ``reader.d2h`` is there, the pinned child is not, so the metric reads
    nothing and does not raise."""
    cell = small_cell("de16_l1_zlib.read")
    run = harness.Run(cell, SEED, torch.device("cpu"), tmp_path)
    run.frames, run.dark, run.fg_counts = frames.make(
        cell.traffic["frames"], run.pool_frames, run.height, run.width, run.bit_depth,
        run.epsilon, SEED, run.device)
    run.thr = reference.threshold(run.dark, run.epsilon)
    pattern = spec.pattern(cell.traffic["pattern"]).Pattern(run)
    pattern.setup()
    port.reset_span_totals()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run.steps.append(pattern.step(0))
        assert port.span_totals()["reader.d2h"][0] == 1
        assert spec.metric_reader(NAME)(run) is None
    finally:
        pattern.close()
        port.reset_span_totals()
