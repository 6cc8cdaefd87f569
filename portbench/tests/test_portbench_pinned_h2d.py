"""The reader of ``writer_pinned_h2d_pct``: its arithmetic on a filled span
table, nothing (None) where either span or the span table is absent, as
in a program that has no staged route, its entry against the write cells
of the benchmark, and what it reads in a cut-down write window on the
CPU, where the writer takes the pageable route."""

import types

import pytest
import torch

import pyrecode_tpu_torch as port
from portbench import frames, harness, reference, spec
from portbench.tests.small import SEED, small_cell

NAME = "writer_pinned_h2d_pct"
TABLE = {"writer.dispatch": (72, 1.9), "writer.h2d": (72, 0.4),
         "writer.h2d_pinned": (72, 0.3), "writer.count": (72, 0.36)}
RUN = types.SimpleNamespace(frames_done=lambda: 288)


@pytest.mark.parametrize("pinned, share", [(72, 100.0), (18, 25.0), (0, 0.0)])
def test_arithmetic(monkeypatch, pinned, share):
    table = dict(TABLE, **{"writer.h2d_pinned": (pinned, 0.004 * pinned)})
    monkeypatch.setattr(port, "span_totals", lambda: table)
    assert spec.metric_reader(NAME)(RUN) == pytest.approx(share)


@pytest.mark.parametrize("absent", ["writer.h2d", "writer.h2d_pinned", "span table"])
def test_nothing_without_its_spans(monkeypatch, absent):
    if absent == "span table":
        monkeypatch.delattr(port, "span_totals")
    else:
        table = {k: v for k, v in TABLE.items() if k != absent}
        monkeypatch.setattr(port, "span_totals", lambda: table)
    assert spec.metric_reader(NAME)(RUN) is None


def test_entry_lists_the_write_cells():
    """The cells listed are the cells that write (those that report
    ``write_GBps``), whichever cells a later change appends."""
    bench = spec.load_benchmark()
    entry = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert (entry["unit"], entry["better"], entry["source"]) == ("%", "higher", "program_span")
    assert (entry["layer"], entry["moves"]) == ("device copies", "write_GBps")
    writes = {m["name"]: m for m in bench["end_to_end"]}["write_GBps"]["workloads"]
    assert entry["workloads"] == writes
    assert {"de16_l1_zlib.write", "de16_l4_centroid.write", "de16_l1_rans.write"} <= set(writes)


def test_cpu_write_window_reads_nothing(tmp_path):
    """One acquisition of the write cell at a cut size on the CPU, under a
    profile: ``writer.h2d`` is there, the pinned child is not, so the
    metric reads nothing and does not raise."""
    cell = small_cell("de16_l1_zlib.write")
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
        assert port.span_totals()["writer.h2d"][0] > 0
        assert spec.metric_reader(NAME)(run) is None
    finally:
        pattern.close()
        port.reset_span_totals()
