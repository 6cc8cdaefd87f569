"""The reader of ``writer_device_threshold_pct``: its arithmetic on a filled
span table, nothing (None) where either span or the span table is absent,
as in a program that builds its threshold on the host, its entry against
the write cells of the benchmark, and what it reads in a cut-down write
window on the CPU, where each node's writer builds its threshold on the
writer's device."""

import types

import pytest
import torch

import pyrecode_tpu_torch as port
from portbench import frames, harness, reference, spec
from portbench.tests.small import SEED, small_cell

NAME = "writer_device_threshold_pct"
TABLE = {"node.open": (3, 0.03), "writer.threshold": (3, 0.012),
         "writer.threshold_device": (3, 0.011), "writer.dispatch": (72, 1.9)}
RUN = types.SimpleNamespace(frames_done=lambda: 288)


@pytest.mark.parametrize("device, share", [(3, 100.0), (2, 200.0 / 3), (0, 0.0)])
def test_arithmetic(monkeypatch, device, share):
    table = dict(TABLE, **{"writer.threshold_device": (device, 0.004 * device)})
    monkeypatch.setattr(port, "span_totals", lambda: table)
    assert spec.metric_reader(NAME)(RUN) == pytest.approx(share)


@pytest.mark.parametrize("absent", ["writer.threshold", "writer.threshold_device", "span table"])
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
    assert (entry["layer"], entry["moves"]) == ("server", "write_GBps")
    writes = {m["name"]: m for m in bench["end_to_end"]}["write_GBps"]["workloads"]
    assert entry["workloads"] == writes
    assert {"de16_l1_zlib.write", "de16_l4_centroid.write", "de16_l1_rans.write"} <= set(writes)


def test_cpu_write_window_reads_every_writer(tmp_path):
    """One acquisition of the write cell at a cut size on the CPU, under a
    profile: each of the three nodes builds its threshold on its device
    (the CPU here), so the metric reads 100."""
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
        assert port.span_totals()["writer.threshold"][0] == 3
        assert spec.metric_reader(NAME)(run) == 100.0
    finally:
        pattern.close()
        port.reset_span_totals()
