"""The scheme-12 cells (``de16_l1_rans.write``, ``.read``): a cut-down run of
each reads correct, the write cell also with the writer's device coders
(their plain twins on the CPU); the five metrics this configuration brought
compute what their docstrings say on a filled span table or trace, read
nothing without their spans or kernels, and the span metrics read a value
in a profiled cut-down step of their cell."""

import types

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import writer
from portbench import frames, harness, plain_reader, reference, spec
from portbench.tests.small import SEED, run_small, small_cell
from portbench.tests.test_portbench_arith import _run

WRITE, READ = "de16_l1_rans.write", "de16_l1_rans.read"
PEAK = 3.35e12


def _device_coders(monkeypatch):
    monkeypatch.setattr(writer.ReCoDeWriter, "_resolve_device_entropy",
                        lambda self, device_entropy: True)


@pytest.mark.parametrize("coders", ["default", "device"])
@pytest.mark.parametrize("name", [WRITE, READ])
def test_sound_run_is_correct(monkeypatch, name, coders):
    if coders == "device":
        _device_coders(monkeypatch)
    # a window long enough for the read check's four calls on a busy CPU
    result = run_small(name, seconds=2.0, frames=24)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["attempted"] >= 1 and "setup_s" in result["metrics"]


def _stub_run(frames_done=96):
    steps = [{"ok": True, "frames": frames_done}, {"ok": False, "frames": 0}]
    return types.SimpleNamespace(steps=steps,
                                 frames_done=lambda: sum(s["frames"] for s in steps if s["ok"]))


def _with_table(monkeypatch, table):
    monkeypatch.setattr(port, "span_totals", lambda: dict(table))


def test_host_stage_arithmetic(monkeypatch):
    read = spec.metric_reader("rans_host_stage_ms_per_frame")
    _with_table(monkeypatch, {"rans.host_stage": (48, 0.96), "rans.encode": (24, 3.0)})
    assert read(_stub_run(96)) == pytest.approx(10.0)
    assert read(_stub_run(0)) is None
    _with_table(monkeypatch, {"rans.encode": (24, 3.0)})
    assert read(_stub_run(96)) is None


@pytest.mark.parametrize("table, want", [
    ({"rans.assemble": (10, 0.1), "rans.stored": (1, 0.0), "rans.host_coder": (2, 0.1)}, 75.0),
    ({"rans.assemble": (8, 0.1)}, 100.0),
    ({"rans.host_coder": (3, 0.1)}, 0.0),
    ({"rans.encode": (3, 0.1), "writer.entropy": (3, 0.2)}, None),
])
def test_device_coded_arithmetic(monkeypatch, table, want):
    _with_table(monkeypatch, table)
    got = spec.metric_reader("rans_device_coded_pct")(_stub_run())
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("table, want", [
    ({"reader.read_frames_dense": (4, 1.0), "reader.rans_chain": (3, 0.1),
      "reader.rans_bytes": (1, 0.1)}, 75.0),
    ({"reader.read_frames_dense": (4, 1.0), "reader.rans_bytes": (4, 0.1)}, 0.0),
    ({"reader.read_frames_dense": (4, 1.0), "reader.rans_chain": (4, 0.1)}, 100.0),
    ({"reader.read_frames_dense": (4, 1.0), "reader.inflate": (4, 0.1)}, None),
    ({}, None),
])
def test_rans_chain_arithmetic(monkeypatch, table, want):
    _with_table(monkeypatch, table)
    got = spec.metric_reader("reader_rans_chain_pct")(_stub_run())
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", ["rans_host_stage_ms_per_frame", "rans_device_coded_pct",
                                  "reader_rans_chain_pct"])
def test_span_metrics_read_nothing_without_a_span_table(monkeypatch, name):
    monkeypatch.delattr(port, "span_totals")
    assert spec.metric_reader(name)(_stub_run()) is None


def _stream(log2_lanes, flags, m, body):
    """A scheme-12 stream's fixed header and a body of ``body`` bytes."""
    head = bytes([0xA5, 1, log2_lanes, flags]) + m.to_bytes(4, "little") * 2
    return head + body.to_bytes(4, "little") + bytes(4 + body)


class _Container:
    """Stands in for the plain reader: the table of a file of streams."""

    table: dict = {}

    def __init__(self, path):
        self.offsets, self.meta = self.table[str(path)]


def test_encode_roofline_arithmetic(monkeypatch, tmp_path):
    # frame 0: gaps and values on 1024 lanes; frame 1: gaps on 8192 lanes,
    # values stored; frame 2: both from the host coder's 512 lanes
    streams = [(_stream(10, 6, 70000, 50000), _stream(10, 2, 70000, 60000)),
               (_stream(13, 6, 3 << 20, 2 << 20), _stream(0, 1, 40, 40)),
               (_stream(9, 6, 1000, 700), _stream(9, 2, 1000, 800))]
    path = tmp_path / "acq.rc1"
    path.write_bytes(b"".join(a + b for a, b in streams))
    offsets = np.cumsum([0] + [len(a) + len(b) for a, b in streams])[:-1].tolist()
    _Container.table = {str(path): (offsets, [(len(a), len(b), 0) for a, b in streams])}
    monkeypatch.setattr(plain_reader, "PlainContainer", _Container)
    moved = 4 * 70000 + 50000 + 4 * 70000 + 60000 + 4 * (3 << 20) + (2 << 20)
    ops = [("rans_hist_kernel", 5), ("rans_chain_kernel", 40), ("rans_place_kernel", 10)]
    steps = [{"ok": True, "frames": 3, "offset": 0, "merged": str(path)},
             {"ok": False, "frames": 0}]
    run = _run(tmp_path, ops, {}, steps, [1, 1, 1])
    read = spec.metric_reader("rans_encode_roofline_pct")
    assert read(run) == pytest.approx(100 * moved / PEAK / 55e-6)
    # a kernel missing from the trace, or no frame the card coded: nothing
    assert read(_run(tmp_path, ops[:2], {}, steps, [1, 1, 1])) is None
    _Container.table = {str(path): ([offsets[2]], [(len(streams[2][0]), len(streams[2][1]), 0)])}
    assert read(_run(tmp_path, ops, {}, steps, [1, 1, 1])) is None


def test_decode_roofline_arithmetic(monkeypatch, tmp_path):
    path = tmp_path / "container" / "acq.rc1"
    path.parent.mkdir()
    path.write_bytes(b"")
    meta = [(100 + z, 200 + z, 0) for z in range(6)]
    _Container.table = {str(path): ([], meta)}
    monkeypatch.setattr(plain_reader, "PlainContainer", _Container)
    steps = [{"ok": True, "frames": 2, "start": 0}, {"ok": True, "frames": 2, "start": 3},
             {"ok": False, "frames": 0, "latency_s": 1.0}]
    ops = [("rans_decode_kernel", 30), ("posdecode_kernel", 6)]
    run = _run(tmp_path, ops, {}, steps, [1] * 6)
    run.tmp, run.level = tmp_path, 1
    n = run.height * run.width
    moved = sum(300 + 2 * z + 2 * n for z in (0, 1, 3, 4))
    read = spec.metric_reader("rans_decode_roofline_pct")
    assert read(run) == pytest.approx(100 * moved / PEAK / 36e-6)
    # the symbol chain's kernels in place of the positions decode: nothing
    run = _run(tmp_path, [("rans_decode_kernel", 30), ("decode_expand_kernel", 6)], {}, steps,
               [1] * 6)
    run.tmp, run.level = tmp_path, 1
    assert read(run) is None
    run.tmp = tmp_path / "elsewhere"
    assert read(run) is None


def test_entries():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in (("rans_encode_roofline_pct", WRITE), ("rans_decode_roofline_pct", READ),
                       ("rans_host_stage_ms_per_frame", WRITE), ("rans_device_coded_pct", WRITE),
                       ("reader_rans_chain_pct", READ)):
        assert entries[name]["workloads"] == [cell]
    for name in (WRITE, READ):
        assert spec.cell(name, bench).config["frames_per_acquisition"] == 192
    assert spec.cell(WRITE, bench).config["params"]["compression_scheme"] == 12


@pytest.mark.parametrize("name, metric, want", [
    (WRITE, "rans_host_stage_ms_per_frame", None),
    (WRITE, "rans_device_coded_pct", 0.0),
    (READ, "reader_rans_chain_pct", 0.0),
])
def test_span_metrics_read_a_profiled_window(monkeypatch, tmp_path, name, metric, want):
    """One step of the cell at a cut size on the CPU, the writer's device
    coders forced on, under a profile.  Every stream of 64 x 128 frames is
    short, so the host coder takes it, and the reads take the byte path."""
    _device_coders(monkeypatch)
    cell = small_cell(name)
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
        value = spec.metric_reader(metric)(run)
        if want is None:
            assert value is not None and value > 0
        else:
            assert value == pytest.approx(want)
    finally:
        pattern.close()
        port.reset_span_totals()
