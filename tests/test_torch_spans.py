"""The port's spans (``profiling.annotate``): one flag check with no profile
recording; with one, a ``record_function`` and a count and host seconds in
the process-wide table (``span_totals``) from any thread, also for a span
that raises; and the spans of a thread-node server run, a merge and a
dense read at a small shape, whose outputs equal an untraced run's."""

import filecmp
import json
import os
import sys
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import profiling
from test_torch_slice import NODES, SHAPE, _fixture, _params

CPU = [torch.profiler.ProfilerActivity.CPU]


class _Refuse:
    """Stands in for what a span with tracing off must not touch."""

    def __init__(self, *args, **kwargs):
        raise AssertionError("touched with no profile recording")

    def __enter__(self):
        raise AssertionError("touched with no profile recording")

    def __exit__(self, *exc):
        return False


@pytest.fixture(autouse=True)
def _empty_table():
    port.reset_span_totals()
    yield
    port.reset_span_totals()


def test_off_enters_no_record_function_and_no_table(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Refuse)
    monkeypatch.setattr(profiling, "_SPAN_LOCK", _Refuse.__new__(_Refuse))
    with profiling.annotate("spans.off", {"session": "s", "node": 0}):
        pass
    metrics = {"t": timedelta(0)}
    with profiling.annotate("spans.off_metric", {"node": 0}, metrics, "t"):
        time.sleep(0.002)
    assert metrics["t"] >= timedelta(seconds=0.002)   # a run metric is timed all the same
    monkeypatch.undo()
    assert port.span_totals() == {}


def test_on_counts_every_thread_and_traces_the_main_one(tmp_path):
    def in_thread():
        with profiling.annotate("spans.thread", {"node": 1}):
            time.sleep(0.001)

    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.annotate("spans.main", {"session": "s", "node": 0}):
            worker = threading.Thread(target=in_thread)
            worker.start()
            worker.join()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    totals = port.span_totals()
    assert {name: count for name, (count, _) in totals.items()} == \
        {"spans.main": 1, "spans.thread": 1}
    assert totals["spans.main"][1] >= totals["spans.thread"][1] >= 0.001
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e.get("name") == "spans.main"
               for e in events)
    port.reset_span_totals()
    assert port.span_totals() == {}


def test_concurrent_spans_lose_no_count():
    """More threads than cores, switching often: every span is counted."""
    threads, spans = (os.cpu_count() or 4) + 4, 200

    def work():
        for _ in range(spans):
            with profiling.annotate("spans.stress", {"node": 0}):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert port.span_totals()["spans.stress"][0] == threads * spans


def test_a_span_that_raises_is_counted():
    metrics = {}
    with torch.profiler.profile(activities=CPU):
        with pytest.raises(ValueError):
            with profiling.annotate("spans.raises", None, metrics, "t"):
                raise ValueError("inside a span")
    assert port.span_totals()["spans.raises"][0] == 1
    assert isinstance(metrics["t"], timedelta)


def _traced_spans(prof, path, names):
    """(name, start, end) in seconds of the trace's spans named in
    ``names``, in order of their start."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6, e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") in names)


def _tiled(spans, lo, hi, slack=2e-3):
    """The spans follow each other from lo to hi, each within ``slack`` of
    the last one's end."""
    at = lo
    for start, end, name in spans:
        assert at - 1e-6 <= start <= at + slack and end <= hi + 1e-6, (name, start, at)
        at = end
    assert at >= hi - slack


def _server_run(out_dir, data, dark):
    out_dir.mkdir()
    init = port.InitParams("batch", str(out_dir), image_filename="test_data",
                           log_filename=str(out_dir / "recode.log"), run_name="spans")
    server = port.ReCoDeServer("batch", device="cpu")
    t0 = time.perf_counter()
    metrics = server.run(init, _params(), dark_data=dark, data=data)
    wall = time.perf_counter() - t0
    return metrics, wall, port.merge_parts(str(out_dir), "test_data.rc1", NODES)


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    data, dark = _fixture()
    _, _, merged = _server_run(tmp_path_factory.mktemp("spans") / "untraced", data, dark)
    return data, dark, merged


def test_server_spans(tmp_path, untraced):
    """Under a profile: the head's three spans once each, one after another
    in the trace; the writer's per batch and node; the merge once; the same
    bytes."""
    data, dark, plain = untraced
    with torch.profiler.profile(activities=CPU) as prof:
        metrics, wall, merged = _server_run(tmp_path / "traced", data, dark)
    assert filecmp.cmp(merged, plain, shallow=False)
    totals = port.span_totals()
    counts = {name: count for name, (count, _) in totals.items()}
    batches = NODES * -(-SHAPE[0] // NODES // 4)   # the writer's 4-frame batches
    for name in ("server.start", "server.process", "server.close", "merge.parts",
                 "merge.scan", "merge.copy"):
        assert counts[name] == 1, name
    for name in ("node.open", "node.close"):
        assert counts[name] == NODES, name
    for name in ("writer.dispatch", "writer.h2d", "writer.count", "writer.encode",
                 "writer.finish", "writer.entropy", "writer.records"):
        assert counts[name] == batches, name
    assert counts["writer.flush"] >= NODES
    head = _traced_spans(prof, tmp_path / "trace.json",
                         {"server.start", "server.process", "server.close"})
    assert [name for _, _, name in head] == ["server.start", "server.process", "server.close"]
    _tiled(head, head[0][0], head[-1][1])
    assert head[-1][1] - head[0][0] <= wall
    # writer.dispatch times frame_thresholding_and_counting_time, on one clock
    run_metric = sum(m["frame_thresholding_and_counting_time"].total_seconds()
                     for m in metrics.values())
    assert totals["writer.dispatch"][1] == pytest.approx(run_metric, rel=1e-3, abs=1e-5)
    finish = sum(m["frame_time"].total_seconds() for m in metrics.values())
    assert totals["writer.finish"][1] == pytest.approx(finish, rel=1e-3, abs=1e-5)


def test_reader_spans(tmp_path, untraced):
    """Under a profile: one of each reader span, the children tiling the
    call in the trace; the same frames."""
    _, _, merged = untraced
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    try:
        plain = reader.read_frames_dense(2, 4)
        with torch.profiler.profile(activities=CPU) as prof:
            got = reader.read_frames_dense(2, 4)
    finally:
        reader.close()
    assert np.array_equal(got, plain)
    totals = port.span_totals()
    children = ("fetch", "inflate", "stage", "decode", "d2h")
    assert {name: count for name, (count, _) in totals.items()} == \
        {f"reader.{name}": 1 for name in ("read_frames_dense",) + children}
    spans = _traced_spans(prof, tmp_path / "trace.json", set(totals))
    (lo, hi, _), inner = spans[0], spans[1:]
    assert [name for _, _, name in spans] == [f"reader.{name}"
                                              for name in ("read_frames_dense",) + children]
    _tiled(inner, lo, hi)
