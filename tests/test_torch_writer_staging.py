"""The writer's route of a batch to the device (``_batch_to_device``).

On the CPU: the pageable copy, with no pinned allocation and no
``writer.h2d_pinned`` span, and the host oracle's bytes; the staged route
forced with an unpinned buffer (its host copy, dtype, padding and sign flip
are device-agnostic) writes the pageable route's bytes, its span inside
``writer.h2d``.  On the card (marker ``gpu``, skipped without one): the
staged route's part files against the pageable route's, which a refused
pinned allocation takes, for uint16 and int16 sources, a short padded final
batch, L1 at schemes 0 and 12 and L4; two writers of one process, the
second on the first's cached pinned block, each reading back its own
frames; and the nesting of the two spans in the trace.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_writer_staging.py
"""

import filecmp
import json

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import InputParams

CPU = [torch.profiler.ProfilerActivity.CPU]
EPSILON = 3
NODES = 2
SHAPE = (11, 96, 160)   # 6 + 5 frames over two nodes: 4 + 2 and 4 + 1, both padded
# (level, scheme, source dtype)
CASES = [(1, 0, np.uint16), (1, 12, np.uint16), (4, 0, np.uint16),
         (1, 0, np.int16), (1, 12, np.int16), (4, 0, np.int16)]
IDS = [f"L{level}-s{scheme}-{np.dtype(dtype).name}" for level, scheme, dtype in CASES]


def _case(level, scheme, dtype, shape=SHAPE, seed=0):
    """Frames of ~5% foreground (signed L1 frames also hold negative
    background pixels) and the params of ``NODES`` nodes."""
    rng = np.random.default_rng(seed + 10 * level + scheme)
    signed = np.iinfo(dtype).min < 0
    dark = rng.integers(-20 if signed and level == 1 else 0, 20, shape[1:]).astype(np.int64)
    thr = dark + EPSILON
    data = thr - rng.integers(0, EPSILON + 1, shape)
    if signed and level == 1:
        data[rng.random(shape) < 0.02] = -2000
    fg = rng.random(shape) < 0.05
    data[fg] = np.minimum(thr + 1 + rng.exponential(40.0, shape).astype(np.int64), thr + 4095)[fg]
    flag = int(signed)
    params = InputParams(dict(
        reduction_level=level, rc_operation_mode=1, calibration_threshold_epsilon=EPSILON,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[2], num_rows=shape[1],
        num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=NODES, l2_statistics=0,
        l4_centroiding=0, compression_scheme=scheme, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=flag, target_data_type=flag))
    assert params.validate()
    return data.astype(dtype), dark.astype(dtype), params


def _write(out, data, dark, params, staging=None, **kwargs):
    """The part files of every node, the writers' staging buffers after
    their runs, and the merged container."""
    out.mkdir(parents=True)
    buffers = []
    for node_id in range(NODES):
        w = port.ReCoDeWriter("s", dark_data=dark, output_directory=str(out),
                              input_params=params, node_id=node_id, **kwargs)
        if staging is not None:
            w._staging = staging()
        w.start()
        w.run(data)
        buffers.append(w._staging)
        w.close()
        assert w._staging is None
    level = params.reduction_level
    parts = [out / f"s.rc{level}_part{n:03d}" for n in range(NODES)]
    return parts, buffers, port.merge_parts(str(out), f"s.rc{level}", NODES)


def _same(a, b):
    for x, y in zip(a, b):
        assert filecmp.cmp(x, y, shallow=False), (x, y)


def _no_pinning(monkeypatch, exc):
    """``torch.empty`` that raises ``exc`` when asked for pinned memory."""
    empty = torch.empty

    def refuse(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise exc("pinned memory refused")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", refuse)


def _spans(prof, path, names):
    """(start, end, name, thread) in microseconds of the trace's spans named
    in ``names``."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") in names]


def _nested(spans):
    """Every ``writer.h2d_pinned`` lies inside a ``writer.h2d`` of its
    thread; returns the number of each."""
    outer = [s for s in spans if s[2] == "writer.h2d"]
    inner = [s for s in spans if s[2] == "writer.h2d_pinned"]
    for lo, hi, _, tid in inner:
        assert any(o_lo <= lo and hi <= o_hi and o_tid == tid
                   for o_lo, o_hi, _, o_tid in outer), (lo, hi)
    return len(outer), len(inner)


@pytest.fixture(autouse=True)
def _clean_span_table():
    port.reset_span_totals()
    yield
    port.reset_span_totals()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


# ----------------------------------------------------------------------- CPU

@pytest.mark.parametrize("level, scheme, dtype", CASES, ids=IDS)
def test_cpu_writer_takes_the_pageable_route(tmp_path, monkeypatch, level, scheme, dtype):
    """A writer on the CPU never asks for pinned memory, keeps no staging
    buffer and opens no ``writer.h2d_pinned`` span; its part files are the
    host oracle's."""
    data, dark, params = _case(level, scheme, dtype)
    want, _, _ = _write(tmp_path / "oracle", data, dark, params, device="cpu", use_tpu=False)
    _no_pinning(monkeypatch, AssertionError)
    with torch.profiler.profile(activities=CPU):
        got, buffers, _ = _write(tmp_path / "cpu", data, dark, params, device="cpu")
    _same(got, want)
    assert buffers == [None] * NODES
    totals = port.span_totals()
    assert totals["writer.h2d"][0] == 4   # two batches a node
    assert "writer.h2d_pinned" not in totals


@pytest.mark.parametrize("level, scheme, dtype", CASES, ids=IDS)
def test_staged_route_writes_the_pageable_bytes(tmp_path, level, scheme, dtype):
    """The staged route forced on the CPU with an unpinned buffer of the
    batch's shape: the host copy into the buffer (with the pageable copy's
    dtype), the padded final batch and the sign flip of signed L1 frames
    give the pageable route's part files, every batch through the one
    buffer, each ``writer.h2d_pinned`` inside a ``writer.h2d``."""
    data, dark, params = _case(level, scheme, dtype)
    want, _, _ = _write(tmp_path / "pageable", data, dark, params, device="cpu")
    host_dtype = torch.int16 if dtype == np.int16 else torch.uint16
    with torch.profiler.profile(activities=CPU) as prof:
        got, buffers, _ = _write(tmp_path / "staged", data, dark, params, device="cpu",
                                 staging=lambda: torch.empty((4, *SHAPE[1:]), dtype=host_dtype))
    _same(got, want)
    assert all(b.dtype == host_dtype for b in buffers)
    totals = port.span_totals()
    assert totals["writer.h2d"][0] == totals["writer.h2d_pinned"][0] == 4
    assert _nested(_spans(prof, tmp_path / "trace.json",
                          {"writer.h2d", "writer.h2d_pinned"})) == (4, 4)


# ---------------------------------------------------------------------- card

@pytest.mark.gpu
@pytest.mark.parametrize("level, scheme, dtype", CASES, ids=IDS)
def test_card_staged_route_matches_the_pageable_route(cuda, tmp_path, monkeypatch,
                                                      level, scheme, dtype):
    """Every batch through a pinned buffer of the batch's shape, one a
    writer, on the default route; a refused pinned allocation sends every
    batch of a writer down the pageable copy (no ``writer.h2d_pinned``
    span), with the same part files."""
    data, dark, params = _case(level, scheme, dtype)
    with torch.profiler.profile(activities=CPU):
        staged, buffers, merged = _write(tmp_path / "staged", data, dark, params, device="cuda")
    totals = port.span_totals()
    assert totals["writer.h2d"][0] == totals["writer.h2d_pinned"][0] == 4
    for b in buffers:
        assert b.is_pinned() and b.shape == (4, *SHAPE[1:])
    port.reset_span_totals()
    _no_pinning(monkeypatch, RuntimeError)
    with torch.profiler.profile(activities=CPU):
        pageable, buffers, _ = _write(tmp_path / "pageable", data, dark, params, device="cuda")
    monkeypatch.undo()
    totals = port.span_totals()
    assert totals["writer.h2d"][0] == 4 and "writer.h2d_pinned" not in totals
    assert buffers == [False] * NODES
    _same(staged, pageable)
    if level == 1:
        reader = port.ReCoDeReader(merged, device="cuda")
        reader.open()
        try:
            got = reader.read_frames_dense(0, SHAPE[0])
        finally:
            reader.close()
        thr = dark.astype(np.int64) + EPSILON
        assert np.array_equal(got, np.where(data > thr, data - thr, 0))


@pytest.mark.gpu
def test_card_writers_back_to_back_reuse_the_pinned_block(cuda, tmp_path):
    """Two acquisitions, one writer each in turn in one process: the second
    writer's buffer is the block the first handed back to the caching host
    allocator, and each container reads back its own frames."""
    out = {}
    for i in range(2):
        data, dark, params = _case(1, 0, np.uint16, seed=100 + i)
        path = tmp_path / f"acquisition{i}"
        path.mkdir()
        w = port.ReCoDeWriter("s", dark_data=dark, output_directory=str(path),
                              input_params=params, node_id=0, device="cuda")
        w.start()
        w.run(data)
        ptr = w._staging.data_ptr()
        w.close()
        thr = dark.astype(np.int64) + EPSILON
        out[i] = (ptr, np.where(data > thr, data - thr, 0)[:6],
                  port.merge_parts(str(path), "s.rc1", 1))
    assert out[0][0] == out[1][0]
    assert not np.array_equal(out[0][1], out[1][1])
    for ptr, want, merged in out.values():
        reader = port.ReCoDeReader(merged, device="cpu")
        reader.open()
        try:
            assert np.array_equal(reader.read_frames_dense(0, 6), want)
        finally:
            reader.close()


@pytest.mark.gpu
def test_card_pinned_span_nests_in_the_h2d_span(cuda, tmp_path):
    data, dark, params = _case(1, 0, np.uint16)
    with torch.profiler.profile(activities=CPU) as prof:
        _write(tmp_path / "traced", data, dark, params, device="cuda")
    assert _nested(_spans(prof, tmp_path / "trace.json",
                          {"writer.h2d", "writer.h2d_pinned"})) == (4, 4)
