"""The writer's threshold, dark + epsilon saturated at the source dtype's max.

A writer with ``use_tpu`` builds its device threshold (``_threshold_dev``)
on its device from one copy of the calibration; it must equal, byte for
byte, the pageable copy of the host formula (int64 sum, saturated, cast to
the source dtype, which wraps a sum below the dtype's min) for every 8- and
16-bit source, epsilon 0, positive, negative and past the int32 range, and
calibrations at the dtype's min and max.  The host threshold
(``_threshold``) is computed at its first use: a device writer holds none
when construction ends, and the validation frames' dose rates read it.  In
a server run the span ``writer.threshold`` (child
``writer.threshold_device``) lies inside ``node.open``.  On the card (marker
``gpu``, skipped without one): the device threshold at 4096^2 and a short
L1 scheme-0 server run against the CPU writer's part files.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_threshold.py
"""

import contextlib
import filecmp
import threading

import numpy as np
import pytest
import torch
from scipy import ndimage

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import InputParams
from pyrecode_tpu_torch import server as port_server
from pyrecode_tpu_torch import writer as port_writer

CPU = [torch.profiler.ProfilerActivity.CPU]
# source dtype -> (source_data_type, bit depth)
DTYPES = {np.uint8: (0, 8), np.uint16: (0, 16), np.int8: (1, 8), np.int16: (1, 16)}
DTYPE_IDS = [np.dtype(d).name for d in DTYPES]
# 0, the cells' 2, a 5 that saturates max - 5 .. max, a negative one that
# wraps the min, and two past the int32 range
EPSILONS = [0, 2, 5, -1, (1 << 33) + 5, -(1 << 33) - 5]
NODES = 3


def _params(dtype, epsilon, shape, level=1, num_threads=1, **overrides):
    flag, bit_depth = DTYPES[dtype]
    values = dict(
        reduction_level=level, rc_operation_mode=1, calibration_threshold_epsilon=epsilon,
        target_bit_depth=bit_depth, source_bit_depth=bit_depth, num_cols=shape[2],
        num_rows=shape[1], num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=num_threads,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=flag, target_data_type=flag)
    values.update(overrides)
    params = InputParams(values)
    assert params.validate()
    return params


def _calibration(dtype, shape=(16, 24), seed=0):
    """Random darks over the dtype's whole range, with its min, its max,
    max - 5 .. max (saturated by every epsilon up to 5) and min .. min + 5
    (wrapped by a negative epsilon)."""
    info = np.iinfo(dtype)
    dark = np.random.default_rng(seed).integers(info.min, info.max, shape, endpoint=True)
    flat = dark.reshape(-1)
    flat[:4] = info.min
    flat[4:8] = info.max
    flat[8:14] = np.arange(info.max - 5, info.max + 1)
    flat[14:20] = np.arange(info.min, info.min + 6)
    return dark.astype(dtype)


def _formula(dark, epsilon):
    """The host formula: int64 sum, saturated at the max, cast (wrapping)."""
    thr = dark.astype(np.int64) + epsilon
    return np.minimum(thr, np.iinfo(dark.dtype).max).astype(dark.dtype)


def _writer(out, dark, params, **kwargs):
    return port.ReCoDeWriter("t", dark_data=dark, output_directory=str(out),
                             input_params=params, **kwargs)


def _assert_device_threshold(w, dark, epsilon):
    want = w._to_device(_formula(dark, epsilon))
    got = w._threshold_dev
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want)


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

@pytest.mark.parametrize("level", [1, 4])
@pytest.mark.parametrize("epsilon", EPSILONS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=DTYPE_IDS)
def test_device_threshold_is_the_formula(tmp_path, dtype, epsilon, level):
    """Bit for bit the pageable copy of the host formula, in the dtype the
    encode takes (uint16 for unsigned sources; the sign bit flipped for
    signed L1, not for signed L4), with no host threshold computed."""
    dark = _calibration(dtype)
    w = _writer(tmp_path, dark, _params(dtype, epsilon, (4, *dark.shape), level), device="cpu")
    assert w._host_threshold is None
    _assert_device_threshold(w, dark, epsilon)


@pytest.mark.parametrize("use_tpu", [True, False])
@pytest.mark.parametrize("epsilon", EPSILONS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=DTYPE_IDS)
def test_host_threshold_is_the_formula_at_first_use(tmp_path, dtype, epsilon, use_tpu):
    """The host threshold holds the formula's bytes in the source dtype,
    computed once, at its first use, for a device and a host writer; a host
    writer builds no device threshold."""
    dark = _calibration(dtype, seed=1)
    w = _writer(tmp_path, dark, _params(dtype, epsilon, (4, *dark.shape)), device="cpu",
                use_tpu=use_tpu)
    assert w._host_threshold is None
    assert (w._threshold_dev is None) != use_tpu
    want = _formula(dark, epsilon)
    got = w._threshold
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert w._threshold is got


def _puddle_frames(dtype, shape, epsilon, seed):
    """~3% of the pixels 1..200 above the threshold, a few at the dtype's
    max (over a saturated threshold: background), the rest at or below it."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    dark = rng.integers(max(info.min, -20), 40, shape[1:]).astype(np.int64)
    dark[:2, :] = info.max
    thr = np.minimum(dark + epsilon, info.max)
    data = thr - rng.integers(0, 3, shape)
    fg = rng.random(shape) < 0.03
    data[fg] = np.minimum(thr + rng.integers(1, 200, shape), info.max)[fg]
    return np.clip(data, info.min, info.max).astype(dtype), dark.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.int16], ids=["uint16", "int16"])
def test_validation_frames_keep_their_dose_rates(tmp_path, dtype):
    """A device writer that writes validation frames reads the host
    threshold at its first run: its dose rates are the count of 8-connected
    puddles over the formula's threshold in the central 128x128 window,
    over its pixels, as the host oracle writer's are, and the two write the
    same validation frames and part files."""
    epsilon, shape = 2, (7, 160, 192)
    data, dark = _puddle_frames(dtype, shape, epsilon, seed=3)
    params = _params(dtype, epsilon, shape)
    thr = _formula(dark, epsilon)
    ys, xs = slice(16, 144), slice(32, 160)
    want = [ndimage.label(data[i][ys, xs] > thr[ys, xs], structure=np.ones((3, 3)))[1]
            / (128 * 128) for i in range(0, shape[0], 3)]
    runs = {}
    for use_tpu in (True, False):
        out = tmp_path / f"use_tpu_{use_tpu}"
        out.mkdir()
        w = _writer(out, dark, params, device="cpu", use_tpu=use_tpu, validation_frame_gap=3)
        w.start()
        runs[use_tpu] = w.run(data)["run_dose_rates"]
        w.close()
    assert runs[True] == runs[False] == want
    assert min(want) > 0
    for name in ("t.rc1_part000", "t_part000_validation_frames.bin"):
        assert filecmp.cmp(tmp_path / "use_tpu_True" / name, tmp_path / "use_tpu_False" / name,
                           shallow=False), name


def _logged(annotate, log):
    """``annotate`` that also logs (thread, "enter" / "exit", name)."""
    @contextlib.contextmanager
    def logged(name, *args, **kwargs):
        with annotate(name, *args, **kwargs):
            log.append((threading.get_ident(), "enter", name))
            try:
                yield
            finally:
                log.append((threading.get_ident(), "exit", name))
    return logged


def _server_run(out, data, dark, params, device):
    out.mkdir()
    init = port.InitParams("batch", str(out), image_filename="t",
                           log_filename=str(out / "recode.log"), run_name="threshold")
    port.ReCoDeServer("batch", device=device).run(init, params, dark_data=dark, data=data)
    return [out / f"t.rc1_part{n:03d}" for n in range(params.num_threads)]


def test_threshold_span_nests_in_node_open(tmp_path, monkeypatch):
    """Under a profile, a server run of three thread nodes on the CPU: one
    ``writer.threshold`` a node, each inside that node's ``node.open``, each
    holding one ``writer.threshold_device``; the same part files as an
    untraced run."""
    data, dark = _puddle_frames(np.uint16, (9, 64, 96), 2, seed=5)
    params = _params(np.uint16, 2, data.shape, num_threads=NODES, source_bit_depth=12,
                     target_bit_depth=12)
    plain = _server_run(tmp_path / "plain", data, dark, params, "cpu")
    log = []
    monkeypatch.setattr(port_server, "annotate", _logged(port_server.annotate, log))
    monkeypatch.setattr(port_writer, "annotate", _logged(port_writer.annotate, log))
    with torch.profiler.profile(activities=CPU):
        traced = _server_run(tmp_path / "traced", data, dark, params, "cpu")
    for a, b in zip(traced, plain):
        assert filecmp.cmp(a, b, shallow=False), a
    totals = port.span_totals()
    for name in ("node.open", "writer.threshold", "writer.threshold_device"):
        assert totals[name][0] == NODES, name
    assert totals["writer.threshold"][1] <= totals["node.open"][1]
    stacks, opened = {}, 0
    for thread, event, name in log:
        stack = stacks.setdefault(thread, [])
        if event == "exit":
            assert stack.pop() == name
            continue
        if name == "writer.threshold":
            assert "node.open" in stack
            opened += 1
        elif name == "writer.threshold_device":
            assert stack[-1] == "writer.threshold"
        stack.append(name)
    assert opened == NODES and not any(stacks.values())


# ---------------------------------------------------------------------- card

@pytest.mark.gpu
def test_card_threshold_and_server_run(cuda, tmp_path):
    """On the card: the device threshold of a 4096^2 uint16 and int16
    calibration (L1 and, for int16, L4) equals the formula's pageable copy
    for epsilon 2 and -1, and a short L1 scheme-0 server run of three nodes
    writes the CPU writers' part files."""
    for dtype, levels in ((np.uint16, (1,)), (np.int16, (1, 4))):
        dark = _calibration(dtype, shape=(4096, 4096), seed=7)
        for level in levels:
            for epsilon in (2, -1):
                w = _writer(tmp_path, dark, _params(dtype, epsilon, (4, 4096, 4096), level),
                            device="cuda")
                assert w._threshold_dev.device.type == "cuda" and w._host_threshold is None
                _assert_device_threshold(w, dark, epsilon)
    data, dark = _puddle_frames(np.uint16, (13, 256, 384), 2, seed=9)
    params = _params(np.uint16, 2, data.shape, num_threads=NODES, source_bit_depth=12,
                     target_bit_depth=12)
    on_card = _server_run(tmp_path / "card", data, dark, params, "cuda")
    cpu = tmp_path / "cpu"
    cpu.mkdir()
    for node_id in range(NODES):
        w = _writer(cpu, dark, params, device="cpu", node_id=node_id)
        w.start()
        w.run(data)
        w.close()
    for path in on_card:
        assert filecmp.cmp(path, cpu / path.name, shallow=False), path.name
