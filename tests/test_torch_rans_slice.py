"""The port's scheme-12 main path end to end on the CPU: the writer with
device entropy (the rANS kernels' twins) -> part files -> merge_parts ->
the reader's gap chain, byte for byte against the JAX package (its writer
runs the Pallas kernels in interpret mode here), and a fixture at ~70000
foreground pixels a frame, where the device coders engage.
"""

import numpy as np
import pytest

import pyrecode_tpu_torch as port
from pyrecode_tpu.reader import ReCoDeReader as JaxReader
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch.codecs import rans as trans
from test_torch_slice import EPSILON, PARTS, _fixture, _params, _residuals, _same_files, _write

SHAPE12 = (3, 64, 128)     # one batch of one node: the JAX interpret run is slow
PARAMS12 = dict(shape=SHAPE12, num_threads=1, compression_scheme=12)


@pytest.fixture(scope="module")
def jax_files_s12(tmp_path_factory):
    """Part files and merged container of the JAX writer, scheme 12 with
    device entropy (interpret mode)."""
    data, dark = _fixture(SHAPE12)
    root = tmp_path_factory.mktemp("jax12")
    _write(JaxWriter, root, data, dark, _params(**PARAMS12), use_tpu=True, device_entropy=True)
    return root


def test_scheme12_writer_bytes_match_jax(tmp_path, jax_files_s12):
    data, dark = _fixture(SHAPE12)
    _write(port.ReCoDeWriter, tmp_path, data, dark, _params(**PARAMS12), device="cpu",
           device_entropy=True)
    _same_files(tmp_path, jax_files_s12, PARTS[:1] + ["test_data.rc1"])


def test_scheme12_read_frames_dense_matches_jax_reader(jax_files_s12):
    data, dark = _fixture(SHAPE12)
    merged = str(jax_files_s12 / "test_data.rc1")
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    jreader = JaxReader(merged)
    jreader.open()
    jreader._force_device_codec = True
    try:
        want = _residuals(data, dark)
        for kwargs in ({}, {"verify": True}, {"use_tpu": False}):
            assert np.array_equal(reader.read_frames_dense(0, SHAPE12[0], **kwargs), want), kwargs
        assert np.array_equal(reader.read_frames_dense(1, 2), jreader.read_frames_dense(1, 2))
    finally:
        reader.close()
        jreader.close()


def _streams_of(merged):
    """(bitmap stream, value stream) of every frame of a merged file."""
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    pairs = []
    for z in range(reader.get_shape()[0]):
        raw = reader.get_next_frame_raw()[z]["data"]
        pairs.append((raw["binary_map"], raw["pixvals"]))
    reader.close()
    return pairs


def test_scheme12_device_coded_fixture_reads_through_the_gap_chain(tmp_path, monkeypatch):
    """Frames of ~70000 foreground pixels: the device coders engage (1024
    lanes, gap bitmaps, symbol values) and the reader takes the gap chain,
    exact; verify=True and the host path agree, and so does the JAX
    reader's host path."""
    rng = np.random.default_rng(7)
    shape = (2, 1024, 1024)
    dark = rng.integers(0, 30, shape[1:]).astype(np.uint16)
    data = (dark + rng.integers(0, EPSILON + 1, shape)).astype(np.uint16)
    fg = rng.random(shape) < 0.067
    data[fg] = np.minimum(dark[None].repeat(2, 0)[fg] + EPSILON + 1
                          + rng.exponential(6.0, int(fg.sum())).astype(np.int64), 4095)
    merged = _write(port.ReCoDeWriter, tmp_path, data, dark,
                    _params(shape=shape, num_threads=1, compression_scheme=12),
                    device="cpu", device_entropy=True)
    for bm, pv in _streams_of(merged):
        assert trans._parse_header(bm)["gap"] and trans._parse_header(bm)["nways"] == 1024
        assert trans._parse_header(pv)["sym_bits"] == 12
        assert trans._parse_header(pv)["nways"] == 1024

    calls = []
    chain = trans.gap_chain_dense
    monkeypatch.setattr(trans, "gap_chain_dense",
                        lambda *a: calls.append(1) or chain(*a))
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    jreader = JaxReader(merged)
    jreader.open()
    try:
        want = _residuals(data, dark)
        assert np.array_equal(reader.read_frames_dense(0, 2), want)
        assert calls == [1]
        assert np.array_equal(reader.read_frames_dense(0, 2, verify=True), want)
        assert np.array_equal(reader.read_frames_dense(0, 2, use_tpu=False), want)
        assert np.array_equal(jreader.read_frames_dense(0, 2, use_tpu=False), want)
        assert calls == [1]
    finally:
        reader.close()
        jreader.close()


def test_one_symbol_alphabet_value_stream_reads_through_both_readers(tmp_path):
    """Frames of ~73000 identical residuals: the device symbol coder meets a
    one-symbol alphabet (f = 4096) and writes an empty body, as the numpy
    contract does.  The JAX Pallas kernel writes 2 bytes a symbol there and
    its writer then stores the stream, so these part files are not the JAX
    writer's; the stream reads exactly through the port's reader and the
    JAX reader."""
    rng = np.random.default_rng(11)
    shape = (2, 1024, 1024)
    dark = rng.integers(0, 30, shape[1:]).astype(np.uint16)
    data = np.broadcast_to(dark, shape).copy()
    data[rng.random(shape) < 0.07] += EPSILON + 5
    merged = _write(port.ReCoDeWriter, tmp_path, data, dark,
                    _params(shape=shape, num_threads=1, compression_scheme=12),
                    device="cpu", device_entropy=True)
    for _, pv in _streams_of(merged):
        h = trans._parse_header(pv)
        assert h["nways"] == 1024 and h["m"] >= 65536 and h["body"] == b""
        assert np.count_nonzero(h["freq"]) == 1
    want = _residuals(data, dark)
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    jreader = JaxReader(merged)
    jreader.open()
    try:
        for kwargs in ({}, {"verify": True}, {"use_tpu": False}):
            assert np.array_equal(reader.read_frames_dense(0, 2, **kwargs), want), kwargs
        assert np.array_equal(jreader.read_frames_dense(0, 2, use_tpu=False), want)
    finally:
        reader.close()
        jreader.close()
