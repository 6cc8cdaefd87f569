"""Scheme-12 device entropy of 8-bit L1 values: the port's writer codes the
packed values as 8-bit symbols where they lie (the rANS kernels' twins
here), as its host path and the JAX host path code them.

The JAX writer's device branch codes these value streams with the bitmap's
positions and writes unreadable streams (ROADMAP Queue 3), so the port is
judged three ways: its bitmap streams equal the JAX device writer's
(interpret mode) on the same input; every value stream decodes through the
host ``rans.decompress`` to its raw stream; the merged file reads back
exactly through the port's reader and the JAX reader.  A second fixture at
~30% foreground of 512^2 frames holds more than 65536 values a frame,
where the device symbol coder engages (1024 lanes) instead of the host
coder it hands short streams to.
"""

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu.reader import ReCoDeReader as JaxReader
from pyrecode_tpu.reader import merge_parts
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch import oracle
from pyrecode_tpu_torch.codecs import rans as trans
from pyrecode_tpu_torch.ops.encode import encode_frames_auto
from test_torch_slice import EPSILON, _params

MERGED = "test_data.rc1"


def _frames(shape, density, seed):
    """8-bit frames: dark 0..29 plus noise at or below dark + EPSILON, a
    foreground above it with peaked (compressible) residuals, up to 255."""
    rng = np.random.default_rng(seed)
    dark = rng.integers(0, 30, shape[1:]).astype(np.uint8)
    data = (dark + rng.integers(0, EPSILON + 1, shape)).astype(np.int64)
    fg = rng.random(shape) < density
    base = np.broadcast_to(dark, shape)[fg].astype(np.int64)
    data[fg] = np.minimum(base + EPSILON + 1
                          + rng.exponential(6.0, int(fg.sum())).astype(np.int64), 255)
    return data.astype(np.uint8), dark


def _write(writer_cls, out_dir, data, dark, **kwargs):
    out_dir.mkdir(parents=True, exist_ok=True)
    params = _params(shape=data.shape, num_threads=1, compression_scheme=12,
                     source_bit_depth=8, target_bit_depth=8)
    w = writer_cls("test_data", dark_data=dark, output_directory=str(out_dir),
                   input_params=params, mode="batch", node_id=0,
                   buffer_size_in_frames=data.shape[0], **kwargs)
    w.start()
    w.run(data)
    w.close()
    return merge_parts(str(out_dir), MERGED, 1)


def _records(merged):
    reader = port.ReCoDeReader(str(merged), device="cpu")
    reader.open()
    records = [reader.get_next_frame_raw()[z]["data"] for z in range(reader.get_shape()[0])]
    reader.close()
    return records


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(data, dark, the port's merged file, the JAX device writer's records):
    one batch of two 256^2 frames at ~10% foreground."""
    data, dark = _frames((2, 256, 256), 0.1, seed=81)
    root = tmp_path_factory.mktemp("rans8_small")
    merged = _write(port.ReCoDeWriter, root / "port", data, dark, device="cpu",
                    device_entropy=True)
    jax_merged = _write(JaxWriter, root / "jax", data, dark, use_tpu=True, device_entropy=True)
    return data, dark, merged, _records(jax_merged)


@pytest.fixture(scope="module")
def large(tmp_path_factory):
    """(data, dark, the port's merged file, None): one batch of two 512^2
    frames at ~30% foreground, where the device symbol coder engages."""
    data, dark = _frames((2, 512, 512), 0.3, seed=82)
    root = tmp_path_factory.mktemp("rans8_large")
    return data, dark, _write(port.ReCoDeWriter, root, data, dark, device="cpu",
                              device_entropy=True), None


@pytest.fixture(params=["small", "large"])
def written(request):
    return request.getfixturevalue(request.param)


def test_writer_takes_8bit_device_entropy(tmp_path):
    data, dark = _frames((2, 16, 16), 0.2, seed=80)
    w = port.ReCoDeWriter("x", dark_data=dark, output_directory=str(tmp_path),
                          input_params=_params(shape=data.shape, num_threads=1,
                                               compression_scheme=12, source_bit_depth=8,
                                               target_bit_depth=8),
                          device="cpu", device_entropy=True)
    assert w._device_entropy is True


def test_bitmap_streams_match_the_jax_device_writer(small):
    _, _, merged, jax_records = small
    for rec, jrec in zip(_records(merged), jax_records):
        assert rec["binary_map"] == jrec["binary_map"]


def test_every_stream_decodes_on_the_host(written):
    data, dark, merged, _ = written
    thr = (dark.astype(np.int64) + EPSILON).astype(np.uint8)
    large = data.shape[1] == 512
    for z, rec in enumerate(_records(merged)):
        enc = oracle.reduce_frame(data[z], thr, 1, 8)
        assert trans.decompress(rec["pixvals"]) == bytes(enc["packed_pixvals"])
        assert trans.decompress(rec["binary_map"]) == bytes(enc["packed_binary_map"])
        if large:   # the device symbol coder: 8-bit symbols at its lane count
            h = trans._parse_header(rec["pixvals"])
            assert h["sym_bits"] == 8 and not h["gap"]
            assert h["m"] >= 65536 and h["nways"] in trans.KERNEL_NWAYS


def test_merged_file_reads_back_exactly(written):
    data, dark, merged, _ = written
    thr = dark.astype(np.int64) + EPSILON
    want = np.where(data > thr, data - thr, 0).astype(np.uint8)
    reader = port.ReCoDeReader(str(merged), device="cpu")
    reader.open()
    jreader = JaxReader(str(merged))
    jreader.open()
    try:
        for kwargs in ({}, {"verify": True}, {"use_tpu": False}):
            assert np.array_equal(reader.read_frames_dense(0, 2, **kwargs), want), kwargs
        assert np.array_equal(jreader.read_frames_dense(0, 2, use_tpu=False), want)
    finally:
        reader.close()
        jreader.close()


def test_positions_leave_8bit_values_unchanged():
    data, dark = _frames((2, 64, 128), 0.2, seed=83)
    frames = torch.from_numpy(data.astype(np.uint16))
    thr = torch.from_numpy((dark.astype(np.int64) + EPSILON).astype(np.uint16))
    plain = encode_frames_auto(frames, thr, 1, 8, max_values=64 * 128)
    with_pos = encode_frames_auto(frames, thr, 1, 8, max_values=64 * 128, with_positions=True)
    for a, b in ((plain.bitmap, with_pos.bitmap), (plain.packed, with_pos.packed),
                 (plain.counts, with_pos.counts), (plain.packed_len, with_pos.packed_len)):
        assert torch.equal(a, b)
    mask = (data.astype(np.int64) > thr.numpy()).reshape(2, -1)
    for i in range(2):
        n = int(with_pos.counts[i])
        assert np.array_equal(with_pos.positions[i, :n].numpy(), np.flatnonzero(mask[i]))
        assert not with_pos.positions[i, n:].any()
