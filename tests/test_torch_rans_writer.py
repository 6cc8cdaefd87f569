"""The port's scheme-12 writer against the JAX writer at a size where the
device coders engage, byte for byte.

Four 1024x1024 frames in batches of two.  The first batch holds frames of
~70000 foreground pixels: their bitmaps are coded as gaps from the encode's
positions and their values as 12-bit symbols, 1024 lanes each.  The second
batch holds a frame at ~14% foreground, whose set bits outnumber the
bitmap's bytes, so that batch's bitmaps all take the 8-bit symbol mode.
The JAX writer (``use_tpu=True, device_entropy=True``) runs its Pallas
kernels in interpret mode here, about 50 s.

The densities stay where the JAX encode kernel's per-sub-row capacity
ladder (32, 64 or 128 values in 512 pixels) settles without re-encoding a
batch on the host: that fallback is a limit of the TPU kernel, which the
port does not have, and it writes host-coded streams.
"""

import filecmp

import numpy as np
import pytest

import pyrecode_tpu_torch as port
from pyrecode_tpu.reader import ReCoDeReader as JaxReader
from pyrecode_tpu.reader import merge_parts
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch import oracle
from pyrecode_tpu_torch.codecs import rans as trans
from test_torch_slice import EPSILON, _params, _residuals

SHAPE = (4, 1024, 1024)
DENSITY = (0.067, 0.067, 0.14, 0.067)
PART = "test_data.rc1_part000"
MERGED = "test_data.rc1"


def _frames():
    rng = np.random.default_rng(23)
    dark = rng.integers(0, 30, SHAPE[1:]).astype(np.uint16)
    data = (dark + rng.integers(0, EPSILON + 1, SHAPE)).astype(np.uint16)
    fg = rng.random(SHAPE) < np.array(DENSITY)[:, None, None]
    base = np.broadcast_to(dark, SHAPE)[fg].astype(np.int64)
    data[fg] = np.minimum(base + EPSILON + 1
                          + rng.exponential(6.0, int(fg.sum())).astype(np.int64), 4095)
    return data, dark


def _write(writer_cls, out_dir, data, dark, **kwargs):
    out_dir.mkdir(parents=True, exist_ok=True)
    w = writer_cls("test_data", dark_data=dark, output_directory=str(out_dir),
                   input_params=_params(shape=SHAPE, num_threads=1, compression_scheme=12),
                   mode="batch", node_id=0, buffer_size_in_frames=2, **kwargs)
    w.start()
    w.run(data)
    w.close()
    return merge_parts(str(out_dir), MERGED, 1)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(data, dark, JAX files' directory, port files' directory)."""
    data, dark = _frames()
    root = tmp_path_factory.mktemp("s12_device")
    _write(JaxWriter, root / "jax", data, dark, use_tpu=True, device_entropy=True)
    _write(port.ReCoDeWriter, root / "port", data, dark, device="cpu", device_entropy=True)
    return data, dark, root / "jax", root / "port"


def _streams_of(merged):
    reader = port.ReCoDeReader(str(merged), device="cpu")
    reader.open()
    pairs = []
    for z in range(reader.get_shape()[0]):
        raw = reader.get_next_frame_raw()[z]["data"]
        pairs.append((raw["binary_map"], raw["pixvals"]))
    reader.close()
    return pairs


@pytest.mark.parametrize("name", [PART, MERGED])
def test_device_coded_files_match_jax(written, name):
    _, _, jax_dir, port_dir = written
    assert filecmp.cmp(port_dir / name, jax_dir / name, shallow=False), name


def test_device_coded_streams_take_the_kernel_formats(written):
    """The fixture reaches what it is meant to: gap bitmaps in the first
    batch, 8-bit symbol bitmaps in the second, 12-bit symbol values, all of
    them device-coded (1024 lanes, m >= 65536), and each decodes through
    the host rANS decoder to the frame's raw stream."""
    data, dark, _, port_dir = written
    thr = (dark.astype(np.int64) + EPSILON).astype(np.uint16)
    for z, (bm, pv) in enumerate(_streams_of(port_dir / MERGED)):
        hb, hp = trans._parse_header(bm), trans._parse_header(pv)
        assert hb["nways"] == hp["nways"] == 1024
        assert hb["m"] >= 65536 and hp["m"] >= 65536
        if z < 2:
            assert hb["gap"] and hb["sym_bits"] == 12
        else:
            assert not hb["gap"] and hb["sym_bits"] == 8
        assert hp["sym_bits"] == 12 and not hp["gap"]
        raw = oracle.reduce_frame(data[z], thr, 1, 12)
        assert trans.decompress(bm) == bytes(raw["packed_binary_map"])
        assert trans.decompress(pv) == bytes(raw["packed_pixvals"])


def test_device_coded_reads_match(written):
    """The gap chain (first batch), the symbol chain (second batch) and the
    verified byte path read the residuals exactly; so does the JAX reader."""
    data, dark, _, port_dir = written
    want = _residuals(data, dark)
    reader = port.ReCoDeReader(str(port_dir / MERGED), device="cpu")
    reader.open()
    jreader = JaxReader(str(port_dir / MERGED))
    jreader.open()
    try:
        assert np.array_equal(reader.read_frames_dense(0, 2), want[:2])
        assert np.array_equal(reader.read_frames_dense(2, 2), want[2:])
        assert np.array_equal(reader.read_frames_dense(0, 4, verify=True), want)
        assert np.array_equal(jreader.read_frames_dense(0, 4, use_tpu=False), want)
    finally:
        reader.close()
        jreader.close()
