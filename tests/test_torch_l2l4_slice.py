"""The port's L2, L3 and L4 write -> merge -> read path on the CPU, byte
for byte against the JAX writer (``use_tpu=True``: its XLA label path for
L2/L4, the Pallas L1 kernel in interpret mode for L3) at scheme 0, with
device entropy (the twins of the deflate kernels) and with host entropy;
the reads against oracle.reduce_frame and the JAX reader; one server run.
"""

import filecmp

import numpy as np
import pytest

import pyrecode_tpu_torch as port
from chip_smoke import make_puddle_frames
from pyrecode_tpu import InitParams
from pyrecode_tpu.reader import ReCoDeReader as JaxReader
from pyrecode_tpu.reader import merge_parts
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch import oracle
from test_torch_slice import _params

SHAPE = (9, 128, 256)
NODES = 3
EPSILON = 2
# (level, L2 statistic or L4 scheme, the header's code for it)
CONFIGS = [(2, "max", 1), (2, "sum", 2), (3, None, 0), (4, "weighted_average", 1),
           (4, "unweighted", 3), (4, "max", 2)]
IDS = [f"L{level}-{name}" for level, name, _ in CONFIGS]


def _data():
    """Puddle frames at ~3% foreground, and their dark frame."""
    return make_puddle_frames(np.random.default_rng(41), *SHAPE, hits=160000)


def _level_params(level, code, num_threads=NODES, shape=SHAPE, **overrides):
    return _params(shape=shape, num_threads=num_threads, reduction_level=level,
                   calibration_threshold_epsilon=EPSILON,
                   l2_statistics=code if level == 2 else 0,
                   l4_centroiding=code if level == 4 else 0, **overrides)


def _write(writer_cls, out_dir, level, code, **kwargs):
    data, dark = _data()
    params = _level_params(level, code)
    out_dir.mkdir(parents=True, exist_ok=True)
    for node_id in range(NODES):
        w = writer_cls("test_data", dark_data=dark, output_directory=str(out_dir),
                       input_params=params, mode="batch", node_id=node_id,
                       buffer_size_in_frames=2, **kwargs)
        w.start()
        w.run(data)
        w.close()
    return merge_parts(str(out_dir), f"test_data.rc{level}", NODES)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX writer's part files and merged container of each config."""
    root = tmp_path_factory.mktemp("jax_l2l4")
    for level, name, code in CONFIGS:
        _write(JaxWriter, root / f"L{level}-{name}", level, code, use_tpu=True)
    return root


def _names(level):
    return [f"test_data.rc{level}_part{i:03d}" for i in range(NODES)] + [f"test_data.rc{level}"]


@pytest.mark.parametrize("device_entropy", [True, False])
@pytest.mark.parametrize("level,name,code", CONFIGS, ids=IDS)
def test_part_files_match_jax(tmp_path, jax_files, level, name, code, device_entropy):
    w_dir = tmp_path / "port"
    _write(port.ReCoDeWriter, w_dir, level, code, device="cpu", device_entropy=device_entropy)
    for f in _names(level):
        assert filecmp.cmp(w_dir / f, jax_files / f"L{level}-{name}" / f, shallow=False), f


@pytest.mark.parametrize("level,name,code", CONFIGS, ids=IDS)
def test_read_matches_oracle_and_jax(jax_files, level, name, code):
    """read_frames_dense gives each frame's reduced bitmap as 0/1 pixels
    (oracle.reduce_frame's, also past the TPU kernel's halo); at L2
    get_frame's summary_stats are the oracle's statistics."""
    data, dark = _data()
    thr = dark + EPSILON
    merged = str(jax_files / f"L{level}-{name}" / f"test_data.rc{level}")
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    jreader = JaxReader(merged)
    jreader.open()
    try:
        dense = reader.read_frames_dense(0, SHAPE[0])
        assert np.array_equal(dense, jreader.read_frames_dense(0, SHAPE[0]))
        for z in range(SHAPE[0]):
            enc = oracle.reduce_frame(data[z], thr, level, 12, l2_statistic=name or "max",
                                      l4_scheme=name or "weighted_average")
            want = oracle.unpack_binary_frame(enc["packed_binary_map"], SHAPE[1] * SHAPE[2])
            assert np.array_equal(dense[z].reshape(-1), want), z
            if level == 2:
                labels, num = oracle.label_components(data[z] > thr)
                stats = np.minimum(oracle.l2_summary_stats(labels, data[z], num, name), 4095)
                assert np.array_equal(reader.get_frame(z)[z]["summary_stats"], stats), z
    finally:
        reader.close()
        jreader.close()


def test_server_l4_matches_jax(tmp_path, jax_files):
    data, dark = _data()
    init_params = InitParams("batch", str(tmp_path), image_filename="test_data",
                             log_filename=str(tmp_path / "recode.log"), run_name="port_l4")
    params = _level_params(4, 1)
    metrics = port.ReCoDeServer("batch", device="cpu").run(init_params, input_params=params,
                                                           dark_data=dark, data=data)
    assert sum(m["run_frames"] for m in metrics.values()) == SHAPE[0]
    merged = merge_parts(str(tmp_path), "test_data.rc4", NODES)
    assert filecmp.cmp(merged, jax_files / "L4-weighted_average" / "test_data.rc4", shallow=False)
