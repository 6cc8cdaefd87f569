"""The port's main path end to end on the CPU: writer -> part files ->
merge_parts -> reader, and the server in thread mode, byte for byte
against the JAX package (its writer with ``use_tpu=True`` runs the Pallas
kernels in interpret mode here), for scheme 0 and scheme 12.
"""

import filecmp
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu import InitParams, InputParams
from pyrecode_tpu.reader import ReCoDeReader as JaxReader
from pyrecode_tpu.reader import merge_parts
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter

REPO = Path(__file__).resolve().parent.parent
SHAPE = (9, 128, 128)
EPSILON = 10
NODES = 3


def _fixture(shape=SHAPE, seed=0):
    """The test_roundtrip fixture, with a nonzero dark frame."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4096, size=shape).astype(np.int64) - 3500
    data[data < 0] = 0
    dark = rng.integers(0, 50, size=shape[1:]).astype(np.uint16)
    return data.astype(np.uint16), dark


def _params(shape=SHAPE, num_threads=NODES, **overrides):
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=EPSILON,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[2], num_rows=shape[1],
        num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=num_threads,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=0, target_data_type=0,
    )
    values.update(overrides)
    p = InputParams(values)
    assert p.validate()
    return p


def _write(writer_cls, out_dir, data, dark, params, **kwargs):
    out_dir.mkdir(parents=True, exist_ok=True)
    for node_id in range(params.num_threads):
        w = writer_cls("test_data", dark_data=dark, output_directory=str(out_dir),
                       input_params=params, mode="batch", node_id=node_id,
                       buffer_size_in_frames=3, **kwargs)
        w.start()
        w.run(data)
        w.close()
    return merge_parts(str(out_dir), "test_data.rc1", params.num_threads)


def _same_files(a: Path, b: Path, names):
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def _residuals(data, dark):
    thr = dark.astype(np.int64) + EPSILON
    return np.where(data > thr, data - thr, 0).astype(np.uint16)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Part files and merged containers of the JAX writer (mode 1 and 0)."""
    data, dark = _fixture()
    root = tmp_path_factory.mktemp("jax")
    for mode in (1, 0):
        _write(JaxWriter, root / f"mode{mode}", data, dark, _params(rc_operation_mode=mode),
               use_tpu=True)
    return root


PARTS = [f"test_data.rc1_part{i:03d}" for i in range(NODES)]


@pytest.mark.parametrize("mode", [1, 0])
def test_writer_bytes_match_jax(tmp_path, jax_files, mode):
    data, dark = _fixture()
    _write(port.ReCoDeWriter, tmp_path, data, dark, _params(rc_operation_mode=mode),
           device="cpu")
    _same_files(tmp_path, jax_files / f"mode{mode}", PARTS + ["test_data.rc1"])


def test_host_oracle_path_bytes_match_jax(tmp_path, jax_files):
    """use_tpu=False keeps the JAX writer's host oracle path."""
    data, dark = _fixture()
    _write(port.ReCoDeWriter, tmp_path, data, dark, _params(), device="cpu", use_tpu=False)
    _same_files(tmp_path, jax_files / "mode1", PARTS + ["test_data.rc1"])


@pytest.mark.parametrize("mode", [1, 0])
def test_read_frames_dense_matches_jax_reader(jax_files, mode):
    data, dark = _fixture()
    merged = str(jax_files / f"mode{mode}" / "test_data.rc1")
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    jreader = JaxReader(merged)
    jreader.open()
    try:
        got = reader.read_frames_dense(0, SHAPE[0])
        assert got.dtype == np.uint16
        assert np.array_equal(got, _residuals(data, dark))
        assert np.array_equal(reader.read_frames_dense(2, 4), jreader.read_frames_dense(2, 4))
        assert np.array_equal(reader.read_frames_dense(0, 3, use_tpu=False), got[:3])
    finally:
        reader.close()
        jreader.close()


def test_server_thread_mode_bytes_match_jax(tmp_path, jax_files):
    data, dark = _fixture()
    init_params = InitParams("batch", str(tmp_path), image_filename="test_data",
                             log_filename=str(tmp_path / "recode.log"), run_name="port_test")
    server = port.ReCoDeServer("batch", device="cpu")
    metrics = server.run(init_params, input_params=_params(), dark_data=dark, data=data)
    assert sum(m["run_frames"] for m in metrics.values()) == SHAPE[0]
    merged = merge_parts(str(tmp_path), "test_data.rc1", NODES)
    assert filecmp.cmp(merged, jax_files / "mode1" / "test_data.rc1", shallow=False)
    assert "writer closed" in (tmp_path / "recode.log").read_text()


def test_slice_never_imports_jax(tmp_path):
    """A scheme-0 server slice and a scheme-12 device-entropy slice on the
    CPU import neither JAX nor any module of the JAX package."""
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import pyrecode_tpu_torch as port
        rng = np.random.default_rng(1)
        data = np.where(rng.random((4, 32, 64)) < 0.05,
                        rng.integers(40, 4096, (4, 32, 64)), 0).astype(np.uint16)
        dark = rng.integers(0, 30, (32, 64)).astype(np.uint16)
        thr = dark.astype(np.int64) + 3
        out = {str(tmp_path)!r}
        for scheme in (0, 12):
            params = port.InputParams(dict(
                reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=3,
                target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=32,
                num_frames=4, frame_offset=0, num_calibration_frames=1,
                calibration_frame_offset=0, keep_part_files=0, num_threads=2,
                l2_statistics=0, l4_centroiding=0, compression_scheme=scheme,
                compression_level=1, source_file_type=0, source_header_length=0,
                keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
                target_data_type=0))
            assert params.validate()
            name = f"s{{scheme}}"
            if scheme == 0:
                init = port.InitParams("batch", out, image_filename=name,
                                       log_filename=out + "/log")
                port.ReCoDeServer("batch", device="cpu").run(init, params, dark_data=dark,
                                                             data=data)
            else:
                for node in range(2):
                    w = port.ReCoDeWriter(name, dark_data=dark, output_directory=out,
                                          input_params=params, node_id=node, device="cpu",
                                          device_entropy=True)
                    w.start()
                    w.run(data)
                    w.close()
            reader = port.ReCoDeReader(port.merge_parts(out, name + ".rc1", 2), device="cpu")
            reader.open()
            assert np.array_equal(reader.read_frames_dense(0, 4),
                                  np.where(data > thr, data - thr, 0))
        print("jax" in sys.modules,
              any(m == "pyrecode_tpu" or m.startswith("pyrecode_tpu.") for m in sys.modules))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False False"


def test_port_sources_never_import_the_jax_package():
    """No file of the port, and not chip_smoke.py, imports pyrecode_tpu."""
    pattern = re.compile(r"^\s*(from|import)\s+pyrecode_tpu(\.|\s|$)", re.M)
    files = sorted((REPO / "pyrecode_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, dark = _fixture(shape=(2, 16, 16))
    with pytest.raises(RuntimeError, match="cuda"):
        port.ReCoDeWriter("x", dark_data=dark, output_directory=str(tmp_path),
                          input_params=_params(shape=(2, 16, 16)))
    with pytest.raises(RuntimeError, match="cuda"):
        port.ReCoDeReader("x")
    with pytest.raises(RuntimeError, match="cuda"):
        port.ReCoDeServer("batch")
    with pytest.raises(ValueError):
        port.ReCoDeReader("x", device="meta")


def test_cuda_default_device_entropy_without_the_host_library(tmp_path, monkeypatch):
    """device_entropy=None on CUDA keeps scheme-12 device entropy when the
    native host library is missing (the rANS stage does not use it) and
    raises for scheme 0, whose Huffman tables need it, instead of coding on
    the host."""
    monkeypatch.setattr(port.native, "available", lambda: False)
    dark = _fixture(shape=(2, 16, 16))[1]

    def cuda_writer(scheme):
        w = port.ReCoDeWriter("x", dark_data=dark, output_directory=str(tmp_path),
                              input_params=_params(shape=(2, 16, 16), num_threads=1,
                                                   compression_scheme=scheme),
                              device="cpu", device_entropy=False)
        w._device = torch.device("cuda")
        return w

    assert cuda_writer(12)._resolve_device_entropy(None) is True
    with pytest.raises(RuntimeError, match="host library"):
        cuda_writer(0)._resolve_device_entropy(None)
    with pytest.raises(RuntimeError, match="host library"):
        cuda_writer(0)._resolve_device_entropy(True)
    assert cuda_writer(0)._resolve_device_entropy(False) is False


def test_unported_options_raise(tmp_path):
    data, dark = _fixture(shape=(2, 16, 16))
    params = _params(shape=(2, 16, 16), num_threads=1)

    def writer(**overrides):
        return port.ReCoDeWriter("x", dark_data=dark, output_directory=str(tmp_path),
                                 input_params=_params(shape=(2, 16, 16), num_threads=1,
                                                      **overrides),
                                 device="cpu", device_entropy=True)

    # process isolation constructs, runs and reports its workers' pids
    server = port.ReCoDeServer("batch", isolation="process", device="cpu")
    server.run(port.InitParams("batch", str(tmp_path), image_filename="x",
                               log_filename=str(tmp_path / "recode.log")),
               input_params=port.InputParams(dict(params._param_map, num_threads=2)),
               dark_data=dark, data=data)
    pids = [node.pid for node in server._nodes]
    assert len(set(pids)) == 2 and all(isinstance(p, int) and p != os.getpid() for p in pids)
    assert writer()._device_entropy is True
    assert writer(compression_scheme=12)._device_entropy is True
    # scheme-12 device entropy of L2-L4 codes gaps from the bitmap -> positions kernel
    assert writer(compression_scheme=12, reduction_level=3)._device_entropy is True
    assert writer(compression_scheme=12, reduction_level=2, source_bit_depth=8,
                  target_bit_depth=8)._device_entropy is True
    # 8-bit L1 values are 8-bit symbols; 13..16 bits take the gap coder, as
    # the JAX writer's XLA path codes them
    assert writer(compression_scheme=12, source_bit_depth=8,
                  target_bit_depth=8)._device_entropy is True
    assert writer(compression_scheme=12, source_bit_depth=13,
                  target_bit_depth=13)._device_entropy is True
    assert port.ReCoDeWriter("x", dark_data=dark, output_directory=str(tmp_path),
                             input_params=_params(shape=(2, 16, 16), num_threads=1,
                                                  reduction_level=2),
                             device="cpu")._reduction_level == 2
    w = port.ReCoDeWriter("x", dark_data=dark, output_directory=str(tmp_path),
                          input_params=params, device="cpu")
    w.start()
    assert w.run(data, profile_dir=str(tmp_path / "trace"))["run_frames"] == 2
    w.close()
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1
    # scheme-12 reads run on the device path now (the twins on the CPU)
    merged = _write(JaxWriter, tmp_path / "s12", data, dark,
                    _params(shape=(2, 16, 16), num_threads=1, compression_scheme=12),
                    use_tpu=False)
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    assert np.array_equal(reader.read_frames_dense(0, 2), _residuals(data, dark))
    assert np.array_equal(reader.read_frames_dense(0, 2, use_tpu=False), _residuals(data, dark))
    reader.close()
