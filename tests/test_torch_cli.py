"""The port's command line (``python -m pyrecode_tpu_torch``) against the JAX
package's on the CPU: ``server``, ``write``, ``merge``, ``read`` and
``calibrate`` in process through ``cli.main`` with ``--device cpu``, and
``python -m`` once in a subprocess.  The files the port's CLI writes are
byte-equal to the JAX CLI's with ``--no_tpu``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyrecode_tpu import cli as jax_cli
from pyrecode_tpu.em_reader import write_seq
from pyrecode_tpu_torch import InputParams, ReCoDeWriter, cli

REPO = Path(__file__).resolve().parent.parent

PARAMS = dict(
    reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
    target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64,
    num_frames=3, frame_offset=0, num_calibration_frames=1,
    calibration_frame_offset=0, keep_part_files=0, num_threads=2,
    l2_statistics=0, l4_centroiding=0, compression_scheme=0,
    compression_level=1, source_file_type=0, source_header_length=0,
    keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
    target_data_type=0)


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (n, 64, 64)), 0).astype(np.uint16)


def _files(directory: Path):
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())
            if p.is_file() and not p.name.endswith(".log")}


def test_cli_merge_and_read(tmp_path, capsys):
    data = _frames(3, 0)
    params = InputParams(dict(PARAMS))
    assert params.validate()
    for node in range(2):
        w = ReCoDeWriter("clidata", dark_data=np.zeros((64, 64), np.uint16),
                         output_directory=str(tmp_path), input_params=params, node_id=node,
                         device="cpu")
        w.start()
        w.run(data)
        w.close()
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    for node in range(2):
        name = f"clidata.rc1_part{node:03d}"
        (jax_dir / name).write_bytes((tmp_path / name).read_bytes())

    assert cli.main(["merge", "--folder", str(tmp_path), "--base", "clidata.rc1",
                     "--num_parts", "2"]) == 0
    assert "clidata.rc1" in capsys.readouterr().out
    assert jax_cli.main(["merge", "--folder", str(jax_dir), "--base", "clidata.rc1",
                         "--num_parts", "2"]) == 0
    capsys.readouterr()
    merged = tmp_path / "clidata.rc1"
    assert merged.read_bytes() == (jax_dir / "clidata.rc1").read_bytes()

    outputs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        assert main(["read", "--file", str(merged)] + extra) == 0
        assert main(["read", "--file", str(merged), "--frame", "1"] + extra) == 0
        outputs.append(capsys.readouterr().out)
    assert "3 frames of 64x64" in outputs[0] and "frame 1:" in outputs[0]
    assert f"sum={int(data[1].sum())}" in outputs[0]
    assert outputs[0] == outputs[1]


def _params_file(path: Path, **overrides):
    values = dict(PARAMS, **overrides)
    path.write_text("\n".join(f"{k} = {v}" for k, v in values.items()))
    return path


@pytest.mark.parametrize("no_tpu", [False, True])
def test_cli_write_from_file(tmp_path, no_tpu):
    data = _frames(2, 1)
    src = tmp_path / "src.bin"
    src.write_bytes(data.tobytes())
    dark = tmp_path / "dark.bin"
    dark.write_bytes(np.full((64, 64), 3, np.uint16).tobytes())
    params_file = _params_file(tmp_path / "params.txt", num_frames=2, num_threads=1)
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"] + ["--no_tpu"] * no_tpu),
                              ("jax", jax_cli.main, ["--no_tpu"])):
        out = tmp_path / name
        out.mkdir()
        assert main(["write", "--image_filename", str(src), "--calibration_file", str(dark),
                     "--out_dir", str(out), "--params_file", str(params_file),
                     "--log_file", str(out / "recode.log"), "--validation_frame_gap", "1"]
                    + extra) == 0
        outs[name] = _files(out)
    assert set(outs["port"]) == {"src.rc1_part000", "src_part000_validation_frames.bin"}
    assert outs["port"] == outs["jax"]


def test_cli_server_merge(tmp_path):
    """``server`` (batch, two thread nodes) then ``merge``: the same part files
    and container as the JAX CLI's."""
    data = _frames(5, 2)
    src = tmp_path / "acq.bin"
    src.write_bytes(data.tobytes())
    dark = tmp_path / "dark.bin"
    dark.write_bytes(np.zeros((64, 64), np.uint16).tobytes())
    params_file = _params_file(tmp_path / "params.txt", num_frames=5)
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, ["--no_tpu"])):
        out = tmp_path / name
        out.mkdir()
        assert main(["server", "--image_filename", str(src), "--calibration_file", str(dark),
                     "--out_dir", str(out), "--params_file", str(params_file),
                     "--log_file", str(out / "recode.log"), "--run_name", "cli_run"]
                    + extra) == 0
        assert main(["merge", "--folder", str(out), "--base", "acq.rc1", "--num_parts", "2"]) == 0
        outs[name] = _files(out)
    assert {"acq.rc1", "acq.rc1_part000", "acq.rc1_part001"} <= set(outs["port"])
    assert outs["port"] == outs["jax"]


def test_cli_calibrate(tmp_path, capsys):
    rng = np.random.default_rng(3)
    frames = rng.normal(100, 4, size=(24, 32, 32))
    frames += (rng.random(frames.shape) < 0.1) * rng.integers(15, 60, size=frames.shape)
    flat = tmp_path / "flat.seq"
    write_seq(flat, np.clip(np.rint(frames), 0, 4095).astype(np.uint16))
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        out = tmp_path / name
        out.mkdir()
        assert main(["calibrate", "--flatfield_filepath", str(flat), "--n_frames", "24",
                     "--n_stats_frames", "8", "--n_sigmas", "4", "--savepath", str(out),
                     "--save_prefix", "cal", "--use_acc"] + extra) == 0
        outs[name] = _files(out)
    assert "Global intensity std. dev.:" in capsys.readouterr().out
    assert set(outs["port"]) == {f"cal__dark_ref_{i}.bin" for i in ("0", "1", "2", "3", "3A")}
    assert outs["port"] == outs["jax"]


def test_python_dash_m(tmp_path, monkeypatch):
    """``python -m pyrecode_tpu_torch`` runs the CLI, with no bench subcommand;
    the default ``--device cuda`` without CUDA raises the device error."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "pyrecode_tpu_torch", "--help"],
                         capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "{server,write,merge,read,calibrate}" in out.stdout
    assert "bench" not in out.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["read", "--file", str(tmp_path / "missing.rc1")])
