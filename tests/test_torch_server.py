"""The port's server on the CPU against the JAX package's: stream mode, node
replacement with part-file resume, stream replacement, real SEQ chunks, an
MRC source, validation frames, and crash-isolated process nodes
(``isolation="process"``), batch and with a SIGKILLed worker in stream mode.

Both servers run on the same source path, so the header's source-path field
agrees, and the merged containers are compared byte for byte.  The port runs
its device path on the CPU (``device="cpu"``: the kernels' plain twins); the
JAX package runs its host path (``use_tpu=False``), which writes the same
bytes as its device path.  Process workers must never initialise CUDA.
"""

import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import pyrecode_tpu as jax_pkg
import pyrecode_tpu_torch as port
from pyrecode_tpu.reader import merge_parts as jax_merge_parts
from pyrecode_tpu.server import ReCoDeServer as JaxServer
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch.constants import rc_cfg as rc
from pyrecode_tpu_torch.em_reader import write_mrc, write_seq

CPU = "cpu"


def _fixture(shape, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4096, size=shape).astype(np.int64) - 3500
    data[data < 0] = 0
    return data.astype(np.uint16)


def _param_values(shape, num_threads, **overrides):
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[2], num_rows=shape[1],
        num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=num_threads,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=0, target_data_type=0)
    values.update(overrides)
    return values


def _params(pkg, shape, num_threads, **overrides):
    p = pkg.InputParams(_param_values(shape, num_threads, **overrides))
    assert p.validate()
    return p


def _run_both(tmp_path, mode, shape, num_threads, init_kwargs, run_kwargs=None,
              drop_chunks=None, isolation=("thread", "thread"), port_faults=None, **overrides):
    """Run the port's server and the JAX server on the same source path; return
    {"port": (out dir, metrics, server), "jax": (...)}.  ``port_faults`` (the
    ``fail_node_*`` arguments) go to the port's run alone: its recovered
    container must equal the JAX server's run without a fault."""
    results = {}
    for name, pkg, server_cls, iso in (("port", port, port.ReCoDeServer, isolation[0]),
                                       ("jax", jax_pkg, JaxServer, isolation[1])):
        out = tmp_path / f"out_{name}"
        out.mkdir()
        if drop_chunks is not None:
            drop_chunks()
        init = pkg.InitParams(mode, str(out), log_filename=str(out / "recode.log"),
                              verbosity=0, use_tpu=name == "port", **init_kwargs)
        kwargs = dict(device=CPU) if name == "port" else {}
        server = server_cls(mode, isolation=iso, **kwargs)
        faults = (port_faults or {}) if name == "port" else {}
        metrics = server.run(init, input_params=_params(pkg, shape, num_threads, **overrides),
                             **(run_kwargs or {}), **faults)
        results[name] = (out, metrics, server)
    return results


def _merged_equal(results, base, num_parts, expected):
    merged = {}
    for name, merge in (("port", port.merge_parts), ("jax", jax_merge_parts)):
        out = results[name][0]
        merged[name] = Path(merge(str(out), base, num_parts)).read_bytes()
    assert merged["port"] == merged["jax"]
    reader = port.ReCoDeReader(str(results["port"][0] / base), device=CPU)
    reader.open()
    assert reader.get_shape()[0] == len(expected)
    assert np.array_equal(reader.read_frames_dense(0, len(expected)), expected)
    reader.close()


def _drop(watch: Path, chunks, writer=None, first=0):
    def drop():
        watch.mkdir(exist_ok=True)
        for i, chunk in enumerate(chunks, start=first):
            path = watch / f"chunk_{i:03d}.seq"
            if writer is None:
                path.write_bytes(chunk.tobytes())
            else:
                writer(path, chunk)
            time.sleep(0.02)
    return drop


def test_stream_server(tmp_path):
    """test_server.py:71 on the port: two raw chunks dropped in a watch dir."""
    shape = (4, 64, 64)
    chunks = [_fixture(shape, 1), _fixture(shape, 2)]
    watch = tmp_path / "acquisition"
    results = _run_both(tmp_path, "stream", shape, 2,
                        dict(image_filename="ignored", directory_path=str(watch),
                             run_name="stream_test", max_count=2, chunk_time_in_sec=1),
                        run_kwargs=dict(dark_data=np.zeros(shape[1:], np.uint16)),
                        drop_chunks=_drop(watch, chunks))
    _merged_equal(results, "stream_test.rc1", 2, np.concatenate(chunks))


def test_replacement_node_recovers_failed_slice(tmp_path):
    """test_server.py:135: a node that dies in process_file is replaced and its
    slice re-encoded from the part file's header on; the container equals
    the JAX server's."""
    data = _fixture((6, 64, 64), 3)
    results = _run_both(tmp_path, "batch", data.shape, 2,
                        dict(image_filename="test_data", run_name="recovery"),
                        run_kwargs=dict(dark_data=np.zeros(data.shape[1:], np.uint16), data=data),
                        port_faults=dict(fail_node_ids={1}, fail_node_on_command="process_file"))
    _merged_equal(results, "test_data.rc1", 2, data)
    assert "replacement" in (results["port"][0] / "recode.log").read_text()


def test_stream_replacement_preserves_earlier_chunks(tmp_path):
    """test_server.py:161: a stream node that dies on chunk 2 is replaced
    without truncating its part file, and frame ids continue."""
    shape = (4, 64, 64)
    chunks = [_fixture(shape, 10 + i) for i in range(3)]
    watch = tmp_path / "acquisition"
    results = _run_both(tmp_path, "stream", shape, 2,
                        dict(image_filename="ignored", directory_path=str(watch),
                             run_name="stream_rec", max_count=3, chunk_time_in_sec=1),
                        run_kwargs=dict(dark_data=np.zeros(shape[1:], np.uint16)),
                        port_faults=dict(fail_node_ids={1},
                                         fail_node_on_command=("process_file", 2)),
                        drop_chunks=_drop(watch, chunks))
    _merged_equal(results, "stream_rec.rc1", 2, np.concatenate(chunks))
    log = (results["port"][0] / "recode.log").read_text()
    assert "replacement" in log and "resumed" in log


def test_stream_server_real_seq_chunks(tmp_path):
    """test_server.py:200: StreamPix v5 chunks of int16 frames, 15 bits."""
    shape = (3, 64, 64)
    rng = np.random.default_rng(20)
    chunks = [(rng.integers(0, 500, shape) * (rng.random(shape) < 0.05)).astype(np.int16)
              for _ in range(2)]
    watch = tmp_path / "acquisition"
    results = _run_both(tmp_path, "stream", shape, 2,
                        dict(image_filename="ignored", directory_path=str(watch),
                             run_name="seq_stream", max_count=2, chunk_time_in_sec=1),
                        run_kwargs=dict(dark_data=np.zeros(shape[1:], np.int16)),
                        drop_chunks=_drop(watch, chunks, write_seq),
                        source_file_type=2, source_data_type=1, target_data_type=1,
                        target_bit_depth=15, source_bit_depth=15, source_header_length=1024)
    _merged_equal(results, "seq_stream.rc1", 2, np.concatenate(chunks))


def test_batch_server_validation_frames(tmp_path):
    """test_server.py:38 with ``validation_frame_gap``: the part files, the
    validation frames and the log of three nodes."""
    data = _fixture((9, 64, 64), 0)
    results = _run_both(tmp_path, "batch", data.shape, 3,
                        dict(image_filename="test_data", run_name="server_test",
                             validation_frame_gap=2),
                        run_kwargs=dict(dark_data=np.zeros(data.shape[1:], np.uint16), data=data))
    metrics = results["port"][1]
    assert set(metrics) == {0, 1, 2} and sum(m["run_frames"] for m in metrics.values()) == 9
    names = sorted(p.name for p in results["jax"][0].iterdir() if p.name != "recode.log")
    assert len([n for n in names if n.endswith("_validation_frames.bin")]) == 3
    for name in names:
        assert (results["port"][0] / name).read_bytes() == \
            (results["jax"][0] / name).read_bytes(), name
    _merged_equal(results, "test_data.rc1", 3, data)
    log = (results["port"][0] / "recode.log").read_text()
    assert "session" in log and "writer closed" in log


def test_writer_with_mrc_source(tmp_path):
    """test_em_reader.py:155: the writer reads a real MRC stack; the source
    header is kept in the container."""
    data = np.arange(3 * 8 * 8, dtype=np.uint16).reshape(3, 8, 8)
    path = tmp_path / "stack.mrc"
    write_mrc(path, data)
    dark = np.zeros((8, 8), np.uint16)
    merged = {}
    for name, pkg, writer_cls, merge, kwargs in (
            ("port", port, port.ReCoDeWriter, port.merge_parts, dict(device=CPU)),
            ("jax", jax_pkg, JaxWriter, jax_merge_parts, {})):
        out = tmp_path / name
        out.mkdir()
        params = _params(pkg, data.shape, 1, target_bit_depth=16, source_bit_depth=16,
                         source_file_type=rc.FILE_TYPE_MRC)
        w = writer_cls(str(path), dark_data=dark, output_directory=str(out),
                       input_params=params, **kwargs)
        w.start()
        w.run()
        w.close()
        merged[name] = merge(str(out), "stack.rc1", 1)
    assert Path(merged["port"]).read_bytes() == Path(merged["jax"]).read_bytes()
    reader = port.ReCoDeReader(merged["port"], device=CPU)
    reader.open()
    assert reader.get_source_header()[208:212] == b"MAP "
    for i in range(3):
        assert np.array_equal(reader.get_next_frame()[i]["data"].todense(), data[i]), i
    reader.close()


# ----------------------------------------------- crash-isolated process mode


def test_process_isolation_batch_roundtrip(tmp_path):
    """test_server.py:249: nodes are spawned processes on the host path; the
    container equals the JAX server's in process mode and the port's thread
    mode's, and no worker initialised CUDA."""
    data = _fixture((6, 64, 64), 31)
    results = _run_both(tmp_path, "batch", data.shape, 2,
                        dict(image_filename="test_data", run_name="proc_batch"),
                        run_kwargs=dict(dark_data=np.zeros(data.shape[1:], np.uint16), data=data),
                        isolation=("process", "process"))
    out, metrics, server = results["port"]
    assert sum(m["run_frames"] for m in metrics.values()) == 6
    assert [m["cuda_initialized"] for m in metrics.values()] == [False, False]
    pids = [node.pid for node in server._nodes]
    assert all(isinstance(p, int) for p in pids) and os.getpid() not in pids
    assert len(set(pids)) == 2
    _merged_equal(results, "test_data.rc1", 2, data)

    thread_out = tmp_path / "out_thread"
    thread_out.mkdir()
    port.ReCoDeServer("batch", device=CPU).run(
        port.InitParams("batch", str(thread_out), image_filename="test_data",
                        log_filename=str(thread_out / "recode.log"), run_name="proc_batch"),
        input_params=_params(port, data.shape, 2),
        dark_data=np.zeros(data.shape[1:], np.uint16), data=data)
    assert Path(port.merge_parts(str(thread_out), "test_data.rc1", 2)).read_bytes() == \
        (out / "test_data.rc1").read_bytes()


def test_process_isolation_sigkill_stream(tmp_path):
    """test_server.py:275: a SIGKILLed worker does not take down the head; the
    head spawns a replacement process that resumes the part file at the
    completed-chunk boundary, and the merged container is complete and equal
    to the JAX server's uninterrupted stream run.  The later chunks arrive
    after the kill, so the victim is always an idle worker between chunks."""
    shape = (4, 64, 64)
    chunks = [_fixture(shape, 40 + i) for i in range(3)]
    watch = tmp_path / "acquisition"
    dark = np.zeros(shape[1:], np.uint16)

    jax_out = tmp_path / "out_jax"
    jax_out.mkdir()
    _drop(watch, chunks)()
    JaxServer("stream").run(
        jax_pkg.InitParams("stream", str(jax_out), image_filename="ignored",
                           directory_path=str(watch), log_filename=str(jax_out / "recode.log"),
                           run_name="proc_sigkill", max_count=3, chunk_time_in_sec=1,
                           use_tpu=False),
        input_params=_params(jax_pkg, shape, 2), dark_data=dark)

    out = tmp_path / "out_port"
    out.mkdir()
    _drop(watch, chunks[:1])()
    server = port.ReCoDeServer("stream", isolation="process", device=CPU)
    result = {}

    def run():
        result["metrics"] = server.run(
            port.InitParams("stream", str(out), image_filename="ignored",
                            directory_path=str(watch), log_filename=str(out / "recode.log"),
                            run_name="proc_sigkill", max_count=3, chunk_time_in_sec=1),
            input_params=_params(port, shape, 2), dark_data=dark)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    # wait until the first chunk is fully processed, then SIGKILL node 1
    deadline = time.monotonic() + 120
    while getattr(server, "_stream_chunk_offset", 0) < shape[0]:
        assert time.monotonic() < deadline, "stream never processed chunk 1"
        assert t.is_alive(), "server ended before chunk 1 was processed"
        time.sleep(0.01)
    victim = server._nodes[1]
    assert victim.pid is not None
    os.kill(victim.pid, signal.SIGKILL)
    _drop(watch, chunks[1:], first=1)()
    t.join(timeout=180)
    assert not t.is_alive(), "server did not finish after worker SIGKILL"

    assert server._nodes[1].pid != victim.pid
    assert [m.get("cuda_initialized") for m in result["metrics"].values()] == [False, False]
    results = {"port": (out, None, server), "jax": (jax_out, None, None)}
    _merged_equal(results, "proc_sigkill.rc1", 2, np.concatenate(chunks))
    assert "replacement" in (out / "recode.log").read_text()


@pytest.mark.parametrize("isolation", ["thread", "process"])
def test_isolation_modes_construct(isolation):
    server = port.ReCoDeServer("batch", isolation=isolation, device=CPU)
    assert server._isolation == isolation
    with pytest.raises(ValueError):
        port.ReCoDeServer("batch", isolation="fiber", device=CPU)
