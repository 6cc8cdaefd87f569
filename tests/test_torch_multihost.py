"""The port's multi-process data plane: two localhost gloo processes.

Mirrors tests/test_multihost.py.  Each child imports only the port (no JAX),
initialises a gloo process group with its address, world size and rank,
and encodes its contiguous half of the frames on a mesh of four CPU
devices; rank 0 gathers every block in rank order, and the blocks equal a
single process's.  A second pair of children each runs a full writer (device
entropy through the twins) as its node; the part files and the merged
container equal a single-process host-entropy run's, and read back exact.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from pyrecode_tpu import oracle
from pyrecode_tpu_torch import InputParams, ReCoDeReader, ReCoDeWriter, merge_parts

REPO = str(Path(__file__).resolve().parent.parent)
CHILD_TIMEOUT = 240

_PRELUDE = """
import os, pickle, sys
rank, world, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=world,
                        rank=rank)
"""

_GATHER = _PRELUDE + """
from pyrecode_tpu_torch.parallel import make_codec_mesh
from pyrecode_tpu_torch.parallel.multihost import (gather_ordered_blocks, make_encode_step,
                                                   make_entropy_steps, replicate_threshold)

rng = np.random.default_rng(0)
frames = (rng.integers(0, 4096, (8, 64, 128)).astype(np.int64) - 3500).clip(0).astype(np.uint16)
share = len(frames) // world
local = frames[rank * share:(rank + 1) * share]
mesh = make_codec_mesh(4, 1, [torch.device("cpu")] * 4)
bitmap, packed, counts, overflow = make_encode_step(mesh, out_size=2048)(
    local, replicate_threshold(np.zeros((64, 128), np.uint16), mesh))
assert not overflow.numpy().any()
blocks = gather_ordered_blocks(bitmap, packed, counts, 12)
assert (blocks is None) == (rank != 0)
if rank == 0:
    with open(os.path.join(outdir, "blocks.pkl"), "wb") as fp:
        pickle.dump(blocks, fp)

# the entropy steps on this rank's bitmaps, each stream against the native encoder
from pyrecode_tpu_torch import native
from pyrecode_tpu_torch.codecs import dyndeflate as dd

raws = [row.tobytes() for row in bitmap.numpy()]
tokenize, assemble = make_entropy_steps(mesh, 2 * len(raws[0]) + 256)
tok, hist, adler = tokenize(bitmap.numpy(), np.full(len(raws), len(raws[0]), np.int32))
tables = dd.host_tables(hist.numpy())
body, totbits, _ = assemble(tok, tables.luts, tables.phases, tables.partials)
for i, raw in enumerate(raws):
    hdr, hdr_bits = tables.headers[i]
    spliced, bits = dd.splice_eob(body.numpy()[i], int(totbits.numpy()[i]), *tables.eobs[i])
    assert dd.finish_stream(hdr, hdr_bits, spliced, bits, int(adler.numpy()[i]), len(raw),
                            raw=raw) == native.deflate_sparse(raw), i
dist.destroy_process_group()
print("JAX loaded:", "jax" in sys.modules,
      any(m == "pyrecode_tpu" or m.startswith("pyrecode_tpu.") for m in sys.modules))
"""

_WRITER = _PRELUDE + """
import json
from pyrecode_tpu_torch import InputParams, ReCoDeWriter

data = np.load(os.path.join(outdir, "data.npy"))
with open(os.path.join(outdir, "params.json")) as fp:
    params = InputParams(json.load(fp))
w = ReCoDeWriter("dist", dark_data=np.zeros(data.shape[1:], np.uint16), output_directory=outdir,
                 input_params=params, node_id=rank, device_entropy=True, fast_deflate=True,
                 device="cpu")
w.start()
w.run(data)
w.close()
dist.barrier()
dist.destroy_process_group()
print("JAX loaded:", "jax" in sys.modules,
      any(m == "pyrecode_tpu" or m.startswith("pyrecode_tpu.") for m in sys.modules))
"""


def _writer_fixture(num_threads):
    """Frames (4, 64, 64) uint16 and the writer's parameter dict."""
    rng = np.random.default_rng(5)
    data = np.where(rng.random((4, 64, 64)) < 0.04,
                    rng.integers(1, 4096, (4, 64, 64)), 0).astype(np.uint16)
    return data, dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64, num_frames=4,
        frame_offset=0, num_calibration_frames=1, calibration_frame_offset=0,
        keep_part_files=1, num_threads=num_threads, l2_statistics=0, l4_centroiding=0,
        compression_scheme=0, compression_level=1, source_file_type=0,
        source_header_length=0, keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, source: str, outdir: Path) -> None:
    """Start both ranks, each with its own timeout; both must exit 0 without
    having loaded JAX."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(source).format(repo=REPO))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), "2", port, str(outdir)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in (0, 1)]
    try:
        outs = [proc.communicate(timeout=CHILD_TIMEOUT)[0].decode(errors="replace")
                for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
        assert "JAX loaded: False False" in out, out[-3000:]


def test_two_process_gather_matches_single_process(tmp_path):
    _run_ranks(tmp_path, _GATHER, tmp_path)
    with open(tmp_path / "blocks.pkl", "rb") as fp:
        blocks = pickle.load(fp)
    rng = np.random.default_rng(0)
    frames = (rng.integers(0, 4096, (8, 64, 128)).astype(np.int64) - 3500).clip(0)
    frames = frames.astype(np.uint16)
    thr = np.zeros((64, 128), np.uint16)
    assert len(blocks) == 8
    for i in range(8):
        enc = oracle.reduce_frame(frames[i], thr, 1, 12)
        assert blocks[i] == (enc["packed_binary_map"], enc["packed_pixvals"]), i


def test_two_process_full_writer_pipeline(tmp_path):
    """Each rank writes its node's part file with device entropy; the part
    files and the merged container equal one process's host-entropy run."""
    dist_dir, ref_dir = tmp_path / "dist", tmp_path / "ref"
    dist_dir.mkdir()
    ref_dir.mkdir()
    data, params = _writer_fixture(2)
    np.save(dist_dir / "data.npy", data)
    (dist_dir / "params.json").write_text(json.dumps(params))
    _run_ranks(tmp_path, _WRITER, dist_dir)
    params = InputParams(params)
    assert params.validate()
    for node_id in (0, 1):
        w = ReCoDeWriter("dist", dark_data=np.zeros((64, 64), np.uint16),
                         output_directory=str(ref_dir),
                         input_params=params, node_id=node_id, device_entropy=False,
                         fast_deflate=True, device="cpu")
        w.start()
        w.run(data)
        w.close()
    for node_id in (0, 1):
        name = f"dist.rc1_part{node_id:03d}"
        assert (dist_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
    merged = merge_parts(str(dist_dir), "dist.rc1", 2)
    assert Path(merged).read_bytes() == Path(merge_parts(str(ref_dir), "dist.rc1", 2)).read_bytes()
    reader = ReCoDeReader(merged, device="cpu")
    reader.open()
    assert np.array_equal(reader.read_frames_dense(0, 4), data)
    reader.close()
