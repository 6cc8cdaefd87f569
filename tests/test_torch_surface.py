"""The port's package surface against the JAX package's: the top-level
exports, the dtype helpers, ``ReCoDeHeader.skip_header``, the compressor
API of ``codecs``, the native host helpers and the ``Reader`` shim, the
MRC and SEQ fixture writers, ``oracle.synthetic_frames`` and
``writer.print_run_metrics``.  Bytes and integers exact; the public-name
diff of the two packages is the listed exceptions and nothing else.
"""

import ast
import io
from contextlib import redirect_stdout
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

import pyrecode_tpu as jax_pkg
import pyrecode_tpu_torch as port
from pyrecode_tpu import codecs as jax_codecs
from pyrecode_tpu import em_reader as jax_em
from pyrecode_tpu import native as jax_native
from pyrecode_tpu import oracle as jax_oracle
from pyrecode_tpu.writer import print_run_metrics as jax_print_run_metrics
from pyrecode_tpu_torch import codecs as port_codecs
from pyrecode_tpu_torch import em_reader as port_em
from pyrecode_tpu_torch import native as port_native
from pyrecode_tpu_torch import oracle as port_oracle
from pyrecode_tpu_torch.constants import rc_cfg as rc
from pyrecode_tpu_torch.writer import print_run_metrics

REPO = Path(__file__).resolve().parent.parent

# Public names of the JAX package that the port does not have, each with its
# reason (ROADMAP.md lists them too).
NOT_PORTED = {
    # the benchmark harness waits on the port's own benchmark
    ("cli.py", "cmd_bench"),
    # JAX compile cache and the relay-honest jit timing helper
    ("profiling.py", "enable_compile_cache"),
    ("profiling.py", "delta_scan_time"),
    # JAX sharding specs; the port's mesh is a list of devices
    ("parallel/mesh.py", "frame_sharding"),
    ("parallel/mesh.py", "replicated_sharding"),
    # the Pallas encode step; the port's step runs its CUDA encode
    ("parallel/multihost.py", "make_pallas_encode_step"),
    # the JAX device paths' numpy twins and jit helpers, which the port's
    # kernels and their plain PyTorch twins replace
    ("ops/segment.py", "centroids_to_mask"),
    ("codecs/rans.py", "rans_decompress_device"),
    ("codecs/rans.py", "streams_nways"),
    ("codecs/dyndeflate.py", "LUT_SIZE"),
    ("codecs/dyndeflate.py", "assemble_bits_np"),
    ("codecs/dyndeflate.py", "bit_reverse"),
    ("codecs/dyndeflate.py", "deflate_dyn_np"),
    ("codecs/dyndeflate.py", "luts_as_radix"),
    ("codecs/dyndeflate.py", "token_luts"),
}


def _public_names(path: Path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{m.name}" for m in node.body
                             if isinstance(m, ast.FunctionDef))
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.split(".")[-1].startswith("_")}


def test_public_name_diff_is_the_listed_exceptions():
    """Every public function, class, method and module constant of the JAX
    package has its namesake in the port, except the Pallas kernel modules
    (the port's are ``ops/hopper_*.py`` and ``csrc/``) and NOT_PORTED."""
    missing = set()
    for path in sorted((REPO / "pyrecode_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "pyrecode_tpu").as_posix()
        if rel.startswith("ops/pallas_"):
            continue
        twin = REPO / "pyrecode_tpu_torch" / rel
        assert twin.exists(), rel
        missing |= {(rel, name) for name in _public_names(path) - _public_names(twin)}
    assert missing == NOT_PORTED


def test_top_level_exports():
    for name in jax_pkg.__all__:
        assert name in port.__all__, name
        assert getattr(port, name) is not None
    assert port.__version__ == jax_pkg.__version__
    assert port.rc_cfg.FILE_TYPE_SEQ == jax_pkg.rc_cfg.FILE_TYPE_SEQ
    assert "kernel_launch_counts" in port.__all__


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64, np.int8,
                                   np.int16, np.int32, np.int64, np.float32, np.float64])
def test_dtype_codes(dtype):
    code = port.get_dtype_code(dtype)
    assert code == jax_pkg.get_dtype_code(dtype)
    assert port.get_dtype_code(np.dtype(dtype)) == code
    assert port.get_dtype_string(code) == jax_pkg.get_dtype_string(code) == np.dtype(dtype).name
    data_type = {"u": 0, "i": 1, "f": 2}[np.dtype(dtype).kind]
    assert port.map_dtype(data_type, np.dtype(dtype).itemsize * 8) == dtype


def test_dtype_helpers_reject_unknown():
    for fn, arg in ((port.get_dtype_code, np.complex64), (port.get_dtype_string, 10),
                    (port.get_dtype_string, None)):
        with pytest.raises(ValueError):
            fn(arg)


def test_skip_header(tmp_path):
    params = port.InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=16, num_rows=16,
        num_frames=3, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=1,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=0, target_data_type=0))
    header = port.ReCoDeHeader()
    header.create(port.InitParams("batch", str(tmp_path), image_filename="src.seq"), params,
                  is_intermediate=False)
    raw = io.BytesIO()
    header.serialize_to(raw)
    raw.write(b"frame-data")
    raw.seek(0)
    assert header.skip_header(raw) is raw
    assert raw.tell() == header.recode_header_length == 512
    assert raw.read() == b"frame-data"


def _blob(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 255, size=n).astype(np.uint8)
    b[rng.random(n) > 0.1] = 0
    return b.tobytes()


def test_compressor_api():
    assert port_codecs.available_schemes() == jax_codecs.available_schemes()
    data = _blob()
    for scheme in port_codecs.available_schemes():
        assert port_codecs.scheme_name(scheme) == jax_codecs.scheme_name(scheme)
        coded = port_codecs.compress(scheme, 1, data)
        assert coded == jax_codecs.compress(scheme, 1, data), scheme
        assert port_codecs.de_compress(scheme, coded) == data, scheme
    from pyrecode_tpu_torch.codecs.backends import (make_compressor_context,
                                                    make_decompressor_context)

    cctx, dctx = make_compressor_context(1, 3), make_decompressor_context(1)
    assert port_codecs.de_compress(1, port_codecs.compress(1, 3, data, cctx), dctx) == data
    assert make_compressor_context(0, 1) is None and make_decompressor_context(0) is None


native_only = pytest.mark.skipif(not port_native.available(),
                                 reason="native library unavailable (no g++)")


@native_only
@pytest.mark.parametrize("bit_depth", [4, 8, 11, 12, 16, 20])
def test_native_bit_pack_unpack(bit_depth):
    rng = np.random.default_rng(bit_depth)
    vals = rng.integers(0, 1 << bit_depth, size=313).astype(np.uint32)
    packed = port_native.bit_pack(vals, bit_depth)
    assert np.array_equal(packed, jax_native.bit_pack(vals, bit_depth))
    assert np.array_equal(packed, port_oracle.bit_pack(vals, bit_depth))
    out = port_native.bit_unpack(packed.tobytes(), bit_depth, vals.size)
    assert out.dtype == np.uint64
    assert np.array_equal(out, vals.astype(np.uint64))


@native_only
def test_native_pack_mask_and_tables():
    rng = np.random.default_rng(2)
    mask = rng.random(1037) > 0.8
    assert np.array_equal(port_native.pack_mask(mask), jax_native.pack_mask(mask))
    freq = rng.integers(0, 1000, 286).astype(np.uint32)
    llen, lcode = port_native.dyn_tables(freq)
    want_len, want_code = jax_native.dyn_tables(freq)
    assert np.array_equal(llen, want_len) and np.array_equal(lcode, want_code)
    hdr, bits = port_native.dyn_header(llen)
    want_hdr, want_bits = jax_native.dyn_header(want_len)
    assert bits == want_bits and np.array_equal(hdr, want_hdr)
    assert np.array_equal(port_native.token_luts_radix(llen, lcode),
                          jax_native.token_luts_radix(want_len, want_code))


def test_native_reader_shim():
    frame = np.zeros((32, 32), dtype=np.uint16)
    frame[3, 5] = 100
    frame[30, 31] = 4095
    enc = port_oracle.reduce_frame(frame, np.zeros_like(frame), 1, 12)
    results = []
    for native in (port_native, jax_native):
        reader = native.Reader()
        reader.create_buffers(32, 32, 12)
        buf = bytearray(32 * 32 * 3 * 8)
        n = reader.get_frame_sparse(1, enc["packed_binary_map"], enc["packed_pixvals"], buf)
        vals = np.array([100, 4095, 7], np.uint16)
        packed = bytearray(8)
        reader.bit_pack_pixel_intensities(len(packed), 3, 12, vals.tobytes(), packed)
        unpacked = bytearray(3 * 8)
        reader.bit_unpack_pixel_intensities(3, bytes(packed), unpacked)
        results.append((n, bytes(buf[:n * 24]), bytes(packed), bytes(unpacked)))
    assert results[0] == results[1]
    n, trip, _, unpacked = results[0]
    assert n == 2
    assert np.frombuffer(trip, np.uint64).reshape(2, 3).tolist() == [[3, 5, 100], [30, 31, 4095]]
    assert np.frombuffer(unpacked, np.uint64).tolist() == [100, 4095, 7]


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.int8, np.float32])
def test_write_mrc(tmp_path, dtype):
    data = (np.arange(3 * 8 * 8) % 120).astype(dtype).reshape(3, 8, 8)
    port_em.write_mrc(tmp_path / "port.mrc", data)
    jax_em.write_mrc(tmp_path / "jax.mrc", data)
    assert (tmp_path / "port.mrc").read_bytes() == (tmp_path / "jax.mrc").read_bytes()
    with port_em.emfile(str(tmp_path / "port.mrc"), rc.FILE_TYPE_MRC) as fp:
        assert fp.shape == (3, 8, 8)
        assert np.array_equal(np.squeeze(np.asarray(fp[2])), data[2])


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.uint8])
def test_write_seq(tmp_path, dtype):
    data = (np.arange(4 * 8 * 8) % 251).astype(dtype).reshape(4, 8, 8)
    port_em.write_seq(tmp_path / "port.seq", data)
    jax_em.write_seq(tmp_path / "jax.seq", data)
    assert (tmp_path / "port.seq").read_bytes() == (tmp_path / "jax.seq").read_bytes()
    with port_em.emfile(str(tmp_path / "port.seq"), rc.FILE_TYPE_SEQ) as fp:
        assert fp.shape == (4, 8, 8)
        assert np.array_equal(np.squeeze(np.asarray(fp[3])), data[3])


@pytest.mark.parametrize("distribution,occupancy,bits", [("peaked", 0.01, 12),
                                                         ("peaked", 0.2, 8),
                                                         ("uniform", 0.05, 12)])
def test_synthetic_frames(distribution, occupancy, bits):
    got = port_oracle.synthetic_frames(3, 64, 48, occupancy, bits, distribution, rng=7)
    want = jax_oracle.synthetic_frames(3, 64, 48, occupancy, bits, distribution, rng=7)
    assert got.dtype == np.uint16 and got.shape == (3, 64, 48)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        port_oracle.synthetic_frames(1, 4, 4, distribution="flat")


def test_print_run_metrics():
    metrics = {"run_data_read_time": timedelta(seconds=1.5),
               "frame_time": timedelta(seconds=4),
               "frame_thresholding_and_counting_time": timedelta(seconds=1),
               "run_dose_rates": [0.1, 0.3], "run_frames": 8}
    outputs = []
    for fn in (print_run_metrics, jax_print_run_metrics):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(metrics)
        outputs.append(buf.getvalue())
    assert outputs[0] == outputs[1]
    assert "frame_time" in outputs[0] and "Avg.=" in outputs[0]
