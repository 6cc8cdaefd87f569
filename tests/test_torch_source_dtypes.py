"""The port's device writer on signed sources, byte for byte against the JAX
writer (``use_tpu=True``), on the CPU.

int8 (8-bit) and int16 (16-bit) L1/L3 frames take the encode kernel (its
plain version here) with their sign bit flipped, as the JAX writer widens
them for its Pallas kernel; L2/L4 frames take the port's plain
``ops.encode.encode_frames`` in their own dtype, as the JAX writer sends
them to its XLA ``ops.encode_frames``.  Part files: L1 and L4 at scheme 0,
L1 and L2-sum at scheme 12, each with device entropy (the kernels' plain
versions here) and with host entropy, at widths the JAX writer sends to
XLA.  The frames hold negative background pixels that only a signed
comparison keeps out of the foreground; the L2/L4 frames keep their
foreground non-negative and their puddle sums within the dtype, where the
JAX XLA path's uint32 statistics agree with the port's (ROADMAP Queue 3).
Scheme-12 L1 values outside 8..12 bits take the gap coder, as the JAX XLA
path codes them, for every source (16-bit uint16 and int16 alike); the
int8 case's 8-bit values are dense enough that the JAX XLA path codes them
as 8-bit symbols too, as the port does for every source.  Also:
the writer's encode of signed frames against the JAX XLA ``encode_frames``
at every level, an int16 batch at 12 bits that the JAX writer encodes with
its Pallas kernel in interpret mode, an int16 SEQ source read back
exactly, and the dtypes the device writer refuses.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu import ops as jops
from pyrecode_tpu.em_reader import write_seq
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch.constants import rc_cfg as rc
from pyrecode_tpu_torch.ops.encode import encode_frames, encode_frames_auto, signed_to_kernel_frames
from test_torch_slice import _params

EPSILON = 2
DTYPES = {"int8": (np.int8, 8), "int16": (np.int16, 16)}
# unsigned sources whose L1 values are wider than the symbol coders' 12 bits
WIDE = {"uint16-13": (np.uint16, 13), "uint16-16": (np.uint16, 16)}
# (level, header code of the L2 statistic or L4 scheme, compression scheme) -> frame shape:
# the scheme-12 L1 frames' ~18% foreground and the L2 frames' bitmaps both
# give the gap coder a 32768-position capacity, and the L1 values have few
# set bits, which spares the JAX positions kernel its capacity escalations
# (each a compile in interpret mode); widths are not multiples of 128
CONFIGS = {(1, 0, 0): (4, 40, 72), (4, 1, 0): (4, 40, 72), (1, 0, 12): (4, 256, 520),
           (2, 2, 12): (4, 128, 136)}
IDS = [f"L{level}-s{scheme}" for level, _, scheme in CONFIGS]


def _frames(dtype, bit_depth, shape, occupancy, signed_dark, seed, excess=None):
    """Frames and dark frame in ``dtype``: background at dark + 0..EPSILON
    with 2% of its pixels at a large negative value (signed dtypes),
    foreground above dark +
    EPSILON with an exponential excess of mean ``excess`` (by default small
    at 8 bits, so that puddle sums stay within int8), kept within
    ``bit_depth`` bits of residual."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    signed = info.min < 0
    dark = rng.integers(-20 if signed_dark and signed else 0, 20, shape[1:]).astype(np.int64)
    thr = np.broadcast_to(dark + EPSILON, shape)
    data = thr - rng.integers(0, EPSILON + 1, shape)
    if signed:
        data[rng.random(shape) < 0.02] = -(info.max // 2)
    fg = rng.random(shape) < occupancy
    if excess is None:
        excess = 3.0 if bit_depth <= 8 else 40.0
    data[fg] = np.minimum(thr + 1 + rng.exponential(excess, shape).astype(np.int64),
                          np.minimum(thr + (1 << bit_depth) - 1, info.max))[fg]
    return data.astype(dtype), dark.astype(dtype)


def _case(name, level, code, scheme):
    dtype, bit_depth = {**DTYPES, **WIDE}[name]
    shape = CONFIGS[(level, code, scheme)]
    dense = (level, scheme) == (1, 12)   # residuals mostly 1: few set bits in the values
    data, dark = _frames(dtype, bit_depth, shape, 0.18 if dense else 0.05, level == 1,
                         seed=level * 10 + scheme, excess=0.3 if dense else None)
    params = _params(shape=shape, num_threads=1, reduction_level=level,
                     calibration_threshold_epsilon=EPSILON,
                     source_data_type=int(np.iinfo(dtype).min < 0),
                     target_data_type=int(np.iinfo(dtype).min < 0), source_bit_depth=bit_depth,
                     target_bit_depth=bit_depth,
                     l2_statistics=code if level == 2 else 0,
                     l4_centroiding=code if level == 4 else 0, compression_scheme=scheme)
    return data, dark, params


def _write(writer_cls, out_dir, data, dark, params, **kwargs):
    out_dir.mkdir(parents=True, exist_ok=True)
    w = writer_cls("test_data", dark_data=dark, output_directory=str(out_dir),
                   input_params=params, mode="batch", buffer_size_in_frames=2, **kwargs)
    w.start()
    w.run(data)
    w.close()
    return out_dir / f"test_data.rc{params.reduction_level}_part000"


@pytest.fixture(scope="module")
def jax_parts(tmp_path_factory):
    """The JAX writer's part file of each case, written once a module."""
    root = tmp_path_factory.mktemp("jax_dtypes")
    cache = {}

    def get(name, level, code, scheme, device_entropy):
        # scheme 0 writes the same bytes with either entropy stage
        key = (name, level, code, scheme, device_entropy and scheme == 12)
        if key not in cache:
            data, dark, params = _case(name, level, code, scheme)
            cache[key] = _write(JaxWriter, root / "-".join(map(str, key)), data, dark, params,
                                use_tpu=True, device_entropy=key[-1])
        return cache[key]
    return get


@pytest.mark.parametrize("device_entropy", [True, False])
@pytest.mark.parametrize("level,code,scheme", list(CONFIGS), ids=IDS)
@pytest.mark.parametrize("name", list(DTYPES))
def test_part_files_match_jax(tmp_path, jax_parts, name, level, code, scheme, device_entropy):
    data, dark, params = _case(name, level, code, scheme)
    got = _write(port.ReCoDeWriter, tmp_path, data, dark, params, device="cpu",
                 device_entropy=device_entropy)
    assert filecmp.cmp(got, jax_parts(name, level, code, scheme, device_entropy), shallow=False)


@pytest.mark.parametrize("device_entropy", [True, False])
@pytest.mark.parametrize("name", list(WIDE))
def test_wide_unsigned_values_match_jax(tmp_path, jax_parts, name, device_entropy):
    """uint16 L1 at scheme 12 with values of 13 and 16 bits: the device
    entropy codes them in gap mode, as the JAX XLA path does (and as the
    port codes int16 values of those widths)."""
    data, dark, params = _case(name, 1, 0, 12)
    got = _write(port.ReCoDeWriter, tmp_path, data, dark, params, device="cpu",
                 device_entropy=device_entropy)
    assert filecmp.cmp(got, jax_parts(name, 1, 0, 12, device_entropy), shallow=False)


@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(DTYPES))
def test_encode_frames_matches_jax_xla(name, level):
    """The writer's encode of signed frames against the JAX package's XLA
    encode_frames on the same frames, every output: at L1/L3 the encode
    kernel's plain version on the sign-flipped frames, at L2/L4 (L2 sum, L4
    weighted average) ops.encode.encode_frames in the source dtype."""
    dtype, bit_depth = DTYPES[name]
    data, dark = _frames(dtype, bit_depth, (3, 40, 72), 0.05, level in (1, 3), seed=level)
    thr = (dark.astype(np.int64) + EPSILON).astype(dtype)
    frames, threshold = torch.from_numpy(data), torch.from_numpy(thr)
    if level in (1, 3):
        got = encode_frames_auto(signed_to_kernel_frames(frames),
                                 signed_to_kernel_frames(threshold), level, bit_depth, 1024)
    else:
        limit = min(int(np.iinfo(dtype).max), (1 << bit_depth) - 1)
        got = encode_frames(frames, threshold, level, bit_depth, 1024, "sum",
                            "weighted_average", stat_limit=limit)
    want = jops.encode_frames(jnp.asarray(data), jnp.asarray(thr), reduction_level=level,
                              bit_depth=bit_depth, max_values=1024, l2_statistic="sum",
                              l4_scheme="weighted_average")
    for field in ("bitmap", "packed", "counts", "packed_len", "overflow"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(w)), field


def test_int16_pallas_batch_matches_jax(tmp_path):
    """At 64 x 128 the JAX writer encodes int16 frames with its Pallas L1
    kernel (interpret mode here), which widens them to int32."""
    data, dark = _frames(np.int16, 12, (4, 64, 128), 0.05, True, seed=7)
    params = _params(shape=data.shape, num_threads=1, source_data_type=1, target_data_type=1)
    want = _write(JaxWriter, tmp_path / "jax", data, dark, params, use_tpu=True)
    got = _write(port.ReCoDeWriter, tmp_path / "port", data, dark, params, device="cpu")
    assert filecmp.cmp(got, want, shallow=False)


def test_writer_with_seq_source(tmp_path):
    """The port's counterpart of test_em_reader.py::test_writer_with_seq_source:
    an int16 StreamPix sequence, written with use_tpu=True and read back
    exactly."""
    data = (np.arange(4 * 8 * 8, dtype=np.int16) % 251).reshape(4, 8, 8)
    path = tmp_path / "run.seq"
    write_seq(path, data)
    params = port.InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=16, source_bit_depth=16, num_cols=8, num_rows=8,
        num_frames=4, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=1,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=rc.FILE_TYPE_SEQ,
        source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=1, target_data_type=1))
    assert params.validate()
    dark = np.zeros((8, 8), np.int16)
    w = port.ReCoDeWriter(str(path), dark_data=dark, output_directory=str(tmp_path),
                          input_params=params, device="cpu")
    w.start()
    w.run()
    w.close()
    reader = port.ReCoDeReader(port.merge_parts(str(tmp_path), "run.rc1", 1), device="cpu")
    reader.open()
    for i in range(4):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), np.where(data[i] > dark, data[i], 0)), i
    reader.close()


@pytest.mark.parametrize("data_type,bit_depth,error", [
    (0, 32, NotImplementedError), (1, 32, NotImplementedError), (1, 64, NotImplementedError),
    (2, 32, NotImplementedError), (2, 64, NotImplementedError), (0, 64, OverflowError)],
    ids=["uint32", "int32", "int64", "float32", "float64", "uint64"])
def test_refused_dtypes_raise(tmp_path, data_type, bit_depth, error):
    """The device writer refuses sources wider than 16 bits and float ones,
    whose bytes the JAX writer's device path gets wrong against its own host
    oracle; uint64 raises OverflowError at construction, as in the JAX
    writer.  The messages point to ROADMAP Queue 3."""
    params = _params(shape=(2, 8, 24), num_threads=1, source_data_type=data_type,
                     target_data_type=data_type, source_bit_depth=bit_depth,
                     target_bit_depth=bit_depth)
    dark = np.zeros((8, 24), params.source_numpy_dtype)
    if error is OverflowError:
        with pytest.raises(OverflowError):
            JaxWriter("t", dark_data=dark, output_directory=str(tmp_path), input_params=params)
    with pytest.raises(error, match="ROADMAP Queue 3"):
        port.ReCoDeWriter("t", dark_data=dark, output_directory=str(tmp_path),
                          input_params=params, device="cpu")
