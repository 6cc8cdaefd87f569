"""The port's multi-device layer (``pyrecode_tpu_torch.parallel``) on a
mesh of CPU devices, mirroring tests/test_sharding.py: every output against
the JAX ``parallel`` package on its virtual 8-device CPU mesh (Pallas in
interpret mode) and against the oracle.  Exact bytes throughout."""

import jax
import numpy as np
import pytest
import torch

from pyrecode_tpu import oracle
from pyrecode_tpu.codecs import dyndeflate as jdd
from pyrecode_tpu.codecs import rans as jrans
from pyrecode_tpu.ops import pallas_deflate as pdk
from pyrecode_tpu.ops import pallas_rans as prk
from pyrecode_tpu.parallel import encode_frames_sharded as jax_encode_frames_sharded
from pyrecode_tpu.parallel import make_codec_mesh as jax_make_codec_mesh
from pyrecode_tpu.parallel import multihost as jmultihost
from pyrecode_tpu_torch import native
from pyrecode_tpu_torch.codecs import dyndeflate as dd
from pyrecode_tpu_torch.codecs import rans as trans
from pyrecode_tpu_torch.ops import hopper_deflate, hopper_rans
from pyrecode_tpu_torch.ops.encode import encode_frames_auto
from pyrecode_tpu_torch.parallel import (Sharded, dryrun_multidevice, encode_frames_sharded,
                                         make_codec_mesh, shard_frames)
from pyrecode_tpu_torch.parallel.multihost import (gather_ordered_blocks, make_encode_step,
                                                   make_entropy_steps, make_rans_steps,
                                                   replicate_threshold)

CPU = torch.device("cpu")


def _frames(batch, shape=(32, 256), density=0.03, seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((batch, *shape)) < density,
                    rng.integers(1, 4096, (batch, *shape)), 0).astype(np.uint16)


def _fields(res):
    """Bitmaps, counts and each frame's valid packed bytes of a result."""
    def host(x):
        return None if x is None else np.asarray(x.numpy() if isinstance(x, Sharded) else x)
    bitmap, packed, counts, plen = (host(getattr(res, k))
                                    for k in ("bitmap", "packed", "counts", "packed_len"))
    streams = None if packed is None else [packed[i, :plen[i]].tobytes()
                                           for i in range(len(bitmap))]
    return bitmap, counts, streams


def _equal_fields(a, b):
    (ab, ac, as_), (bb, bc, bs) = _fields(a), _fields(b)
    return np.array_equal(ab, bb) and np.array_equal(ac, bc) and as_ == bs


@pytest.mark.parametrize("level,kw", [(1, {}), (3, {}), (2, {"l2_statistic": "sum"}),
                                      (4, {"l4_scheme": "weighted_average"})])
@pytest.mark.parametrize("shard_rows", [True, False])
def test_sharded_encode_matches_jax(level, kw, shard_rows):
    """A 4 x 2 mesh; rows over 'space' at L1/L3 (row blocks merged), gathered
    for labelling at L2/L4."""
    frames = _frames(8, density=0.06, seed=level)
    thr = np.zeros(frames.shape[1:], np.uint16)
    want = jax_encode_frames_sharded(frames, thr, jax_make_codec_mesh(4, 2), reduction_level=level,
                                     bit_depth=12, max_values=2048, shard_rows=shard_rows, **kw)
    got = encode_frames_sharded(frames, thr, make_codec_mesh(4, 2, [CPU] * 8), level, 12, 2048,
                                shard_rows=shard_rows, **kw)
    assert isinstance(got.bitmap, Sharded) and len(got.bitmap.shards) == 4
    g_bm, _, g_streams = _fields(got)
    assert _equal_fields(got, want)
    for i in (0, 5, 7):
        enc = oracle.reduce_frame(frames[i], thr, level, 12, **kw)
        assert g_bm[i].tobytes() == enc["packed_binary_map"]
        if g_streams is not None:
            assert g_streams[i] == enc["packed_pixvals"]


@pytest.mark.parametrize("shape", [(6, 37), (10, 13)])
def test_row_blocks_of_partial_bytes(shape):
    """Row blocks of 3 x 37 or 5 x 13 pixels end inside a byte: the merged
    bitmap and values equal the unsharded encode, the oracle, and the
    values overflow where the whole frame does."""
    frames = _frames(4, shape=shape, density=0.3, seed=3)
    thr = np.full(shape, 2, np.uint16)
    mesh = make_codec_mesh(2, 2, [CPU] * 4)
    for level in (1, 3):
        got = encode_frames_sharded(frames, thr, mesh, level, 12, 64, shard_rows=True)
        ref = encode_frames_auto(torch.from_numpy(frames), torch.from_numpy(thr), level, 12, 64)
        assert _equal_fields(got, ref)
        for i in range(4):
            enc = oracle.reduce_frame(frames[i], thr, level, 12)
            assert _fields(got)[0][i].tobytes() == enc["packed_binary_map"]
    small = encode_frames_sharded(frames, thr, mesh, 1, 12, 4, shard_rows=True)
    assert np.array_equal(small.overflow.numpy(), small.counts.numpy() > 4)


def test_shards_must_divide_evenly():
    mesh = make_codec_mesh(4, 2, [CPU] * 8)
    with pytest.raises(ValueError):
        shard_frames(np.zeros((6, 32, 8), np.uint16), mesh)
    with pytest.raises(ValueError):
        shard_frames(np.zeros((8, 33, 8), np.uint16), mesh, shard_rows=True)
    with pytest.raises(ValueError):
        make_codec_mesh(3, 2, [CPU] * 8)


def test_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_codec_mesh()
    mesh = make_codec_mesh(devices=[CPU] * 4)
    assert mesh.shape == {"data": 4, "space": 1} and mesh.data_devices == [CPU] * 4


def test_encode_step_and_gather_match_jax():
    """The per-shard encode over 8 devices and the ordered gather, across
    shard boundaries, against the JAX shard_map'd Pallas step (interpret)."""
    frames = _frames(16, seed=2)
    thr = np.zeros(frames.shape[1:], np.uint16)
    jmesh = jax_make_codec_mesh(8, 1)
    jstep = jmultihost.make_pallas_encode_step(jmesh, out_size=1024, bit_depth=12)
    want = jmultihost.gather_ordered_blocks(
        *jstep(frames, jmultihost.replicate_threshold(thr, jmesh))[:3], bit_depth=12)
    mesh = make_codec_mesh(8, 1, [CPU] * 8)
    bitmap, packed, counts, overflow = make_encode_step(mesh, out_size=1024)(
        frames, replicate_threshold(thr, mesh))
    assert not overflow.numpy().any() and len(bitmap.shards) == 8
    blocks = gather_ordered_blocks(bitmap, packed, counts, bit_depth=12)
    assert blocks == want and len(blocks) == 16
    for i in (0, 7, 15):
        enc = oracle.reduce_frame(frames[i], thr, 1, 12)
        assert blocks[i] == (enc["packed_binary_map"], enc["packed_pixvals"])


def _raws(seed, n, npad, density, step):
    rng = np.random.default_rng(seed)
    raws, streams = [], np.zeros((n, npad), np.uint8)
    for i in range(n):
        k = npad - 3 - step * i
        raw = (rng.integers(0, 256, k) * (rng.random(k) < density)).astype(np.uint8)
        streams[i, :k] = raw
        raws.append(raw.tobytes())
    return raws, streams, np.array([len(r) for r in raws], np.int32)


def test_entropy_steps_match_native():
    """Tokenize and assemble per shard over 8 devices, host tables between:
    each finished stream equals native.deflate_sparse."""
    raws, streams, lengths = _raws(13, 8, pdk.CH_A, 0.04, 100)
    tokenize, assemble = make_entropy_steps(make_codec_mesh(8, 1, [CPU] * 8),
                                            2 * pdk.CH_A + 256)
    tok, hist, adler = tokenize(streams, lengths)
    hist_np, adler_np = hist.numpy(), adler.numpy()
    tables = dd.host_tables(hist_np)
    body, totbits, overflow = assemble(tok, tables.luts, tables.phases, tables.partials)
    assert not overflow.numpy().any()
    body_np, tot_np = body.numpy(), totbits.numpy()
    for i in range(8):
        hdr, hdr_bits = tables.headers[i]
        spliced, bits2 = dd.splice_eob(body_np[i], int(tot_np[i]), *tables.eobs[i])
        stream = dd.finish_stream(hdr, hdr_bits, spliced, bits2, int(adler_np[i]),
                                  len(raws[i]), raw=raws[i])
        assert stream == native.deflate_sparse(raws[i]), i


def test_rans_steps_match_jax():
    """The token encode and the symbol decode per shard on 2 devices: the
    encode bytes equal the JAX make_rans_steps (interpret), the decoded
    symbols the host tokenizer's."""
    raws, streams, lengths = _raws(17, 2, prk.CH_R, 0.05, 64)
    tok, hist, _ = hopper_deflate.tokenize(torch.from_numpy(streams), torch.from_numpy(lengths))
    hist_np = hist.numpy()[:, :286].astype(np.int64)
    m = hist_np.sum(axis=1).astype(np.int32)
    dense = hopper_deflate.compact_tokens(tok, prk.CH_R)[0].numpy()
    freq = np.zeros((2, 4096), np.int32)
    for i in range(2):
        freq[i, :286] = jrans.quantize_freqs(hist_np[i])
    cum = np.zeros_like(freq)
    cum[:, 1:] = np.cumsum(freq, axis=1)[:, :-1]
    out_bound = 2 * prk.CH_R + 16
    encode, decode = make_rans_steps(make_codec_mesh(2, 1, [CPU] * 2), out_bound, prk.CH_R)
    body, states, counts = (x.numpy() for x in encode(dense, freq, cum, m))

    jmesh = jax_make_codec_mesh(2, 1, devices=jax.devices()[:2])
    jencode, _ = jmultihost.make_rans_steps(jmesh, out_bound, prk.CH_R)
    eluts = np.stack([prk.encode_luts_radix(f[:286]) for f in freq])
    jbody, jstates, jcounts = (np.asarray(x) for x in jencode(dense, eluts, m))
    assert np.array_equal(counts, jcounts) and np.array_equal(states, jstates)

    rev = np.zeros((2, int(counts.max())), np.uint8)
    for i in range(2):
        assert np.array_equal(body[i, :counts[i]], jbody[i, :counts[i]].astype(np.uint8))
        rev[i, :counts[i]] = body[i, :counts[i]][::-1]
    tables = np.stack([hopper_rans.decode_tables(f) for f in freq])
    syms, underflow = decode(rev, counts, states, m, tables)
    assert not underflow.numpy().any()
    for i in range(2):
        lut_idx, _ = jdd.tokenize_bytes_np(np.frombuffer(raws[i], np.uint8))
        ref_syms, _, _ = jrans._token_syms_and_extras(lut_idx)
        assert np.array_equal(syms.numpy()[i, :m[i]], ref_syms), i
    assert trans.rans_batch_device(torch.from_numpy(streams), lengths) == \
        [trans.compress(r, nways=1024) for r in raws]


def test_dryrun_multidevice_on_cpu():
    """The whole dryrun on a 4 x 2 mesh of CPU devices and on a 2 x 1 one."""
    for n, n_space, mesh, frames in ((8, None, {"data": 4, "space": 2}, 8),
                                     (2, 1, {"data": 2, "space": 1}, 4)):
        report = dryrun_multidevice(n, [CPU] * n, n_space=n_space)
        assert report["mesh"] == mesh and len(report["blocks"]) == frames
        assert set(report["walls"]) >= {"sharded L1", "sharded L4", "sharded L2", "encode step",
                                        "sharded decode", "entropy steps", "rans steps",
                                        "rans_batch_device", "writer tail"}
        # CPU tensors run the twins, which launch nothing
        assert set(report["launches"].values()) == {0}


def test_dryrun_multidevice_needs_native(monkeypatch):
    """Without the native host library the dryrun raises at the deflate
    steps' Huffman tables, as the scheme-0 device writer does; it never
    skips a step."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native host library"):
        dryrun_multidevice(2, [CPU] * 2, n_space=1)
