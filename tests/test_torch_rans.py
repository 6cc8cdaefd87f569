"""The port's scheme-12 (interleaved rANS) device stage on the CPU.

Each kernel's twin in ``pyrecode_tpu_torch.ops`` (histogram, encode, decode,
encode with positions, positions decode) against its Pallas kernel in the
JAX package (interpret mode, as tests/test_rans.py runs it), and the port's
``rans_symbols_batch_device`` / ``rans_gaps_batch_device`` against the JAX
ones at m >= 65536 symbols, where the device coders engage.  Every
comparison is exact bytes.
"""

import re
import zlib

import numpy as np
import pytest
import torch

from pyrecode_tpu import oracle as joracle
from pyrecode_tpu.codecs import rans as jrans
from pyrecode_tpu.ops import pallas_decode, pallas_encode, pallas_rans as prk
from pyrecode_tpu_torch.codecs import rans as trans
from pyrecode_tpu_torch.ops import hopper_decode, hopper_encode, hopper_rans as hr
from chip_smoke import posdecode_span_battery

SPANS = posdecode_span_battery(np.random.default_rng(26))

NPAD = 2 * prk.CH_R      # the TPU kernels take multiples of 8192 symbols


def _peaked(rng, shape, scale=8.0):
    return np.minimum(rng.exponential(scale, shape).astype(np.int64), 4095).astype(np.int32)


def _tables(vals, m, freq_override=None):
    """Quantized frequencies of each stream's first m symbols and their prefix."""
    freq = np.stack([jrans.quantize_freqs(np.bincount(v[:k], minlength=4096)).astype(np.int32)
                     for v, k in zip(vals, m)])
    if freq_override is not None:
        for b, f in freq_override.items():
            freq[b] = f
    cum = np.zeros_like(freq)
    cum[:, 1:] = np.cumsum(freq, axis=1)[:, :-1]
    return freq, cum


@pytest.fixture(scope="module")
def streams():
    """Symbol streams at the kernels' edges: m not a multiple of 1024, a
    one-symbol alphabet, all 4096 symbols, m = 0."""
    rng = np.random.default_rng(21)
    vals = _peaked(rng, (4, NPAD))
    vals[1] = 9
    vals[2] = rng.integers(0, 4096, NPAD)
    m = np.array([10001, 3000, NPAD, 0], np.int32)
    one = np.zeros(4096, np.int32)
    one[9] = 4096
    freq, cum = _tables(vals, m, {1: one})
    return vals, m, freq, cum


def test_hist_matches_pallas(streams):
    vals, m, _, _ = streams
    want = np.asarray(prk.hist_symbols_pallas(vals, m, interpret=True))
    got = hr.rans_hist(torch.from_numpy(vals), torch.from_numpy(m)).numpy()
    assert np.array_equal(got, want)


def _hist_edges(case):
    """Symbol streams of NPAD symbols: out-of-range symbols inside m (and
    junk past it), or peaked ones (one symbol, and a narrow exponential)."""
    rng = np.random.default_rng(28)
    vals = _peaked(rng, (3, NPAD), scale=2.0)
    if case == "out of range":
        vals[:, ::5] = -1
        vals[:, 1::7] = 4096
        vals[:, 2::9] = rng.integers(-2**31, 2**31, vals[:, 2::9].shape)
        return vals, np.array([NPAD, 5000, 1], np.int32)
    vals[1] = 3
    return vals, np.array([NPAD, NPAD - 1, 4097], np.int32)


@pytest.mark.parametrize("case", ["out of range", "peaked"])
def test_hist_edges_match_pallas(case):
    vals, m = _hist_edges(case)
    want = np.asarray(prk.hist_symbols_pallas(vals, m, interpret=True))
    got = hr.rans_hist(torch.from_numpy(vals), torch.from_numpy(m)).numpy()
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def encoded(streams):
    """The port's and the Pallas encode (groups 1) of the same streams."""
    vals, m, freq, cum = streams
    luts = np.stack([prk.encode_luts_symbols(f) for f in freq])
    out_bound = 2 * NPAD + 4096
    jax_out = [np.asarray(a) for a in prk.rans_encode_symbols_pallas(
        vals, luts, m, out_bound, interpret=True)]
    port_out = [t.numpy() for t in hr.rans_encode(
        *(torch.from_numpy(a) for a in (vals, freq, cum, m)), 2 * NPAD, 1)]
    return jax_out, port_out


def test_encode_matches_pallas(streams, encoded):
    """Exact against the Pallas kernel and the numpy contract, except where
    the Pallas kernel leaves that contract: at a one-symbol alphabet
    (f = 4096) its int32 threshold f << 19 wraps negative, so it emits two
    bytes per symbol where the numpy coder emits none.  The port keeps the
    contract; both streams decode to the same symbols (test below)."""
    vals, m, freq, _ = streams
    (jbody, jstates, jcounts), (body, states, counts) = encoded
    for b in range(4):
        ref_body, ref_states = jrans.rans_encode_interleaved(vals[b, :m[b]], freq[b], 1024)
        assert body[b, :counts[b]].tobytes() == ref_body
        assert np.array_equal(states[b].astype(np.uint32), ref_states)
        if b == 1:
            assert counts[b] == 0 and jcounts[b] == 2 * m[b]
            continue
        assert counts[b] == jcounts[b]
        assert np.array_equal(states[b], jstates[b])
        assert np.array_equal(body[b, :counts[b]], jbody[b, :counts[b]].astype(np.uint8)), b


def test_decode_matches_pallas(streams, encoded):
    vals, m, freq, _ = streams
    _, (body, states, counts) = encoded
    bw = -(-int(counts.max()) // 512) * 512
    rev = np.zeros((4, bw), np.uint8)
    for b in range(4):
        rev[b, :counts[b]] = body[b, :counts[b]][::-1]
    want = np.asarray(prk.rans_decode_pallas(
        rev, states, m, NPAD, np.stack([prk.decode_tables_radix(f) for f in freq]),
        interpret=True))
    tables = np.stack([hr.decode_tables(f) for f in freq])
    syms, underflow = hr.rans_decode(*(torch.from_numpy(a) for a in (rev, counts, states, m,
                                                                     tables)), NPAD, 1)
    assert not underflow.any()
    assert np.array_equal(syms.numpy(), want)
    for b in range(4):
        assert np.array_equal(syms[b, :m[b]].numpy(), vals[b, :m[b]])
        assert not syms[b, m[b]:].any()


def test_decode_underflow_flags_without_reading_past_the_body(streams, encoded):
    _, m, freq, _ = streams
    _, (body, states, counts) = encoded
    cut = np.minimum(counts, 64).astype(np.int32)
    short = np.zeros((4, 64), np.uint8)
    for b in range(4):
        short[b, :cut[b]] = body[b, :counts[b]][::-1][:cut[b]]
    tables = np.stack([hr.decode_tables(f) for f in freq])
    _, underflow = hr.rans_decode(*(torch.from_numpy(a) for a in (short, cut, states, m,
                                                                  tables)), NPAD, 1)
    assert underflow.tolist() == [True, False, True, False]


def test_decode_stores_nothing_past_npad(streams, encoded):
    """npad below some m: the symbols up to npad, the same underflow flags
    (a stream is decoded to its end), as the kernel keeps its contract."""
    _, m, freq, _ = streams
    _, (body, states, counts) = encoded
    rev = np.zeros((4, int(counts.max())), np.uint8)
    for b in range(4):
        rev[b, :counts[b]] = body[b, :counts[b]][::-1]
    tables = np.stack([hr.decode_tables(f) for f in freq])
    args = [torch.from_numpy(a) for a in (rev, counts, states, m, tables)]
    full, full_underflow = hr.rans_decode(*args, NPAD, 1)
    for npad in (5000, 1024, 0):
        syms, underflow = hr.rans_decode(*args, npad, 1)
        assert torch.equal(syms, full[:, :npad]), npad
        assert torch.equal(underflow, full_underflow), npad
    cut = [torch.from_numpy(np.ascontiguousarray(a))
           for a in (rev[:, :64], np.minimum(counts, 64).astype(np.int32))]
    assert hr.rans_decode(*cut, *args[2:], 1000, 1)[1].tolist() == [True, False, True, False]


@pytest.mark.parametrize("groups", [1, 8])
def test_encode_decode_match_numpy_contract(groups):
    """groups 8 (nways 8192) against the numpy coder; the Pallas groups-8
    run at its 2^21-symbol size is a slow-tier test of the JAX package."""
    rng = np.random.default_rng(22)
    nways = 1024 * groups
    vals = _peaked(rng, (2, 3 * nways + 77))
    m = np.array([vals.shape[1], nways - 5], np.int32)
    freq, cum = _tables(vals, m)
    body, states, counts = hr.rans_encode(*(torch.from_numpy(a) for a in (vals, freq, cum, m)),
                                          2 * vals.shape[1], groups)
    for b in range(2):
        ref_body, ref_states = jrans.rans_encode_interleaved(vals[b, :m[b]], freq[b], nways)
        assert body[b, :counts[b]].numpy().tobytes() == ref_body
        assert np.array_equal(states[b].numpy().astype(np.uint32), ref_states)
        rev = torch.from_numpy(np.frombuffer(ref_body, np.uint8)[::-1].copy())[None]
        syms, underflow = hr.rans_decode(rev, counts[b:b + 1].contiguous(),
                                         states[b:b + 1].contiguous(),
                                         torch.from_numpy(m[b:b + 1]),
                                         torch.from_numpy(hr.decode_tables(freq[b]))[None],
                                         int(m[b]), groups)
        ref = jrans.rans_decode_interleaved(ref_body, ref_states, int(m[b]), freq[b], nways)
        assert not underflow.any()
        assert np.array_equal(syms[0].numpy(), ref)


def _foreground(rng, B, H, W, occupancy):
    frames = (rng.integers(1, 8192, (B, H, W)) * (rng.random((B, H, W)) < occupancy))
    return frames.astype(np.uint16), rng.integers(0, 4, (H, W)).astype(np.uint16)


def test_encode_with_positions_matches_pallas():
    """Kernel #1a as the scheme-12 writer calls it: values above 12 bits are
    masked with pos_vbits=12; without pos_vbits they are kept."""
    frames, thr = _foreground(np.random.default_rng(23), 2, 64, 512, 0.03)
    want = [np.asarray(a) for a in pallas_encode.encode_l1_pallas(
        frames, thr, out_size=2048, interpret=True, with_positions=True, pos_vbits=12)]
    f, t = torch.from_numpy(frames), torch.from_numpy(thr)
    got = hopper_encode.encode_l1(f, t, 2048, with_positions=True, pos_vbits=12)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    unmasked = hopper_encode.encode_l1(f, t, 2048, with_positions=True)
    assert np.array_equal(unmasked[1].numpy(), hopper_encode.encode_l1(f, t, 2048)[1].numpy())
    assert np.array_equal(unmasked[4].numpy(), want[4])


def test_posdecode_matches_pallas():
    rng = np.random.default_rng(24)
    H, W, out = 64, 512, 2048
    counts = np.array([1500, 0, 2048], np.int32)
    pos = np.zeros((3, out), np.int32)
    for b in (0, 2):
        pos[b, :counts[b]] = np.sort(rng.choice(H * W, counts[b], replace=False))
    vals = rng.integers(0, 4096, (3, out)).astype(np.int32)
    dense, ovf = pallas_decode.decode_l1_from_positions(pos, vals, counts, H, W, bucket=2,
                                                       interpret=True)
    assert not np.asarray(ovf).any()
    got, overflow = hopper_decode.posdecode(*(torch.from_numpy(a) for a in (pos, vals, counts)),
                                            H, W)
    assert not overflow.any()
    assert np.array_equal(got.numpy(), np.asarray(dense))


@pytest.mark.parametrize("case", range(len(SPANS)), ids=[re.sub(r"\W+", "_", c[0]) for c in SPANS])
def test_posdecode_span_battery(case):
    """The positions decode's twin on the CUDA kernel's span battery: span
    edges, empty and full spans, count 0 and = width, H*W % 8 != 0 and
    repeated positions (flagged).  Unflagged frames equal dense[pos] =
    values; at the JAX kernel's geometry (a power-of-two width) they also
    equal pallas_decode.decode_l1_from_positions in interpret mode."""
    what, pos, vals, counts, H, W, flagged = SPANS[case]
    dense, overflow = hopper_decode.posdecode_plain(
        *(torch.from_numpy(a) for a in (pos, vals, counts)), H, W)
    assert overflow.tolist() == flagged
    clean = ~np.array(flagged)
    want = np.zeros((len(counts), H * W), np.uint16)
    for b in np.flatnonzero(clean):
        want[b, pos[b, :counts[b]]] = vals[b, :counts[b]]
    assert np.array_equal(dense.numpy().reshape(len(counts), -1)[clean], want[clean])
    if W & (W - 1) == 0:
        jdense, jovf = pallas_decode.decode_l1_from_positions(pos, vals, counts, H, W, bucket=2,
                                                             interpret=True)
        assert not np.asarray(jovf)[clean].any()
        assert np.array_equal(dense.numpy()[clean], np.asarray(jdense)[clean])


def test_posdecode_flags_corrupt_positions():
    pos = torch.tensor([[3, 9, 20], [3, 3, 7], [0, 1, 40]], dtype=torch.int32)
    vals = torch.tensor([[1, 2, 3]] * 3, dtype=torch.int32)
    dense, overflow = hopper_decode.posdecode(pos, vals, torch.tensor([3, 3, 3], dtype=torch.int32),
                                              4, 8)
    assert overflow.tolist() == [False, True, True]
    assert dense[0].flatten().tolist() == [0, 0, 0, 1, 0, 0, 0, 0, 0, 2] + [0] * 10 + [3] + [0] * 11
    assert hopper_decode.posdecode(pos, vals, torch.tensor([4, 0, 0], dtype=torch.int32),
                                   4, 8)[1].tolist() == [True, False, False]


def _packed_values(rng, counts, sym_bits, uniform=()):
    raws = []
    for i, k in enumerate(counts):
        vals = rng.integers(0, 1 << sym_bits, k) if i in uniform else \
            np.minimum(1 + rng.exponential(5.0, k).astype(np.int64), (1 << sym_bits) - 1)
        raws.append(joracle.bit_pack(vals.astype(np.uint64), sym_bits).tobytes())
    packed = np.zeros((len(raws), -(-max(map(len, raws)) // 3072) * 3072), np.uint8)
    for i, r in enumerate(raws):
        packed[i, :len(r)] = np.frombuffer(r, np.uint8)
    return raws, packed


@pytest.mark.parametrize("sym_bits", [12, 8])
def test_symbols_batch_matches_jax(sym_bits):
    """Device-coded (m >= 65536) and host-coded (small) streams in one
    batch, and at 12 bits a stored one (uniform values: coding loses)."""
    counts = [70000, 3000, 66000] if sym_bits == 12 else [70000, 3000]
    raws, packed = _packed_values(np.random.default_rng(25 + sym_bits), counts, sym_bits,
                                  uniform=(2,))
    plens = np.array([len(r) for r in raws])
    want = jrans.rans_symbols_batch_device(packed, plens, sym_bits, interpret=True)
    got = trans.rans_symbols_batch_device(torch.from_numpy(packed), plens, sym_bits)
    assert got == want
    assert got[0][2] == 10 and got[0][3] == 2          # 1024 lanes, symbol mode
    assert sym_bits == 8 or got[2][3] == 1             # stored
    for raw, stream in zip(raws, got):
        assert trans.decompress(stream) == raw
    assert trans.rans_decompress_device_batch(got, torch.device("cpu")) == raws


def _gap_bitmaps(rng):
    """A 1024x1024 bitmap with ~70000 set bits and one with a >= 4095-bit
    clear run (escape symbols: the host coder)."""
    n = 1024 * 1024
    bits = rng.random((2, n)) < 0.067
    bits[1, 1000:9000] = False
    return bits


def test_gaps_batch_matches_jax():
    bits = _gap_bitmaps(np.random.default_rng(26))
    bitmaps = np.packbits(bits, axis=1, bitorder="little")
    counts = bits.sum(axis=1).astype(np.int32)
    assert counts[0] >= 65536 and counts[1] >= 65536
    pos = np.zeros((2, int(counts.max())), np.int32)
    for b in range(2):
        pos[b, :counts[b]] = np.flatnonzero(bits[b])
    blens = np.full(2, bitmaps.shape[1])
    want = jrans.rans_gaps_batch_device(bitmaps, blens, positions=pos, pos_counts=counts,
                                        interpret=True)
    got = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps), blens,
                                       positions=torch.from_numpy(pos),
                                       pos_counts=torch.from_numpy(counts))
    assert got == want
    assert got[0][2] == 10 and got[0][3] == 6          # 1024 lanes, gap mode
    for b in range(2):
        assert trans.decompress(got[b]) == bitmaps[b].tobytes()
    assert trans.rans_decompress_device_batch(got, torch.device("cpu")) == \
        [bm.tobytes() for bm in bitmaps]


def test_gaps_without_positions_raise():
    """Without positions the coder takes them from the bitmap -> positions
    kernel (its twin here) and no longer raises: an empty bitmap and a
    sparse one of fewer than 65536 set bits take the host coder's bytes."""
    bitmaps = np.zeros((2, 8192), np.uint8)
    bitmaps[1, :8000:7] = 0x21
    got = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps), [8192, 8000])
    assert got == [trans.compress_gaps(bitmaps[0].tobytes()),
                   trans.compress_gaps(bitmaps[1, :8000].tobytes())]
    assert [trans.decompress(s) for s in got] == [bitmaps[0].tobytes(),
                                                  bitmaps[1, :8000].tobytes()]


def test_adler32_device_matches_zlib():
    rng = np.random.default_rng(27)
    streams = rng.integers(0, 256, (3, 70001), dtype=np.uint8)
    lengths = [70001, 0, 12345]
    got = trans._adler32_device(torch.from_numpy(streams), lengths)
    assert got == [zlib.adler32(streams[i, :n].tobytes()) for i, n in enumerate(lengths)]


def test_groups_follow_the_jax_rule():
    assert trans._groups_for(np.array([1 << 21, 65535, 5])) == 8
    assert trans._groups_for(np.array([1 << 21, 70000])) == 1
    assert trans._groups_for(np.array([100, 200])) == 1
