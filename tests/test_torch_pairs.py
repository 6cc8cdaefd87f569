"""The pairs-driven scheme-0 front end and the other alternates on the CPU.

The port's twins of kernels #1b (``encode_l1(pairs_out=)``), #15
(``tokens_from_pairs``), #8 (``assemble_split``) and #5
(``bitpack12_words``) against the JAX package (Pallas kernels in interpret
mode, or their XLA and numpy references) and against the port's own
production kernels' twins; ``deflate_batch_device(split_assemble=True)``
against ``native.deflate_sparse``.  Every comparison is exact.
"""

import zlib

import numpy as np
import pytest
import torch

from pyrecode_tpu import native as jnative
from pyrecode_tpu.codecs import dyndeflate as jdd
from pyrecode_tpu.ops import pallas_deflate as pdk
from pyrecode_tpu.ops import pallas_tokens as ptk
from pyrecode_tpu.ops.bitpack import bitpack_values_words as jax_words
from pyrecode_tpu.ops.pallas_encode import encode_l1_pallas
from pyrecode_tpu_torch import native
from pyrecode_tpu_torch.codecs import dyndeflate as tdd
from pyrecode_tpu_torch.ops import bitpack, hopper_bitpack, hopper_deflate, hopper_encode
from pyrecode_tpu_torch.ops import hopper_tokens as ht

import chip_smoke


def _jax_pairs(x, n):
    """Pairs of a byte row padded to the TPU kernel's NP (a multiple of
    CH_P, pad (n << 8)), as tests/test_pallas_tokens.py lays them out."""
    idx = np.flatnonzero(x)
    NP = -(-max(idx.size + 1, 1) // ptk.CH_P) * ptk.CH_P
    pairs = np.full((1, NP), np.int32(n) << 8, np.int32)
    pairs[0, :idx.size] = (idx.astype(np.int32) << 8) | x[idx]
    return pairs, idx


def _port_tokens(x, n, tok_bound):
    pairs, idx = _jax_pairs(x, n)
    return ht.tokens_from_pairs(torch.from_numpy(pairs), torch.tensor([idx.size], dtype=torch.int32),
                                n, tok_bound), idx


# ---------------------------------------------------------------- numpy contract


@pytest.mark.parametrize("chunk", range(4))
def test_pairs_contract_matches_jax(chunk):
    """The port's copies of gap_token_count, gap_token_value and
    tokens_from_pairs_np on test_pallas_tokens.py's 40-trial battery (ten
    trials a case), and the twin's gap schedule beside them."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        n = int(rng.integers(1, 30000))
        dens = rng.choice([0.003, 0.02, 0.1, 0.3])
        x = (rng.integers(1, 256, n) * (rng.random(n) < dens)).astype(np.uint8)
        if trial // 10 != chunk:
            continue
        idx = np.flatnonzero(x)
        got = tdd.tokens_from_pairs_np(idx, x[idx].astype(np.int64), n)
        want = jdd.tokens_from_pairs_np(idx, x[idx].astype(np.int64), n)
        assert (got is None) == (want is None)
        if want is not None:
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        gaps = np.diff(np.concatenate(([-1], idx, [n]))) - 1
        count = tdd.gap_token_count(gaps)
        assert np.array_equal(count, jdd.gap_token_count(gaps))
        assert np.array_equal(ht.gap_schedule(torch.from_numpy(gaps))[0].numpy(), count)
        G = np.repeat(gaps, count)
        j = np.arange(G.size) - np.repeat(np.cumsum(count) - count, count)
        assert np.array_equal(tdd.gap_token_value(G, j), jdd.gap_token_value(G, j))


# ------------------------------------------------------------------ #1b encode


@pytest.mark.parametrize("with_values", [True, False])
def test_encode_pairs_matches_jax(with_values):
    """encode_l1(pairs_out=) against encode_l1_pallas(pairs_out=) at the JAX
    test's 2 x 64 x 512 (pairs_out a multiple of 128, no overflow: JAX
    rounds the capacity up to 128 and clamps its counts)."""
    rng = np.random.default_rng(3)
    H, W, B = 64, 512, 2
    frames = (rng.integers(1, 4096, (B, H, W)) * (rng.random((B, H, W)) < 0.01)).astype(np.uint16)
    thr = rng.integers(0, 3, (H, W)).astype(np.uint16)
    want = encode_l1_pallas(frames, thr, out_size=2048, bucket=0, interpret=True, pairs_out=2048,
                            with_values=with_values)
    got = hopper_encode.encode_l1(torch.from_numpy(frames), torch.from_numpy(thr), 2048,
                                  with_values, pairs_out=2048)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert not got[3].any() and int(got[5].min()) > 0


def test_encode_pairs_overflow_and_ragged():
    """Counts stay exact past pairs_out and the flag is set at exactly
    pairs_out + 1; a 37 x 29 frame (n_pixels % 8 != 0) lists every nonzero
    byte of its bitmap in order; pairs cannot go with positions."""
    rng = np.random.default_rng(5)
    frames = (rng.integers(1, 4096, (3, 37, 29)) * (rng.random((3, 37, 29)) < 0.3)).astype(np.uint16)
    thr = torch.zeros((37, 29), dtype=torch.int16).view(torch.uint16)
    f = torch.from_numpy(frames)
    bitmap, _, _, _, pairs, counts = hopper_encode.encode_l1(f, thr, 37 * 29, pairs_out=200)
    for b in range(3):
        row = bitmap[b].numpy()
        nz = np.flatnonzero(row)
        assert int(counts[b]) == nz.size
        assert np.array_equal(pairs[b, :nz.size].numpy(), (nz << 8) | row[nz])
        assert not pairs[b, nz.size:].any()
    k = int(counts.min())
    over = hopper_encode.encode_l1(f, thr, 37 * 29, pairs_out=k)
    assert torch.equal(over[5], counts)
    assert over[3].tolist() == (counts > k).tolist()
    with pytest.raises(ValueError):
        hopper_encode.encode_l1(f, thr, 100, True, True, 12, pairs_out=100)


# ------------------------------------------------------------ #15 tokens


@pytest.mark.parametrize("dens", [0.01, 0.06])
def test_tokens_from_pairs_matches_jax(dens):
    """tokens_from_pairs against tokens_from_pairs_device(interpret=True)
    at n = 20000: tokens (the whole row), counts, histogram bins 0..285,
    adler and flag."""
    rng = np.random.default_rng(1)
    n = 20000
    x = (rng.integers(1, 256, n) * (rng.random(n) < dens)).astype(np.uint8)
    pairs, idx = _jax_pairs(x, n)
    want = ptk.tokens_from_pairs_device(pairs, np.array([idx.size]), n, tok_bound=1 << 14,
                                        interpret=True)
    got = ht.tokens_from_pairs(torch.from_numpy(pairs), torch.tensor([idx.size], dtype=torch.int32),
                               n, 1 << 14)
    assert not bool(np.asarray(want[3])[0]) and not bool(got[3][0])
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1][0, :286].numpy(), np.asarray(want[1])[0, :286])
    assert not got[1][0, 286:].any()
    assert int(got[2][0]) == int(np.asarray(want[2])[0])
    assert int(got[4][0]) == int(np.asarray(want[4])[0]) == zlib.adler32(x.tobytes())


def test_tokens_from_pairs_run_of_four_flagged_by_both():
    y = np.zeros(4096, np.uint8)
    y[100:104] = 9
    y[::8] = 1
    pairs, idx = _jax_pairs(y, y.size)
    jflag = ptk.tokens_from_pairs_device(pairs, np.array([idx.size]), y.size, tok_bound=1 << 12,
                                         interpret=True)[3]
    (_, _, _, flag, _), _ = _port_tokens(y, y.size, 1 << 12)
    assert bool(np.asarray(jflag)[0]) and bool(flag[0])
    assert tdd.tokens_from_pairs_np(idx, y[idx].astype(np.int64), y.size) is None


def test_tokens_from_pairs_long_gap_unflagged():
    """A gap of more than 1549 bytes: the TPU kernel flags the frame; the
    port tokenizes it, equal to tokens_from_pairs_np."""
    n = 30000
    x = np.zeros(n, np.uint8)
    x[0] = 5
    x[n - 1] = 7
    pairs, idx = _jax_pairs(x, n)
    jflag = ptk.tokens_from_pairs_device(pairs, np.array([idx.size]), n, tok_bound=1 << 12,
                                         interpret=True)[3]
    assert bool(np.asarray(jflag)[0])
    (tok, hist, count, flag, adler), _ = _port_tokens(x, n, 1 << 12)
    lut, sym = tdd.tokens_from_pairs_np(idx, x[idx].astype(np.int64), n)
    assert not bool(flag[0]) and int(count[0]) == lut.size
    assert np.array_equal(tok[0, :lut.size].numpy(), 512 - lut) and not tok[0, lut.size:].any()
    assert np.array_equal(hist[0].numpy(), np.bincount(sym, minlength=512))
    assert int(adler[0]) == zlib.adler32(x.tobytes())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 261, 262, 263, 519, 520, 521, 778, 5000])
def test_tokens_from_pairs_tail_sentinel_alone(n):
    """No pairs: the sentinel's gap is the whole stream (G <= 3 gives G
    literals, not a match), equal to the byte tokenizer's tokens."""
    x = np.zeros(n, np.uint8)
    (tok, hist, count, flag, adler), _ = _port_tokens(x, n, 64)
    lut, sym = jdd.tokenize_bytes_np(x)
    keep = lut != jdd.NO_TOKEN
    assert int(count[0]) == int(keep.sum()) and not bool(flag[0])
    assert np.array_equal(tok[0, :int(count[0])].numpy(), 512 - lut[keep])
    ref_hist = tdd.histogram_np(sym)
    ref_hist[256] -= 1                           # the kernels do not count end of block
    assert np.array_equal(ref_hist, jdd.histogram_np(sym) - (np.arange(286) == 256))
    assert np.array_equal(hist[0, :286].numpy(), ref_hist)
    assert int(adler[0]) == zlib.adler32(x.tobytes())


def test_tokens_from_pairs_overflow_keeps_counts_and_hist():
    rng = np.random.default_rng(9)
    n = 9000
    x = (rng.integers(1, 256, n) * (rng.random(n) < 0.05)).astype(np.uint8)
    (full, hist, count, _, _), _ = _port_tokens(x, n, 4 * n)
    (cut, hist2, count2, _, _), _ = _port_tokens(x, n, int(count[0]) // 3)
    assert torch.equal(count2, count) and torch.equal(hist2, hist)
    assert torch.equal(cut[0], full[0, :int(count[0]) // 3])


def test_tokens_from_pairs_adler_at_count_zero_and_np():
    """The wrapper's CPU route returns adler_from_pairs's value, zlib's
    adler32 of the bytes, for a row whose counts are 0 and one whose counts
    are np (every pair valid, np % 4 != 0)."""
    rng = np.random.default_rng(12)
    n = 7001
    rows = np.zeros((2, n), np.uint8)
    rows[1, rng.choice(n, 301, replace=False)] = rng.integers(1, 256, 301)
    pairs, counts = hopper_encode.bitmap_pairs(torch.from_numpy(rows), 301)
    assert counts.tolist() == [0, pairs.shape[1]] and pairs.shape[1] % 4 == 1
    adler = ht.tokens_from_pairs(pairs, counts, n, 4 * n)[4]
    assert torch.equal(adler, ht.adler_from_pairs(pairs, counts, n))
    assert adler.tolist() == [zlib.adler32(r.tobytes()) for r in rows]


def test_pairs_route_matches_tokenize_compact():
    """encode with pairs, then tokens_from_pairs, equals tokenize_compact on
    the same bitmaps: tokens (the whole row), counts, bins 0..285, adler."""
    rng = np.random.default_rng(11)
    data, dark = chip_smoke.make_frames(rng, 3, 64, 128)
    puddles, pdark = chip_smoke.make_puddle_frames(rng, 3, 64, 128, hits=40000 * 64)
    for frames, thr in ((data, dark + 2), (puddles, pdark + 2)):
        f, t = torch.from_numpy(frames), torch.from_numpy(thr.astype(np.uint16))
        bitmap, _, _, _, pairs, pcounts = hopper_encode.encode_l1(f, t, 64 * 128, pairs_out=1024)
        n = bitmap.shape[1]
        bound = 4 * n
        tok, hist, counts, flag, adler = ht.tokens_from_pairs(pairs, pcounts, n, bound)
        lengths = torch.full((3,), n, dtype=torch.int32)
        comp, bhist, badler, bcounts, _ = hopper_deflate.tokenize_compact(bitmap, lengths, bound)
        assert not flag.any()
        assert torch.equal(tok, comp) and torch.equal(counts, bcounts)
        assert torch.equal(hist[:, :286], bhist[:, :286]) and torch.equal(adler, badler)


# ---------------------------------------------------------- #8 split assembly


def _dyn_tables(hist):
    """A stream's token LUT (48, 32), header phase and partial byte from its
    tokenizer histogram, by the JAX package's native tables."""
    lfreq = hist.astype(np.uint32)
    lfreq[256] += 1
    llen, lcode = jnative.dyn_tables(lfreq)
    hb, hbits = jnative.dyn_header(llen)
    return jdd.luts_as_radix(llen, lcode), hbits % 8, int(hb[-1]) if hbits % 8 else 0


def _split_inputs():
    rng = np.random.default_rng(3)
    n = pdk.CH_A - 101
    raw = (rng.integers(0, 256, n) * (rng.random(n) < 0.05)).astype(np.uint8)
    streams = np.zeros((1, pdk.CH_A), np.uint8)
    streams[0, :n] = raw
    lens = np.array([n], np.int32)
    tok, hist, _ = hopper_deflate.tokenize(torch.from_numpy(streams), torch.from_numpy(lens))
    lut, phase, partial = _dyn_tables(hist[0, :286].numpy())
    return (tok, lut[None], np.array([phase], np.int32), np.array([partial], np.int32),
            2 * streams.shape[1] + 256)


def test_assemble_split_matches_jax_and_assemble():
    """assemble_split against assemble_pallas_split(interpret=True) on one
    CH_A stream (the JAX test's), and against the port's assemble on its
    uint16 and compacted int32 tokens."""
    tok, luts, phase, partial, out_bound = _split_inputs()
    want = pdk.assemble_pallas_split(tok.numpy(), luts, phase, partial, out_bound, interpret=True)
    args = [torch.from_numpy(a) for a in (luts, phase, partial)]
    got = hopper_deflate.assemble_split(tok, *args, out_bound)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1][0]) == int(np.asarray(want[1])[0])
    assert not got[2].any() and not np.asarray(want[2]).any()
    comp = hopper_deflate.compact_tokens(tok, tok.shape[1])[0]
    for t in (tok, comp):
        for bound in (out_bound, 300):
            for g, w in zip(hopper_deflate.assemble_split(t, *args, bound),
                            hopper_deflate.assemble(t, *args, bound)):
                assert torch.equal(g, w)


def test_assemble_split_empty_streams_match_jax():
    """assemble_split against assemble_pallas_split(interpret=True) on three
    streams of one CH_A batch: a sparse one, one of no tokens and one of a
    single token, each with its own tables, phase and partial byte."""
    rng = np.random.default_rng(5)
    n = pdk.CH_A
    streams = np.zeros((3, n), np.uint8)
    streams[0, :n - 77] = rng.integers(0, 256, n - 77) * (rng.random(n - 77) < 0.05)
    streams[2, 0] = 9
    lens = np.array([n - 77, 0, 1], np.int32)
    tok, hist, _ = hopper_deflate.tokenize(torch.from_numpy(streams), torch.from_numpy(lens))
    assert (tok != 0).sum(dim=1).tolist()[1:] == [0, 1]
    tables = [_dyn_tables(hist[b, :286].numpy()) for b in range(3)]
    luts = np.stack([t[0] for t in tables])
    phase, partial = (np.array([t[k] for t in tables], np.int32) for k in (1, 2))
    out_bound = 2 * n + 256
    want = pdk.assemble_pallas_split(tok.numpy(), luts, phase, partial, out_bound, interpret=True)
    got = hopper_deflate.assemble_split(tok, *map(torch.from_numpy, (luts, phase, partial)),
                                        out_bound)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    assert not got[2].any() and not np.asarray(want[2]).any()


@pytest.mark.parametrize("hinted", [False, True])
def test_deflate_batch_split_matches_native(hinted):
    rng = np.random.default_rng(13)
    t = hopper_deflate.TILE
    raws = [b"", b"\x00" * (3 * t + 17), b"X" * (t - 6) + b"\x00" * 5000 + b"Y",
            (rng.integers(0, 256, 9000) * (rng.random(9000) < 0.02)).astype(np.uint8).tobytes(),
            rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
            rng.integers(0, 3, 11000, dtype=np.uint8).tobytes()]
    streams = np.zeros((len(raws), 4 * t), np.uint8)
    for i, raw in enumerate(raws):
        streams[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    lengths = [len(r) for r in raws]
    hint = {"density": 0.05} if hinted else None
    out = tdd.deflate_batch_device(torch.from_numpy(streams), lengths, hint_state=hint,
                                   split_assemble=True)
    assert out == [native.deflate_sparse(r) for r in raws]


# ---------------------------------------------------------- #5 word pack


@pytest.mark.parametrize("n", [8, 1000, 4104, 65536])
def test_bitpack12_words_matches_jax(n):
    """bitpack12_words' bytes against JAX bitpack_values_words(v, 12) for
    any int32 read as uint32, and against bitpack12 below 4096."""
    rng = np.random.default_rng(n)
    v = rng.integers(-2**31, 2**31, (2, n)).astype(np.int32)
    got = hopper_bitpack.bitpack12_words(torch.from_numpy(v))
    assert got.shape == (2, 3 * n // 8) and got.dtype == torch.int32
    assert np.array_equal(got.view(torch.uint8).numpy(), np.asarray(jax_words(v, 12)))
    small = torch.from_numpy(v & 4095)
    assert torch.equal(hopper_bitpack.bitpack12_words(small).view(torch.uint8),
                       hopper_bitpack.bitpack12(small))
    assert bitpack.packed_word_group_shape(12) == (8, 3)


def test_alternates_phase_rehearsal(tmp_path):
    """chip_smoke's phase 9 at 64 x 128 on the CPU: every stream of the
    alternates path equals native.deflate_sparse and the default path's."""
    rng = np.random.default_rng(17)
    data, dark = chip_smoke.make_frames(rng, 8, 64, 128)
    puddles, pdark = chip_smoke.make_puddle_frames(rng, 8, 64, 128, hits=40000 * 64)
    report = chip_smoke.run_alternates(torch.device("cpu"), data, dark, puddles, pdark)
    assert report["streams"] == 2 * 16
    assert report["flagged"] < 16
