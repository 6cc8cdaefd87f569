"""The CUDA kernels of pyrecode_tpu_torch against their plain twins on the
card, exactly, the device deflate against the native host encoder, and the
reader's copy of its frames into pinned host memory.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import filecmp
import gc

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import InputParams, native
from pyrecode_tpu_torch import reader as reader_mod
from pyrecode_tpu_torch.codecs import rans
from pyrecode_tpu_torch.codecs.dyndeflate import deflate_batch_device, host_tables
from pyrecode_tpu_torch.ops import (_launch, hopper_bitpack, hopper_decode, hopper_deflate,
                                    hopper_encode, hopper_gaps, hopper_label, hopper_probes,
                                    hopper_rans, hopper_tokens)
from pyrecode_tpu_torch.tools import probe_f32dot
from chip_smoke import (DECODE_SHAPES, assemble_battery, decode_battery, hist_battery,
                        label_edge_frames, label_tile_shapes, make_puddle_frames,
                        posdecode_span_battery)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _frames(density, shape, batch=3, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.where(rng.random((batch, *shape)) < density,
                      rng.integers(1, 4096, (batch, *shape)), 0).astype(np.uint16)
    thr = rng.integers(0, 32, size=shape).astype(np.uint16)
    return frames, thr


def _equal(got, want):
    for g, w in zip(got, want):
        if g is None or w is None:
            assert g is None and w is None
        elif g.dtype == torch.uint16:
            assert torch.equal(g.view(torch.int16), w.view(torch.int16))
        else:
            assert torch.equal(g, w)


def test_bitpack12_matches_twin(cuda):
    rng = np.random.default_rng(11)
    v = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 100002)).astype(np.int32)).to(cuda)
    _equal([hopper_bitpack.bitpack12(v)], [hopper_bitpack.bitpack12_plain(v)])


def test_bitunpack12_matches_twin(cuda):
    rng = np.random.default_rng(12)
    b = torch.from_numpy(rng.integers(0, 256, (3, 30003), dtype=np.uint8)).to(cuda)
    _equal([hopper_bitpack.bitunpack12(b)], [hopper_bitpack.bitunpack12_plain(b)])


# (37, 29), (1, 4101), (64, 4099): n % 8 != 0 (scalar loads, frames not
# 16-byte aligned) and a partial last tile; (2048, 2049): 1025 tiles, a
# look-back of several rounds, vector loads, a partial last tile, and a
# block walking two or five frames
ENCODE_SHAPES = [(96, 160), (37, 29), (1, 4101), (64, 4099), (2048, 2049)]
# random: the 20% frames and two capacities; edges: a 20% frame, an empty
# one and an all-foreground one; last_tile: one foreground pixel a frame,
# at its last pixel; batch9: 9 frames
ENCODE_CASES = ["random", "edges", "last_tile", "batch9"]


def _encode_case(case, shape, seed, random_sizes):
    """Frames and threshold (numpy) of one encode case, and the out_sizes
    to try: ``random_sizes`` for "random", else 0, n and every frame's
    foreground count - 1, + 0 and + 1."""
    n = shape[0] * shape[1]
    frames, thr = _frames(0.05 if case == "batch9" else 0.2, shape,
                          batch=9 if case == "batch9" else 3, seed=seed)
    if case == "random":
        return frames, thr, random_sizes
    if case == "edges":
        frames[1] = 0
        frames[2] = 4095
    elif case == "last_tile":
        frames[:] = 0
        frames[:, -1, -1] = 4095
    counts = (frames > thr).reshape(frames.shape[0], -1).sum(axis=1)
    sizes = {0, n} | {int(c) + d for c in counts for d in (-1, 0, 1)}
    return frames, thr, sorted(s for s in sizes if s >= 0)


@pytest.mark.parametrize("case", ENCODE_CASES)
@pytest.mark.parametrize("shape", ENCODE_SHAPES)
@pytest.mark.parametrize("with_values", [True, False])
def test_encode_l1_matches_twin(cuda, shape, with_values, case):
    n = shape[0] * shape[1]
    frames, thr, sizes = _encode_case(case, shape, 13, (n, 100))   # fits; overflows
    f, t = torch.from_numpy(frames).to(cuda), torch.from_numpy(thr).to(cuda)
    for out_size in sizes:
        got = hopper_encode.encode_l1(f, t, out_size, with_values)
        _equal(got, hopper_encode.encode_l1_plain(f, t, out_size, with_values))


@pytest.mark.parametrize("case", ENCODE_CASES)
@pytest.mark.parametrize("shape", ENCODE_SHAPES)
def test_encode_l1_positions_matches_twin(cuda, shape, case):
    n = shape[0] * shape[1]
    frames, thr, sizes = _encode_case(case, shape, 17, (n, 100))   # fits; overflows
    if case != "last_tile":
        frames[0, 0, :5] = 4095 + np.arange(5, dtype=np.uint16) * 1000   # values above 12 bits
    f, t = torch.from_numpy(frames).to(cuda), torch.from_numpy(thr).to(cuda)
    for out_size in sizes:
        for vbits in (0, 12):
            got = hopper_encode.encode_l1(f, t, out_size, True, True, vbits)
            _equal(got, hopper_encode.encode_l1_plain(f, t, out_size, True, True, vbits))


def _symbols(seed, B, npad, m):
    rng = np.random.default_rng(seed)
    vals = np.minimum(rng.exponential(8.0, (B, npad)).astype(np.int32), 4095)
    vals[-1] = rng.integers(0, 4096, npad)      # every symbol of the alphabet
    m = np.asarray(m, np.int32)
    hist = np.stack([np.bincount(vals[b, :m[b]], minlength=4096) for b in range(B)])
    freq = np.stack([rans.quantize_freqs(h).astype(np.int32) for h in hist])
    cum = np.zeros_like(freq)
    cum[:, 1:] = np.cumsum(freq, axis=1)[:, :-1]
    return vals, freq, cum, m


def test_rans_hist_matches_twin(cuda):
    vals, _, _, m = _symbols(18, 4, 50000, [50000, 1025, 0, 33333])
    v, mm = torch.from_numpy(vals).to(cuda), torch.from_numpy(m).to(cuda)
    _equal([hopper_rans.rans_hist(v, mm)], [hopper_rans.rans_hist_plain(v, mm)])


HIST_CASES = [what for what, *_ in hist_battery(np.random.default_rng(0))]


@pytest.mark.parametrize("case", HIST_CASES)
def test_rans_hist_edges_match_twin(cuda, case):
    """One cluster launch a call on the edge battery: one symbol 2^21 times,
    all 4096 symbols, m = 0, out-of-range symbols inside m and junk past it,
    rows not 16-byte aligned, 40 streams, a long stream beside a short one."""
    _, vals, m = next(c for c in hist_battery(np.random.default_rng(24)) if c[0] == case)
    v, mm = torch.from_numpy(vals).to(cuda), torch.from_numpy(m).to(cuda)
    before = hopper_rans.HIST_LAUNCHES.value
    got = hopper_rans.rans_hist(v, mm)
    assert hopper_rans.HIST_LAUNCHES.value == before + 1
    _equal([got], [hopper_rans.rans_hist_plain(v, mm)])
    live = np.arange(vals.shape[1])[None, :] < m[:, None]
    want = [np.bincount(row[k & (row >= 0) & (row < 4096)], minlength=4096)
            for row, k in zip(vals, live)]
    assert np.array_equal(got.cpu().numpy(), np.stack(want))


def _tables(vals, m):
    """Quantized tables (B, 4096) int32 of each stream's first m symbols,
    masked to 12 bits as the encode masks them, and their prefix."""
    hist = np.stack([np.bincount(vals[b, :m[b]] & 4095, minlength=4096) for b in range(len(m))])
    freq = np.stack([rans.quantize_freqs(h).astype(np.int32) for h in hist])
    cum = np.zeros_like(freq)
    cum[:, 1:] = np.cumsum(freq, axis=1)[:, :-1]
    return freq, cum


def _junk_past(vals, m):
    """Symbols the encode must not read past each stream's m: negative, and
    at and past 4096."""
    junk = np.array([-1, 4096, 99999, -2**31, 2**31 - 1], np.int32)
    for b, k in enumerate(m):
        vals[b, k:] = np.resize(junk, vals.shape[1] - k)


# mixed: m not a multiple of 1024, a one-symbol alphabet, m = 0, all 4096
# symbols (unaligned: the same with the tables 4 bytes off a 16-byte
# boundary, read without vector loads); f1: every symbol at f = 1 (12 bits a symbol, the first two bytes
# and then one or two a symbol); rows9: nine streams of m = 0, 1, nways - 1,
# nways, nways + 1 and longer, with junk past m and symbols outside 0..4095
# inside it (masked to 12 bits); long8: 2^21 + 1000 symbols beside a short
# stream; many40: 40 streams of different lengths; empty: three streams of
# m = 0 (no scratch rows at all)
RANS_ENCODE_CASES = [("mixed", 1), ("mixed", 8), ("unaligned", 1), ("f1", 1), ("rows9", 1), ("rows9", 8),
                     ("long8", 8), ("many40", 1), ("empty", 1)]


def _rans_encode_case(case, groups):
    """Symbols (B, NPAD) int32, tables, m and the symbols each stream
    decodes to (the first m, masked to 12 bits)."""
    nways = hopper_rans.W_LANES * groups
    rng = np.random.default_rng(19)
    if case in ("mixed", "unaligned"):
        vals, freq, cum, m = _symbols(19, 5, 70000, [70000, 1025, 5000, 0, 65537])
        vals[2] = 7
        freq[2] = 0
        freq[2, 7] = 4096
        cum[2] = 0
        cum[2, 8:] = 4096
        return vals, freq, cum, m
    if case == "f1":
        vals = rng.integers(0, 4096, (2, 70000)).astype(np.int32)
        m = np.array([70000, 3333], np.int32)
        freq = np.ones((2, 4096), np.int32)
        cum = np.broadcast_to(np.arange(4096, dtype=np.int32), (2, 4096)).copy()
        return vals, freq, cum, m
    if case == "rows9":
        m = np.array([0, 1, nways - 1, nways, nways + 1, 3 * nways + 5, 5000, 20000, 70001],
                     np.int32)
        vals = np.minimum(rng.exponential(8.0, (9, 70001)).astype(np.int32), 4095)
        vals[8, ::97] = rng.integers(-2**31, 2**31, vals[8, ::97].size)
        _junk_past(vals, m)
    elif case == "empty":
        m = np.zeros(3, np.int32)
        vals = rng.integers(-2**31, 2**31, (3, 5000)).astype(np.int32)
    elif case == "long8":
        long = (1 << 21) + 1000
        m = np.array([long, 3000], np.int32)
        vals = np.minimum(rng.exponential(8.0, (2, long)).astype(np.int32), 4095)
        _junk_past(vals, m)
    else:
        m = rng.integers(0, 20000, 40).astype(np.int32)
        m[0] = 20000
        vals = np.minimum(rng.exponential(8.0, (40, 20000)).astype(np.int32), 4095)
        vals[-1] = rng.integers(0, 4096, 20000)
    return (vals, *_tables(vals, m), m)


def test_rans_encode_state_matches_division(cuda):
    """The encode step's reciprocal against / and % on
    chip_smoke.state_battery: every f in 1..4096 at the ends of the states
    a step divides and around multiples of f there."""
    from chip_smoke import state_battery

    for arrays in state_battery(np.random.default_rng(23)):
        args = [torch.from_numpy(a).to(cuda) for a in arrays]
        before = hopper_rans.ENCODE_STATE_LAUNCHES.value
        got = hopper_rans.rans_encode_state(*args)
        assert hopper_rans.ENCODE_STATE_LAUNCHES.value == before + 1
        _equal([got], [hopper_rans.rans_encode_state_plain(*args)])


def _decodes_to(cuda, encoded, freq, m, groups, want, streams=None):
    """The decode kernel gives each encoded stream's first m symbols back:
    ``want`` (B, >= max m) int numpy; only ``streams`` (indices) if given."""
    body, states, counts = encoded
    n = counts.cpu().numpy()
    rev = np.zeros((len(n), max(int(n.max()), 1)), np.uint8)
    host = body.cpu().numpy()
    for b in range(len(n)):
        rev[b, :n[b]] = host[b, :n[b]][::-1]
    tables = torch.from_numpy(np.stack([hopper_rans.decode_tables(f) for f in freq])).to(cuda)
    m_t = torch.from_numpy(np.asarray(m, np.int32)).to(cuda)
    syms, underflow = _check_decode([torch.from_numpy(rev).to(cuda), counts, states, m_t, tables,
                                     max(int(np.max(m)), 1), groups])
    for b in range(len(n)) if streams is None else streams:
        assert not bool(underflow[b])
        assert np.array_equal(syms[b, :m[b]].cpu().numpy(), want[b, :m[b]])


def _bounds(counts):
    """Body bounds around the largest count: one short, exact, one over, and 0."""
    c = int(counts.max())
    return sorted({max(c - 1, 0), c, c + 1, 0})


@pytest.mark.parametrize("case, groups", RANS_ENCODE_CASES)
def test_rans_encode_decode_match_twins(cuda, case, groups):
    """#9 on each case at a bound that fits and at _bounds (equal to the
    twin byte for byte, the kernel launched once a call); every stream
    decodes back to its symbols."""
    vals, freq, cum, m = _rans_encode_case(case, groups)
    args = [torch.from_numpy(a).to(cuda) for a in (vals, freq, cum, m)]
    if case == "unaligned":
        for i in (1, 2):
            flat = torch.zeros(args[i].numel() + 1, dtype=torch.int32, device=cuda)
            flat[1:] = args[i].ravel()
            args[i] = flat[1:].view(args[i].shape)
    full = 2 * vals.shape[1] + 16
    encoded = hopper_rans.rans_encode(*args, full, groups)
    for out_bound in [full, *_bounds(encoded[2])]:
        before = hopper_rans.ENCODE_LAUNCHES.value
        got = hopper_rans.rans_encode(*args, out_bound, groups)
        assert hopper_rans.ENCODE_LAUNCHES.value == before + 1
        _equal(got, hopper_rans.rans_encode_plain(*args, out_bound, groups))
    _decodes_to(cuda, encoded, freq, m, groups, vals & 4095)


def _decode_args(cuda, vals, freq, cum, m, groups, width=None, npad=None):
    """The decode's arguments for symbol streams coded by the encode kernel:
    bodies reversed into rows of ``width`` bytes (the longest body by
    default), ``npad`` symbols (the largest m by default)."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (vals, freq, cum, m)]
    out_bound = 2 * vals.shape[1] + 16
    body, states, counts = hopper_rans.rans_encode(*args, out_bound, groups)
    n = counts.cpu().numpy()
    width = int(n.max()) if width is None else width
    rev = np.zeros((len(n), width), np.uint8)
    host = body.cpu().numpy()
    for b in range(len(n)):
        rev[b, :n[b]] = host[b, :n[b]][::-1]
    tables = torch.from_numpy(np.stack([hopper_rans.decode_tables(f) for f in freq])).to(cuda)
    npad = max(int(m.max()), 1) if npad is None else npad
    return [torch.from_numpy(rev).to(cuda), counts, states, args[3], tables, npad, groups]


def _check_decode(dec):
    before = hopper_rans.DECODE_LAUNCHES.value
    got = hopper_rans.rans_decode(*dec)
    assert hopper_rans.DECODE_LAUNCHES.value == before + 1
    _equal(got, hopper_rans.rans_decode_plain(*dec))
    return got


@pytest.mark.parametrize("groups", [1, 8])
def test_rans_decode_edges_match_twin(cuda, groups):
    """Rows of body_width % 16 != 0, npad > m (zeros past m), m = 0, m <
    1024, m not a multiple of nways, npad < m (nothing stored past npad);
    then bodies one byte short at the first row and in the middle of a
    stream (underflow)."""
    vals, freq, cum, m = _symbols(41, 5, 30000, [30000, 700, 0, 29999, 8193])
    width = 2 * 30000 + 21
    dec = _decode_args(cuda, vals, freq, cum, m, groups, width=width, npad=30000 + 37)
    assert width % 16 and dec[0].shape[1] == width
    syms, underflow = _check_decode(dec)
    assert not bool(underflow.any())
    for b in range(5):
        assert torch.equal(syms[b, :m[b]].cpu(), torch.from_numpy(vals[b, :m[b]]))
    assert not bool(syms[:, 30000:].any())
    cut, cut_underflow = _check_decode([*dec[:5], 8000, groups])
    assert not bool(cut_underflow.any()) and torch.equal(cut, syms[:, :8000])

    # the bytes the first r rows of stream 0 take: the least blen they decode with
    nways = hopper_rans.W_LANES * groups
    one = [t[:1] for t in dec[:5]]

    def taken(rows):
        lo, hi = 0, int(dec[1][0])
        mm = torch.tensor([min(rows * nways, int(m[0]))], dtype=torch.int32, device=cuda)
        while lo < hi:
            mid = (lo + hi) // 2
            bl = torch.tensor([mid], dtype=torch.int32, device=cuda)
            if bool(hopper_rans.rans_decode_plain(one[0], bl, one[2], mm, one[4], 30000,
                                                  groups)[1][0]):
                lo = mid + 1
            else:
                hi = mid
        return lo

    middle = -(-int(m[0]) // nways) // 2
    short = torch.tensor([taken(1) - 1, taken(middle) - 1], dtype=torch.int32, device=cuda)
    dec_short = [one[0].repeat(2, 1), short, one[2].repeat(2, 1), one[3].repeat(2),
                 one[4].repeat(2, 1, 1), 30000, groups]
    syms, underflow = _check_decode(dec_short)
    assert underflow.tolist() == [True, True]
    assert not bool(syms[0, nways:].any()) and bool(syms[1, (middle - 1) * nways:].any())


def test_rans_decode_many_streams_and_long_match_twin(cuda):
    """40 streams of different lengths at groups 1; one stream of more than
    2^21 symbols at groups 8."""
    lengths = [int(x) for x in np.random.default_rng(42).integers(0, 20000, 40)]
    lengths[0] = 20000
    vals, freq, cum, m = _symbols(43, 40, 20000, lengths)
    syms, underflow = _check_decode(_decode_args(cuda, vals, freq, cum, m, 1))
    assert not bool(underflow.any())
    long = (1 << 21) + 1000
    vals, freq, cum, m = _symbols(44, 2, long, [long, long - 5000])
    syms, underflow = _check_decode(_decode_args(cuda, vals, freq, cum, m, 8))
    assert not bool(underflow.any())
    assert torch.equal(syms[0].cpu(), torch.from_numpy(vals[0]))


def _token_case(case, cuda):
    """Inverted int32 token streams (B, N) and their counts m of a #9t case,
    and the indices of the streams that hold no pad or out-of-range token
    before m (those decode back to their tokens' symbols).  streams: the
    tokens of byte streams, compacted; battery: empty, one token, literals
    only, every length code, a one-symbol alphabet, pad and out-of-range
    tokens; rows9: nine streams of m = 0, 1, 1023, 1024, 1025 and longer,
    pad and out-of-range tokens past m, and among the counted ones in the
    last; many40: 40 streams of different lengths."""
    from chip_smoke import token_battery

    rng = np.random.default_rng(22)
    if case == "streams":
        raws, streams, lengths = _streams()
        s, n = torch.from_numpy(streams).to(cuda), torch.from_numpy(lengths).to(cuda)
        tok, hist, _ = hopper_deflate.tokenize(s, n)
        m = hist[:, :286].sum(dim=1, dtype=torch.int32)
        dense = hopper_deflate.compact_tokens(tok, int(m.max()))[0]
        return dense.cpu().numpy(), m.cpu().numpy(), range(len(raws))
    if case == "battery":
        tok, m = token_battery(np.random.default_rng(21))
        return tok, m, range(5)
    if case == "rows9":
        m = np.array([0, 1, 1023, 1024, 1025, 3077, 5000, 20000, 70001], np.int32)
        tok = hopper_rans.NO_TOKEN - rng.integers(0, 512, (9, 70001))
        junk = np.array([0, 600, 65535, -7, 2**31 - 1])
        for b, k in enumerate(m):
            tok[b, k:] = np.resize(junk, tok.shape[1] - k)
        tok[8, ::97] = np.resize(junk, tok[8, ::97].size)
        return tok.astype(np.int32), m, range(8)
    m = rng.integers(0, 20000, 40).astype(np.int32)
    m[0] = 20000
    tok = hopper_rans.NO_TOKEN - rng.integers(0, 512, (40, 20000))
    return tok.astype(np.int32), m, range(40)


@pytest.mark.parametrize("case", ["streams", "battery", "rows9", "many40"])
def test_rans_encode_tokens_matches_twin(cuda, case):
    """#9t on int32 and uint16 tokens of each case, at a bound that fits,
    at 100 and at _bounds: equal to the twin byte for byte, the kernel
    launched once a call (not the twin); the streams without pads decode
    back to their tokens' symbols; the byte-mode coder of byte streams
    equals its CPU run."""
    from chip_smoke import token_tables

    tok, m, clean = _token_case(case, cuda)
    freq, cum = token_tables(tok, m)
    tables = [torch.from_numpy(a).to(cuda) for a in (freq, cum)]
    t32 = torch.from_numpy(tok).to(cuda)
    k = torch.from_numpy(m).to(cuda)
    full = 2 * tok.shape[1] + 16
    encoded = hopper_rans.rans_encode_tokens(t32, *tables, k, full)
    for t in (t32, _launch.i32_to_u16(t32)):
        for out_bound in [full, 100, *_bounds(encoded[2])]:
            before = hopper_rans.ENCODE_TOKENS_LAUNCHES.value
            got = hopper_rans.rans_encode_tokens(t, *tables, k, out_bound)
            assert hopper_rans.ENCODE_TOKENS_LAUNCHES.value == before + 1
            _equal(got, hopper_rans.rans_encode_tokens_plain(t, *tables, k, out_bound))
    idx = np.clip(hopper_rans.NO_TOKEN - tok.astype(np.int64), 0, hopper_rans.NO_TOKEN - 1)
    _decodes_to(cuda, encoded, freq, m, 1, np.asarray(hopper_rans.TOKEN_SYMBOL)[idx], clean)
    if case == "streams":
        _, streams, lengths = _streams()
        assert rans.rans_batch_device(torch.from_numpy(streams).to(cuda), lengths) == \
            rans.rans_batch_device(torch.from_numpy(streams), lengths)


def test_posdecode_matches_twin(cuda):
    rng = np.random.default_rng(20)
    H, W = 96, 160
    pos = np.zeros((3, 4000), np.int32)
    counts = np.array([3000, 0, 4000], np.int32)
    for b in (0, 2):
        pos[b, :counts[b]] = np.sort(rng.choice(H * W, counts[b], replace=False))
    vals = rng.integers(0, 4096, pos.shape).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (pos, vals, counts)]
    got = hopper_decode.posdecode(*args, H, W)
    _equal(got, hopper_decode.posdecode_plain(*args, H, W))
    assert not bool(got[1].any())
    bad = pos.copy()
    bad[2, 10] = H * W                          # outside the frame
    counts[0] = 4001                            # more than the width
    args = [torch.from_numpy(a).to(cuda) for a in (bad, vals, counts)]
    assert hopper_decode.posdecode(*args, H, W)[1].tolist() == [True, False, True]


def test_posdecode_span_battery_matches_twin(cuda):
    """Positions on span edges, empty and full spans, count 0 and = width,
    H*W % 8 != 0 and repeated positions: one launch a call; the flags equal
    the twin's and the expected ones, the dense frames of unflagged frames
    the twin's."""
    for what, *arrays, h, w, flagged in posdecode_span_battery(np.random.default_rng(21)):
        args = [torch.from_numpy(a).to(cuda) for a in arrays]
        before = hopper_decode.POSDECODE_LAUNCHES.value
        dense, overflow = hopper_decode.posdecode(*args, h, w)
        assert hopper_decode.POSDECODE_LAUNCHES.value == before + 1, what
        want_dense, want_overflow = hopper_decode.posdecode_plain(*args, h, w)
        assert overflow.tolist() == want_overflow.tolist() == flagged, what
        clean = ~want_overflow
        assert torch.equal(dense.view(torch.int16)[clean], want_dense.view(torch.int16)[clean]), \
            what


@pytest.mark.parametrize("case", ["30%", "edges"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_l1_matches_twin(cuda, shape, case):
    """One launch a call; every pixel against the twin, the overflow flag at
    V = the count, the count - 1 and 0."""
    bitmap_np, values_list = decode_battery(np.random.default_rng(14), shape, case)
    bitmap = torch.from_numpy(bitmap_np).to(cuda)
    for values_np in values_list:
        values = torch.from_numpy(values_np).to(cuda)
        before = hopper_decode.LAUNCHES.value
        got = hopper_decode.decode_l1(bitmap, values, *shape)
        assert hopper_decode.LAUNCHES.value == before + 1
        _equal(got, hopper_decode.decode_l1_plain(bitmap, values, *shape))


def _streams(seed=16):
    """Byte streams across the tokenizer's 4096-byte tiles: sparse, one long
    zero run, one across more tiles than a block searches at a time for its
    run start, random (stored), literal-dense, empty; padded to one width."""
    rng = np.random.default_rng(seed)
    t = hopper_deflate.TILE
    raws = [(rng.integers(0, 256, 3 * t) * (rng.random(3 * t) < 0.03)).astype(np.uint8).tobytes(),
            b"X" * (t - 6) + b"\x00" * 5000 + b"Y", b"\x00" * (300 * t) + b"\x01",
            rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
            rng.integers(0, 3, 2 * t + 11, dtype=np.uint8).tobytes(), b""]
    streams = np.zeros((len(raws), 301 * t), np.uint8)
    for i, raw in enumerate(raws):
        streams[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    return raws, streams, np.array([len(r) for r in raws], np.int32)


def test_tokenize_matches_twin(cuda):
    _, streams, lengths = _streams()
    s, n = torch.from_numpy(streams).to(cuda), torch.from_numpy(lengths).to(cuda)
    _equal(hopper_deflate.tokenize(s, n), hopper_deflate.tokenize_plain(s, n))


def test_tokenize_compact_matches_twin(cuda):
    _, streams, lengths = _streams()
    s, n = torch.from_numpy(streams).to(cuda), torch.from_numpy(lengths).to(cuda)
    for bound in (streams.shape[1], 100):   # fits; overflows
        _equal(hopper_deflate.tokenize_compact(s, n, bound),
               hopper_deflate.tokenize_compact_plain(s, n, bound))


def _edge_streams(seed=18):
    """Streams at the tokenizer's edges, in rows of npad % 16 != 0 bytes: a
    run change exactly at a tile boundary and one at a tile's last byte,
    zero runs of 258 k + 1..6 bytes across a tile boundary (the take-255
    and take-4/5 cases), a stream ending at a tile boundary, lengths that
    are not multiples of 16, random bytes and an empty stream."""
    rng = np.random.default_rng(seed)
    t = hopper_deflate.TILE
    raws = [b"A" * t + b"B" * 100, b"A" * (t - 1) + b"B" + b"C" * 50, b"\x05" * (2 * t),
            rng.integers(0, 256, 7777, dtype=np.uint8).tobytes(), b""]
    raws += [b"X" * (t - 100) + b"\x00" * (258 * k + r) + b"Y" for k in (1, 2) for r in range(1, 7)]
    npad = max(map(len, raws)) + 13
    npad += (5 - npad) % 16
    streams = np.zeros((len(raws), npad), np.uint8)
    for i, raw in enumerate(raws):
        streams[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    return raws, streams, np.array([len(r) for r in raws], np.int32)


def test_tokenize_edges_match_twin(cuda):
    raws, streams, lengths = _edge_streams()
    assert streams.shape[1] % 16 == 5
    s, n = torch.from_numpy(streams).to(cuda), torch.from_numpy(lengths).to(cuda)
    before = hopper_deflate.TOKENIZE_LAUNCHES.value
    got = hopper_deflate.tokenize(s, n)
    assert hopper_deflate.TOKENIZE_LAUNCHES.value == before + 1
    _equal(got, hopper_deflate.tokenize_plain(s, n))
    exact = int(got[1][:, :286].sum(dim=1).max())
    for bound in (exact, exact - 1, exact // 2, streams.shape[1] + 3):
        before = hopper_deflate.TOKENIZE_COMPACT_LAUNCHES.value
        comp = hopper_deflate.tokenize_compact(s, n, bound)
        assert hopper_deflate.TOKENIZE_COMPACT_LAUNCHES.value == before + 1
        _equal(comp, hopper_deflate.tokenize_compact_plain(s, n, bound))
        assert bool(comp[4].any()) == (bound < exact)
    assert deflate_batch_device(s, lengths) == [native.deflate_sparse(r) for r in raws]


def test_assemble_matches_twin(cuda):
    _, streams, lengths = _streams()
    s, n = torch.from_numpy(streams).to(cuda), torch.from_numpy(lengths).to(cuda)
    tok, hist, _ = hopper_deflate.tokenize(s, n)
    tables = host_tables(hist.cpu().numpy())
    args = [torch.from_numpy(a).to(cuda) for a in (tables.luts, tables.phases, tables.partials)]
    comp = hopper_deflate.tokenize_compact(s, n, streams.shape[1])[0]
    for t in (tok, comp):
        for out_bound in (2 * streams.shape[1] + 256, 300):   # fits; overflows
            _equal(hopper_deflate.assemble(t, *args, out_bound),
                   hopper_deflate.assemble_plain(t, *args, out_bound))


ASSEMBLE_CASES = [what for what, *_ in assemble_battery(np.random.default_rng(0))]


@pytest.mark.parametrize("bound", ["exact", "one step under"])
@pytest.mark.parametrize("dtype", ["u16", "i32"])
@pytest.mark.parametrize("case", ASSEMBLE_CASES)
def test_assemble_edges_match_twin(cuda, case, dtype, bound):
    """Two kernels, one launch a call, on the edge battery: tiles of no
    tokens, a word holding bits of three tiles, phases 0..7 with their
    partial bytes, rows of 2 * TILE + 1234 tokens, 40 streams, one with no
    token; out_bound at ceil(total / 8) and one 128-byte step under it
    (overflow, the bytes past the bound dropped); zeros past each total.
    The split form gives the same bytes."""
    _, tok, lut, phase, partial = next(c for c in assemble_battery(np.random.default_rng(25))
                                       if c[0] == case)
    t = torch.from_numpy(tok).to(cuda)
    if dtype == "u16":
        t = _launch.i32_to_u16(t)
    args = [torch.from_numpy(a).to(cuda) for a in (lut, phase, partial)]
    total = hopper_deflate.assemble_plain(t, *args, 0)[1]
    exact = (int(total.max()) + 7) // 8
    out_bound = exact if bound == "exact" else -(-exact // 128) * 128 - 128
    before = hopper_deflate.ASSEMBLE_LAUNCHES.value
    got = hopper_deflate.assemble(t, *args, out_bound)
    assert hopper_deflate.ASSEMBLE_LAUNCHES.value == before + 1
    want = hopper_deflate.assemble_plain(t, *args, out_bound)
    _equal(got, want)
    assert torch.equal(got[1], total)
    assert bool(got[2].any()) == (bound != "exact")
    body = got[0].cpu().numpy()
    used = (total.cpu().numpy() + 7) // 8
    assert not any(body[b, used[b]:].any() for b in range(body.shape[0]))
    _equal(hopper_deflate.assemble_split(t, *args, out_bound), got)


def test_deflate_batch_matches_native(cuda):
    raws, streams, lengths = _streams()
    hint = {}
    for _ in range(2):      # two-pass tokenize, then the fused kernel on the hint
        out = deflate_batch_device(torch.from_numpy(streams).to(cuda), lengths, hint_state=hint)
        assert out == [native.deflate_sparse(r) for r in raws]


def test_card_slice_matches_host(cuda, tmp_path):
    """Writer -> merge -> reader on the card, with device entropy (the
    default there) and with host entropy, gives the host path's bytes."""
    rng = np.random.default_rng(15)
    data = np.where(rng.random((6, 128, 128)) < 0.05,
                    rng.integers(40, 4096, (6, 128, 128)), 0).astype(np.uint16)
    dark = rng.integers(0, 30, (128, 128)).astype(np.uint16)
    params = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=3,
        target_bit_depth=12, source_bit_depth=12, num_cols=128, num_rows=128, num_frames=6,
        frame_offset=0, num_calibration_frames=1, calibration_frame_offset=0,
        keep_part_files=0, num_threads=2, l2_statistics=0, l4_centroiding=0,
        compression_scheme=0, compression_level=1, source_file_type=0,
        source_header_length=0, keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0))
    assert params.validate()
    merged = {}
    for device, device_entropy in (("cpu", False), ("cuda", None), ("cuda", False)):
        out = tmp_path / f"{device}_{device_entropy}"
        out.mkdir()
        for node_id in range(2):
            w = port.ReCoDeWriter("s", dark_data=dark, output_directory=str(out),
                                  input_params=params, node_id=node_id, device=device,
                                  device_entropy=device_entropy)
            assert w._device_entropy is (device_entropy is None)   # on by default on the card
            w.start()
            w.run(data)
            w.close()
        merged[device, device_entropy] = port.merge_parts(str(out), "s.rc1", 2)
    assert filecmp.cmp(merged["cpu", False], merged["cuda", None], shallow=False)
    assert filecmp.cmp(merged["cpu", False], merged["cuda", False], shallow=False)
    reader = port.ReCoDeReader(merged["cuda", None], device="cuda")
    reader.open()
    thr = dark.astype(np.int64) + 3
    assert np.array_equal(reader.read_frames_dense(0, 6), np.where(data > thr, data - thr, 0))
    reader.close()


def _pinned_read_container(out, scheme):
    """(residuals, merged L1 container) written on the card: 3 frames of
    ~70000 foreground pixels at 1024^2, where the writer's rANS coders
    engage and the reader takes the device gap chain at scheme 12."""
    rng = np.random.default_rng(22)
    shape = (3, 1024, 1024)
    dark = rng.integers(0, 30, shape[1:]).astype(np.uint16)
    data = (dark + rng.integers(0, 4, shape)).astype(np.uint16)
    fg = rng.random(shape) < 0.067
    data[fg] = np.minimum(dark[None].repeat(shape[0], 0)[fg] + 4
                          + rng.exponential(6.0, int(fg.sum())).astype(np.int64), 4095)
    params = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=3,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[2], num_rows=shape[1],
        num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=1, l2_statistics=0,
        l4_centroiding=0, compression_scheme=scheme, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=0, target_data_type=0))
    assert params.validate()
    w = port.ReCoDeWriter("s", dark_data=dark, output_directory=str(out), input_params=params,
                          node_id=0, device="cuda", device_entropy=True)
    w.start()
    w.run(data)
    w.close()
    thr = dark.astype(np.int64) + 3
    return np.where(data > thr, data - thr, 0), port.merge_parts(str(out), "s.rc1", 1)


@pytest.mark.parametrize("scheme", [0, 12])
def test_read_frames_dense_copies_into_pinned_memory(cuda, tmp_path, monkeypatch, scheme):
    """Both return sites: the output is pinned and byte-equal to a pageable
    copy of the same decode; a call made while an output is alive does not
    alias it, nor does one made after an earlier output was dropped."""
    want, merged = _pinned_read_container(tmp_path, scheme)
    decoded = []
    for module, name in ((reader_mod, "decode_l1"), (rans, "gap_chain_dense")):
        monkeypatch.setattr(module, name, lambda *a, _f=getattr(module, name):
                            decoded.append(_f(*a)) or decoded[-1])
    reader = port.ReCoDeReader(merged, device="cuda")
    reader.open()
    port.reset_span_totals()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            first = reader.read_frames_dense(0, 3)
        totals = port.span_totals()
        assert totals["reader.d2h_pinned"][0] == totals["reader.d2h"][0] == 1
        assert ("reader.inflate" in totals) == (scheme == 0)   # which return site
        assert len(decoded) == 1
        assert torch.from_numpy(first).is_pinned()
        assert np.array_equal(first, decoded[0][0].cpu().numpy())
        assert np.array_equal(first, want)
        second = reader.read_frames_dense(0, 3)
        assert torch.from_numpy(second).is_pinned() and not np.shares_memory(first, second)
        del first
        gc.collect()
        third = reader.read_frames_dense(0, 3)
        assert torch.from_numpy(third).is_pinned() and not np.shares_memory(second, third)
        assert np.array_equal(second, want) and np.array_equal(third, want)
    finally:
        reader.close()
        port.reset_span_totals()


def test_read_frames_dense_falls_back_when_pinning_fails(cuda, tmp_path, monkeypatch):
    """A pinned allocation that raises sends that call down the pageable
    copy, with the same bytes and no ``reader.d2h_pinned`` span."""
    want, merged = _pinned_read_container(tmp_path, 0)
    empty = torch.empty

    def no_pinning(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory (pinning refused)")
        return empty(*args, **kwargs)

    reader = port.ReCoDeReader(merged, device="cuda")
    reader.open()
    port.reset_span_totals()
    try:
        pinned = reader.read_frames_dense(0, 3)
        monkeypatch.setattr(torch, "empty", no_pinning)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = reader.read_frames_dense(0, 3)
        monkeypatch.undo()
        totals = port.span_totals()
    finally:
        reader.close()
        port.reset_span_totals()
    assert totals["reader.d2h"][0] == 1 and "reader.d2h_pinned" not in totals
    assert torch.from_numpy(pinned).is_pinned() and not torch.from_numpy(got).is_pinned()
    assert np.array_equal(got, pinned) and np.array_equal(got, want)


@pytest.mark.parametrize("mode", sorted(hopper_label.MODES))
def test_label_l2l4_matches_twin(cuda, mode):
    """Puddle frames (out_size that fits, and one that overflows), a ragged
    geometry, and the edge battery on a zero threshold at 64x128, at the
    tile batteries' shapes (just over one tile, 2 x 3 tiles and a ragged
    edge, ragged in both) and on a 1 x 2^20 row, with puddle frames of the
    tile shapes; the CUDA path launches the kernel, not the twin."""
    rng = np.random.default_rng(31)
    frames, dark = make_puddle_frames(rng, 3, 96, 160, hits=40000 * 64)
    ragged, rdark = make_puddle_frames(rng, 2, 37, 29, hits=40000 * 64)
    edge = np.stack(list(label_edge_frames(rng, 64, 128).values()))
    cases = [(frames, dark + 2, 96 * 160), (frames, dark + 2, 20), (ragged, rdark + 2, 37 * 29),
             (edge, np.zeros((64, 128), np.uint16), 64 * 128)]
    for h, w in [*label_tile_shapes().values(), (1, 1 << 20)]:
        tiles = np.stack(list(label_edge_frames(rng, h, w).values()))
        cases.append((tiles, np.zeros((h, w), np.uint16), h * w))
    for h, w in label_tile_shapes().values():
        puddles, pdark = make_puddle_frames(rng, 2, h, w, hits=40000 * 64)
        cases.append((puddles, pdark + 2, h * w))
    for f, t, out_size in cases:
        f, t = torch.from_numpy(f).to(cuda), torch.from_numpy(t).to(cuda)
        before = hopper_label.LAUNCHES.value
        got = hopper_label.encode_l2l4(f, t, mode, out_size, 4095)
        assert hopper_label.LAUNCHES.value == before + 1
        want = hopper_label.encode_l2l4_plain(f, t, mode, out_size, 4095)
        assert hopper_label.LAUNCHES.value == before + 1
        _equal(got, want)
        assert bool(got[3].any()) == (out_size == 20)


def test_bitmap_positions_matches_twin(cuda):
    """n_bytes % 16 != 0 and below one tile, no and all bits set, out_size
    at the count, one below it and 0, one set bit at the last bit, a batch
    of 40 streams."""
    rng = np.random.default_rng(33)
    cases = [(3, 16384, 0.05), (3, 12345, 0.3), (3, 8192, 0.0), (3, 5001, 1.0), (3, 100, 0.2),
             (3, 65536 + 7, 0.01), (40, 30000, 0.02)]
    for batch, nb, density in cases:
        bits = (rng.random((batch, nb * 8)) < density).astype(np.uint8)
        if nb == 8192:
            bits[1, -1] = 1       # one set bit, at the last bit
        n_set = bits.sum(axis=1)
        bm = torch.from_numpy(np.packbits(bits, axis=1, bitorder="little")).to(cuda)
        for out_size in sorted({2 * nb, 1000, int(n_set.max()), max(int(n_set.max()) - 1, 0), 0}):
            before = hopper_gaps.LAUNCHES.value
            got = hopper_gaps.bitmap_positions(bm, out_size)
            assert hopper_gaps.LAUNCHES.value == before + 1
            _equal(got, hopper_gaps.bitmap_positions_plain(bm, out_size))
            assert got[2].tolist() == [int(n) > out_size for n in n_set]


def test_bitpack12_words_matches_twin(cuda):
    rng = np.random.default_rng(41)
    v = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 100008)).astype(np.int32)).to(cuda)
    before = hopper_bitpack.WORDS_LAUNCHES.value
    got = hopper_bitpack.bitpack12_words(v)
    assert hopper_bitpack.WORDS_LAUNCHES.value == before + 1
    _equal([got], [hopper_bitpack.bitpack12_words_plain(v)])
    small = v & 4095
    assert torch.equal(hopper_bitpack.bitpack12_words(small).view(torch.uint8),
                       hopper_bitpack.bitpack12(small))


@pytest.mark.parametrize("case", ENCODE_CASES)
@pytest.mark.parametrize("shape", ENCODE_SHAPES)
@pytest.mark.parametrize("with_values", [True, False])
def test_encode_l1_pairs_matches_twin(cuda, shape, with_values, case):
    n = shape[0] * shape[1]
    frames, thr, sizes = _encode_case(case, shape, 42, ())
    f, t = torch.from_numpy(frames).to(cuda), torch.from_numpy(thr).to(cuda)
    if case == "random":   # fits; pairs overflow; values overflow
        combos = ((n, n), (n, 50), (100, n))
    else:   # the values' sizes with room for the pairs; the pair counts' sizes alone
        pcounts = hopper_encode.encode_l1_plain(f, t, n, pairs_out=n)[5].tolist()
        psizes = {int(c) + d for c in pcounts for d in (-1, 0, 1)}
        combos = [(s, n) for s in sizes] + [(n, p) for p in sorted(psizes) if p > 0]
    for out_size, pairs_out in combos:
        before = hopper_encode.PAIRS_LAUNCHES.value
        got = hopper_encode.encode_l1(f, t, out_size, with_values, pairs_out=pairs_out)
        assert hopper_encode.PAIRS_LAUNCHES.value == before + 1
        _equal(got, hopper_encode.encode_l1_plain(f, t, out_size, with_values,
                                                  pairs_out=pairs_out))


def test_tokens_from_pairs_matches_twin(cuda):
    """Sparse rows, an empty row (the tail sentinel alone), a gap of more
    than 1549 bytes, a nonzero run of 4 (flagged), and a bound below the
    count (the counts and the histogram stay exact)."""
    rng = np.random.default_rng(43)
    n = 60000
    rows = (rng.integers(1, 256, (5, n)) * (rng.random((5, n)) < 0.02)).astype(np.uint8)
    rows[1] = 0
    rows[2, 100:40000] = 0
    rows[3, 500:504] = 9
    p, c = hopper_encode.bitmap_pairs(torch.from_numpy(rows).to(cuda), n)
    full = hopper_tokens.tokens_from_pairs_plain(p, c, n, 4 * n)[2]
    for bound in (int(full.max()), int(full.min()) // 2):
        before = hopper_tokens.LAUNCHES.value
        got = hopper_tokens.tokens_from_pairs(p, c, n, bound)
        assert hopper_tokens.LAUNCHES.value == before + 1
        _equal(got, hopper_tokens.tokens_from_pairs_plain(p, c, n, bound))
        assert got[3].tolist() == [False, False, False, True, False]


def test_tokens_from_pairs_edges_match_twin(cuda):
    """np % 4 != 0 with one row holding np pairs, pairs at byte 0 and byte
    n - 1 around a gap of more tokens than a block stages, a row of no
    pairs, and bounds at, below and above the exact counts."""
    rng = np.random.default_rng(44)
    n = 3_000_003
    rows = np.zeros((4, n), np.uint8)
    rows[0, 0] = rows[0, n - 1] = 7
    rows[2] = rng.integers(1, 256, n) * (rng.random(n) < 0.002)
    rows[3, rng.choice(n, 10001, replace=False)] = rng.integers(1, 256, 10001)
    p, c = hopper_encode.bitmap_pairs(torch.from_numpy(rows).to(cuda), 10001)
    assert p.shape[1] % 4 == 1 and c[0] == 2 and c[1] == 0 and c[3] == p.shape[1]
    full = hopper_tokens.tokens_from_pairs_plain(p, c, n, 1)[2]
    assert int(full[0]) > 8192
    for bound in (int(full.max()), int(full.max()) - 1, int(full.min()), 3 * int(full.max())):
        before = hopper_tokens.LAUNCHES.value
        got = hopper_tokens.tokens_from_pairs(p, c, n, bound)
        assert hopper_tokens.LAUNCHES.value == before + 1
        _equal(got, hopper_tokens.tokens_from_pairs_plain(p, c, n, bound))
        assert torch.equal(got[2], full)
        assert torch.equal(got[4], hopper_tokens.adler_from_pairs(p, c, n))


@pytest.mark.parametrize("case", ["tokenized streams", *ASSEMBLE_CASES])
def test_assemble_split_matches_twin(cuda, case):
    """One launch a call.  "tokenized streams": the tokenizer's u16 and
    compacted i32 tokens of _streams, the body at its bound and cut to 300
    bytes, against the twin and assemble, then deflate_batch_device(
    split_assemble=True) against native.deflate_sparse.  The edge battery's
    cases (tiles of no tokens between tiles with bits, a word of three tiles,
    phases 0..7 with partial bytes, odd ncols, streams of one token and of
    none), u16 and i32, at out_bound ceil(total / 8) and one 128-byte step
    under it: against the twin and assemble, and zeros past each total."""
    if case != "tokenized streams":
        _, tok, lut, phase, partial = next(
            c for c in assemble_battery(np.random.default_rng(26)) if c[0] == case)
        args = [torch.from_numpy(a).to(cuda) for a in (lut, phase, partial)]
        i32 = torch.from_numpy(tok).to(cuda)
        for t in (i32, _launch.i32_to_u16(i32)):
            total = hopper_deflate.assemble_plain(t, *args, 0)[1]
            exact = (int(total.max()) + 7) // 8
            for out_bound in (exact, -(-exact // 128) * 128 - 128):
                before = hopper_deflate.ASSEMBLE_SPLIT_LAUNCHES.value
                got = hopper_deflate.assemble_split(t, *args, out_bound)
                assert hopper_deflate.ASSEMBLE_SPLIT_LAUNCHES.value == before + 1
                _equal(got, hopper_deflate.assemble_plain(t, *args, out_bound))
                _equal(got, hopper_deflate.assemble(t, *args, out_bound))
                assert torch.equal(got[1], total)
                used = (total.cpu().numpy() + 7) // 8
                body = got[0].cpu().numpy()
                assert not any(body[b, used[b]:].any() for b in range(body.shape[0]))
        return
    _, streams, lengths = _streams()
    s, n = torch.from_numpy(streams).to(cuda), torch.from_numpy(lengths).to(cuda)
    tok, hist, _ = hopper_deflate.tokenize(s, n)
    tables = host_tables(hist.cpu().numpy())
    args = [torch.from_numpy(a).to(cuda) for a in (tables.luts, tables.phases, tables.partials)]
    comp = hopper_deflate.tokenize_compact(s, n, streams.shape[1])[0]
    for t in (tok, comp):
        for out_bound in (2 * streams.shape[1] + 256, 300):   # fits; overflows
            before = hopper_deflate.ASSEMBLE_SPLIT_LAUNCHES.value
            got = hopper_deflate.assemble_split(t, *args, out_bound)
            assert hopper_deflate.ASSEMBLE_SPLIT_LAUNCHES.value == before + 1
            _equal(got, hopper_deflate.assemble_plain(t, *args, out_bound))
            _equal(got, hopper_deflate.assemble(t, *args, out_bound))
    raws, _, _ = _streams()
    assert deflate_batch_device(s, lengths, split_assemble=True) == \
        [native.deflate_sparse(r) for r in raws]


@pytest.mark.parametrize("case", ENCODE_CASES)
@pytest.mark.parametrize("shape", ENCODE_SHAPES)
@pytest.mark.parametrize("phase", hopper_encode.PHASES)
def test_encode_l1_phases_match_twin(cuda, shape, phase, case):
    """Each cut-off of the encode against its twin; "full" also against
    encode_l1, and "bitmap" against encode_l1's bitmap."""
    n = shape[0] * shape[1]
    frames, thr, sizes = _encode_case(case, shape, 51, (n, 100))   # fits; overflows
    f, t = torch.from_numpy(frames).to(cuda), torch.from_numpy(thr).to(cuda)
    for out_size in sizes:
        before = hopper_encode.PHASES_LAUNCHES.value
        got = hopper_encode.encode_l1_phases(f, t, out_size, True, phase)
        assert hopper_encode.PHASES_LAUNCHES.value == before + 1
        _equal(got, hopper_encode.encode_l1_phases_plain(f, t, out_size, True, phase))
        full = hopper_encode.encode_l1(f, t, out_size)
        if phase == "full":
            _equal(got, full)
        elif phase != "load":
            _equal(got[:1], full[:1])


@pytest.mark.parametrize("case", ["30%", "edges"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("phase", hopper_decode.PHASES)
def test_decode_l1_phases_match_twin(cuda, shape, phase, case):
    bitmap_np, values_list = decode_battery(np.random.default_rng(52), shape, case)
    bitmap = torch.from_numpy(bitmap_np).to(cuda)
    for values_np in values_list:
        values = torch.from_numpy(values_np).to(cuda)
        before = hopper_decode.PHASES_LAUNCHES.value
        got = hopper_decode.decode_l1_phases(bitmap, values, *shape, stop_after=phase)
        assert hopper_decode.PHASES_LAUNCHES.value == before + 1
        _equal(got, hopper_decode.decode_l1_phases_plain(bitmap, values, *shape, phase))
        if phase == "full":
            _equal(got, hopper_decode.decode_l1(bitmap, values, *shape))


BUTTERFLY_SUBS = [32, 64, 128, 256, 512, 1024, 2048]


def _butterfly_cases(cuda, sub):
    """(mask, vals on the card, the stable compaction in numpy) for 1, 5, 8
    and 13 rows at densities 0, 0.1, 0.6 and 1.0."""
    rng = np.random.default_rng(53)
    for rows in (1, 5, 8, 13):
        for dens in (0.0, 0.1, 0.6, 1.0):
            m = (rng.random((rows, sub)) < dens).astype(np.int32)
            v = rng.integers(1, 513, (rows, sub)).astype(np.int32) * m
            want = np.zeros_like(v)
            for r in range(rows):
                fg = v[r][m[r] > 0]
                want[r, :fg.size] = fg
            yield torch.from_numpy(m).to(cuda), torch.from_numpy(v).to(cuda), want


@pytest.mark.parametrize("sub", BUTTERFLY_SUBS)
@pytest.mark.parametrize("variant", hopper_probes.BUTTERFLY_VARIANTS)
def test_probe_butterfly_matches_twin(cuda, sub, variant):
    for mt, vt, want in _butterfly_cases(cuda, sub):
        before = hopper_probes.BUTTERFLY_LAUNCHES.value
        got = hopper_probes.butterfly(mt, vt, variant)
        assert hopper_probes.BUTTERFLY_LAUNCHES.value == before + 1
        _equal([got], [hopper_probes.butterfly_plain(mt, vt, variant)])
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("sub", BUTTERFLY_SUBS)
def test_probe_butterfly_all_matches_twins(cuda, sub):
    """The four formulations in one launch: each output equals its twin and
    numpy's stable compaction, and all four are views of one allocation."""
    for mt, vt, want in _butterfly_cases(cuda, sub):
        before = hopper_probes.BUTTERFLY_LAUNCHES.value
        got = hopper_probes.butterfly_all(mt, vt)
        assert hopper_probes.BUTTERFLY_LAUNCHES.value == before + 1
        assert list(got) == list(hopper_probes.BUTTERFLY_VARIANTS)
        assert len({t.untyped_storage().data_ptr() for t in got.values()}) == 1
        twins = hopper_probes.butterfly_all_plain(mt, vt)
        for name, out in got.items():
            _equal([out], [twins[name]])
            assert np.array_equal(out.cpu().numpy(), want)


# (m, k, n): the probe's; n = 136 = 8 mod 16 (the last 16-column strip's
# second n8 tile masked) at k = 24 (not a multiple of the 32-deep chunk);
# m = 16 (one m16 tile a block); k = 40 and 64 (two chunks, the second
# ragged or whole); m = 80 (a second row of blocks)
F32DOT_SHAPES = [(48, 32, 2048), (32, 24, 136), (16, 32, 200), (48, 40, 2048), (64, 64, 264),
                 (80, 64, 136)]


@pytest.mark.parametrize("shape", F32DOT_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", hopper_probes.F32DOT_MODES)
def test_probe_f32dot_matches_twin(cuda, mode, shape):
    """Bit for bit against the twin on one-hot products of 21-bit integers;
    exact but for one TF32 pass, which rounds to 11 significant bits."""
    lut, oh, want = probe_f32dot.make_inputs(*shape, seed=54)
    a, b = torch.from_numpy(lut).to(cuda), torch.from_numpy(oh).to(cuda)
    before = hopper_probes.F32DOT_LAUNCHES.value
    got = hopper_probes.f32dot(a, b, mode)
    assert hopper_probes.F32DOT_LAUNCHES.value == before + 1
    _equal([got.view(torch.int32)], [hopper_probes.f32dot_plain(a, b, mode).view(torch.int32)])
    err = np.abs(got.cpu().numpy() - want).max()
    assert (err == 0) if mode != "tf32" else (0 < err <= 512)
    # operands that start off a 16-byte boundary take the kernel's 4-byte loads
    a_off, b_off = (torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape)
                    for t in (a, b))
    a_off.copy_(a)
    b_off.copy_(b)
    _equal([hopper_probes.f32dot(a_off, b_off, mode)], [got])


@pytest.mark.parametrize("shape", [(1, 1, 1), (37, 29, 101), (70, 3, 17), (5, 36, 6)],
                         ids=lambda s: "x".join(map(str, s)))
def test_probe_f32dot_fp32_takes_any_shape(cuda, shape):
    """fp32 on shapes the mma modes refuse: k % 4 != 0 (4-byte copies), n %
    4 != 0 (element stores), m not a multiple of 16; and an operand that
    starts off a 16-byte boundary."""
    lut, oh, want = probe_f32dot.make_inputs(*shape, seed=55)
    a, b = torch.from_numpy(lut).to(cuda), torch.from_numpy(oh).to(cuda)
    got = hopper_probes.f32dot(a, b, "fp32")
    _equal([got.view(torch.int32)], [hopper_probes.f32dot_plain(a, b, "fp32").view(torch.int32)])
    assert np.array_equal(got.cpu().numpy(), want)
    off = torch.empty(a.numel() + 1, dtype=torch.float32, device=cuda)[1:].view(a.shape)
    off.copy_(a)
    assert np.array_equal(hopper_probes.f32dot(off, b, "fp32").cpu().numpy(), want)


def _mosaic_inputs(cuda, random: bool) -> dict:
    """The probe's inputs, or seeded random ones: small integers as floats for
    (a) (exact in any order of the sums), negative values for (c), a
    negative shift for (f), sums past 2**31 for (g), any bits for (h)."""
    from pyrecode_tpu_torch.tools.probe_mosaic import cases

    ins = {k: list(v) for k, (v, _) in cases().items()}
    if random:
        rng = np.random.default_rng(56)
        big = np.iinfo(np.int32)
        ins["a"] = [rng.integers(-8, 9, s).astype(np.float32) for s in ((8, 128), (32, 128))]
        ins["b"] = [rng.standard_normal((32, 128)).astype(np.float32)]
        for k in "cdeg":
            ins[k] = [rng.integers(big.min, big.max, ins[k][0].shape, dtype=np.int32)]
        ins["f"] = [rng.integers(big.min, big.max, (32, 128), dtype=np.int32),
                    np.array([-37], np.int32)]
        ins["h"] = [rng.integers(big.min, big.max, (8, 128), dtype=np.int32) for _ in range(2)]
    return {k: [torch.from_numpy(x).to(cuda) for x in v] for k, v in ins.items()}


@pytest.mark.parametrize("random", [False, True], ids=["probe_inputs", "random"])
@pytest.mark.parametrize("probe", sorted(hopper_probes.MOSAIC_PROBES))
def test_probe_mosaic_matches_twin(cuda, probe, random):
    from pyrecode_tpu_torch.tools.probe_mosaic import cases

    ts = _mosaic_inputs(cuda, random)[probe]
    before = hopper_probes.MOSAIC_LAUNCHES.value
    got = hopper_probes.mosaic(probe, *ts)
    assert hopper_probes.MOSAIC_LAUNCHES.value == before + 1
    _equal(got, hopper_probes.mosaic_plain(probe, *ts))
    if not random:
        for g, w in zip(got, cases()[probe][1]):
            assert np.array_equal(g.cpu().numpy(), w)


@pytest.mark.parametrize("random", [False, True], ids=["probe_inputs", "random"])
def test_probe_mosaic_all_matches_twins(cuda, random):
    """The eight in one launch: each probe's outputs equal its twin's (and
    numpy's on the probe's inputs); MOSAIC_LAUNCHES rises by one a call."""
    from pyrecode_tpu_torch.tools.probe_mosaic import cases

    inputs = _mosaic_inputs(cuda, random)
    for _ in range(2):
        before = hopper_probes.MOSAIC_LAUNCHES.value
        got = hopper_probes.mosaic_all(inputs)
        assert hopper_probes.MOSAIC_LAUNCHES.value == before + 1
        want = hopper_probes.mosaic_all_plain(inputs)
        assert sorted(got) == sorted(hopper_probes.MOSAIC_PROBES)
        for probe, outs in got.items():
            assert all(o.data_ptr() % 16 == 0 for o in outs)
            _equal(outs, want[probe])
            if not random:
                for g, w in zip(outs, cases()[probe][1]):
                    assert np.array_equal(g.cpu().numpy(), w)
