"""The port's byte-mode scheme-12 device coder on the CPU.

The token rANS encode's twin (#9t, ``hopper_rans.rans_encode_tokens``)
against the JAX ``rans_encode_pallas`` in interpret mode and the numpy
``rans_encode_interleaved``, and the port's ``rans_batch_device`` against
the JAX one (interpret mode), ``compress(raw, nways=1024)``, ``decompress``
and ``rans_decompress_device_batch``.  Every comparison is exact bytes.
"""

import numpy as np
import pytest
import torch

from pyrecode_tpu.codecs import dyndeflate as jdd
from pyrecode_tpu.codecs import rans as jrans
from pyrecode_tpu.ops import pallas_rans as prk
from pyrecode_tpu_torch import native
from pyrecode_tpu_torch.codecs import rans as trans
from pyrecode_tpu_torch.ops import hopper_deflate as hd
from pyrecode_tpu_torch.ops import hopper_rans as hr


def _byte_streams(seed, npad, specs):
    """(raws, streams (B, npad) uint8, lengths) of sparse random bytes:
    ``specs`` is a list of (length, density)."""
    rng = np.random.default_rng(seed)
    raws, streams = [], np.zeros((len(specs), npad), np.uint8)
    for i, (n, density) in enumerate(specs):
        raw = (rng.integers(0, 256, n) * (rng.random(n) < density)).astype(np.uint8)
        streams[i, :n] = raw
        raws.append(raw.tobytes())
    return raws, streams, np.array([len(r) for r in raws], np.int32)


def _token_inputs(streams, lengths):
    """Dense inverted tokens (B, NPAD) int32 from the port's tokenizer and
    compaction, their counts, and each stream's quantized tables."""
    tok, hist, _ = hd.tokenize(torch.from_numpy(streams), torch.from_numpy(lengths))
    hist = hist.numpy()[:, :286].astype(np.int64)
    m = hist.sum(axis=1).astype(np.int32)
    dense = hd.compact_tokens(tok, streams.shape[1])[0]
    freq = np.zeros((len(m), 4096), np.int32)
    for b, h in enumerate(hist):
        freq[b, :286] = jrans.quantize_freqs(h)
    cum = np.zeros_like(freq)
    cum[:, 1:] = np.cumsum(freq, axis=1)[:, :-1]
    return dense.numpy(), m, freq, cum


@pytest.fixture(scope="module")
def token_streams():
    """Four streams at NPAD 8192: sparse, short (m not a multiple of 1024),
    literal-dense, and one byte (a one-symbol alphabet)."""
    npad = prk.CH_R
    raws, streams, lengths = _byte_streams(31, npad, [(npad - 5, 0.05), (3000, 0.3),
                                                      (npad, 0.9), (0, 0.0)])
    streams[3, 0] = 5
    lengths[3] = 1
    raws[3] = b"\x05"
    return raws, _token_inputs(streams, lengths)


def test_token_encode_matches_pallas_and_numpy(token_streams):
    """The twin against rans_encode_pallas (interpret) and the numpy coder,
    exactly; at a one-symbol alphabet (f = 4096) the Pallas kernel's int32
    threshold f << 19 wraps negative and it emits two bytes a token where
    the numpy contract emits none: the port keeps the contract."""
    raws, (dense, m, freq, cum) = token_streams
    npad = dense.shape[1]
    body, states, counts = (t.numpy() for t in hr.rans_encode_tokens(
        *(torch.from_numpy(a) for a in (dense, freq, cum, m)), 2 * npad + 16))
    eluts = np.stack([prk.encode_luts_radix(f[:286]) for f in freq])
    jbody, jstates, jcounts = (np.asarray(a) for a in prk.rans_encode_pallas(
        dense, eluts, m, 2 * npad + 4096, interpret=True))
    for b, raw in enumerate(raws):
        lut_idx, _ = jdd.tokenize_bytes_np(np.frombuffer(raw, np.uint8))
        syms, _, _ = jrans._token_syms_and_extras(lut_idx)
        assert syms.size == m[b]
        ref_body, ref_states = jrans.rans_encode_interleaved(syms, freq[b, :286], 1024)
        assert body[b, :counts[b]].tobytes() == ref_body, b
        assert np.array_equal(states[b].astype(np.uint32), ref_states), b
        if b == 3:      # the recorded difference of the reference
            assert freq[b, 5] == 4096 and counts[b] == 0 and jcounts[b] == 2 * m[b]
            continue
        assert counts[b] == jcounts[b]
        assert np.array_equal(body[b, :counts[b]], jbody[b, :counts[b]].astype(np.uint8)), b
        assert np.array_equal(states[b], jstates[b]), b


def test_token_encode_uint16_pad_and_cut():
    """uint16 and int32 tokens code alike; a pad (0) or out-of-range token
    among the counted ones codes as frequency 1, cum 0 (the TPU LUT's pad
    entry); a body bound that cuts keeps the first bytes and the count."""
    rng = np.random.default_rng(32)
    n = 2 * 1024 + 3
    idx = np.where(np.arange(n) % 3, rng.integers(0, 512, n), rng.integers(0, 256, n))
    tok = (hr.NO_TOKEN - idx).astype(np.int32)
    tok[::11] = 0
    tok[5::13] = 700
    freq = np.zeros((1, 4096), np.int32)
    freq[0, :286] = jrans.quantize_freqs(np.bincount(np.asarray(hr.TOKEN_SYMBOL)[idx],
                                                     minlength=286))
    cum = np.zeros_like(freq)
    cum[:, 1:] = np.cumsum(freq, axis=1)[:, :-1]
    t32 = torch.from_numpy(tok[None])
    t16 = t32.to(torch.int16).view(torch.uint16)
    args = (torch.from_numpy(freq), torch.from_numpy(cum), torch.tensor([n], dtype=torch.int32))
    full = hr.rans_encode_tokens(t32, *args, 2 * n + 16)
    for got in (hr.rans_encode_tokens(t16, *args, 2 * n + 16),
                hr.rans_encode_tokens_plain(t32, *args, 2 * n + 16)):
        assert all(torch.equal(a, b) for a, b in zip(got, full))
    cut = hr.rans_encode_tokens(t32, *args, 100)
    assert int(cut[2][0]) == int(full[2][0]) > 100
    assert torch.equal(cut[0][0], full[0][0, :100]) and torch.equal(cut[1], full[1])
    with pytest.raises(TypeError):
        hr.rans_encode_tokens(t32.to(torch.int64), *args, 10)


def test_extra_bits_lut_matches_the_radix_rows():
    """Rows 0..23 values and 24..47 bit counts: rows 72..95 and 48..71 of
    the TPU's encode_luts_radix, which do not depend on the frequencies."""
    radix = prk.encode_luts_radix(np.ones(286, np.int64))
    assert np.array_equal(trans.extra_bits_lut(), np.concatenate([radix[72:96], radix[48:72]]))


def test_batch_matches_jax():
    """Densities 0.02 / 0.3 / 0.9 as tests/test_rans.py, NPAD 16384: every
    stream equals the JAX rans_batch_device (interpret), equals
    compress(raw, nways=1024) where it has at least 1024 tokens, and reads
    back through decompress and rans_decompress_device_batch."""
    npad = 16384
    raws, streams, lengths = _byte_streams(33, npad, [(npad - 9 - 100 * i, d)
                                                      for i, d in enumerate((0.02, 0.3, 0.9))])
    got = trans.rans_batch_device(torch.from_numpy(streams), lengths)
    want = jrans.rans_batch_device(streams, lengths, interpret=True)
    assert got == want
    tokens = [jrans._token_syms_and_extras(jdd.tokenize_bytes_np(np.frombuffer(r, np.uint8))[0])
              [0].size for r in raws]
    assert tokens[1] >= 1024 and got[2][3] & 1       # a coded stream; a stored one
    for raw, stream, m in zip(raws, got, tokens):
        if m >= 1024 or stream[3] & 1:
            assert stream == trans.compress(raw, nways=1024) == native.rans_compress(raw, 1024)
        assert trans.decompress(stream) == raw
    assert trans.rans_decompress_device_batch(got, torch.device("cpu")) == raws


def test_batch_short_and_empty_streams_decode():
    """Below 1024 tokens the host coder narrows its lanes while the device
    coder keeps 1024: another valid stream, read back by both decoders; an
    empty stream and a raw_cb for the stored fallback."""
    raws, streams, lengths = _byte_streams(34, 60000, [(60000, 0.003), (0, 0.0), (3000, 1.0)])
    got = trans.rans_batch_device(torch.from_numpy(streams), lengths, raw_cb=lambda i: raws[i])
    h = trans._parse_header(got[0])
    assert h["nways"] == 1024 and h["m"] < 1024
    assert got[1] == trans.compress(b"") and got[2] == trans.compress(raws[2], nways=1024)
    assert [trans.decompress(s) for s in got] == raws
    assert trans.rans_decompress_device_batch(got, torch.device("cpu")) == raws
