"""Scheme 12: interleaved range-ANS entropy codec, host and device halves.

The port's own copy of the numpy half of pyrecode_tpu/codecs/rans.py (the
host coders, header build and parse, frequency quantization, the gap
transform, ``decompress``), and the port of its device half on torch
tensors: the symbol- and gap-mode batch encoders, the batch decoders and
the dense read chains, through the port's kernels (``ops/hopper_rans.py``,
``ops/hopper_gaps.py``, ``ops/hopper_decode.py``, ``ops/hopper_encode.py``),
and the byte-mode batch encoder (``ops/hopper_deflate.py`` for its tokens
and extra bits).  Every stream the
device half writes is byte-identical to the JAX package's device coder on
the same input: the same fixed lane counts (1024, or 8192 when every
device-coded stream of a call has at least 2^21 symbols), the host coder
for streams of fewer than 65536 symbols, and the same stored-block rule.

rANS is symmetric: W interleaved states advance in lockstep, so both
encode and decode run lane-parallel on the device.

Format (little-endian), scheme code 12 — a pyrecode-tpu extension; the
reference's scheme table stops at 11 (recode_compressors.py:103-118) and its
reader rejects unknown codes, exactly as it does for any codec library it
lacks:

    u8   magic   0xA5
    u8   version 1
    u8   log2_nways         (W = 1 << log2_nways interleaved states)
    u8   flags              bit0: stored (raw bytes follow, no coding)
                            bit1: SYMBOL mode — the payload is a bit-packed
                            stream of sym_bits-wide values coded directly
                            as symbols (no LZ layer, no extra bits); the
                            header then carries [u8 sym_bits, u8 pad,
                            u16 n_used, n_used x u16 symbol ids,
                            n_used x u16 freqs] instead of the byte-mode
                            used-bitmap + freq table
                            bit2 (with bit1): GAP transform — the decoded
                            symbols are not the payload itself but the runs
                            of clear bits of an LSB-first BITMAP of n_bytes
                            bytes: symbol s < 4095 advances the cursor by s
                            and sets one bit; s == 4095 advances 4095 and
                            sets nothing (escape).  Same size as byte-mode
                            coding of the bitmap (the entropy is identical)
                            but ~1/occupancy fewer symbols through the
                            serial rANS chain — 12.5x at the 1% operating
                            point, which is pure throughput on both encode
                            and decode.  sym_bits is always 12.
    u32  n_bytes            original length
    u32  n_tokens           LZ token count m
    u32  body_bytes         rANS byte-stream length
    u32  xbits_bytes        extra-bits stream length
    u8   used[36]           bitmap of used symbols (LSB-first)
    u16  freq[n_used]       12-bit quantized frequencies of used symbols
    u32  state[W]           final encoder states (decoder initial states)
    body                    rANS bytes in EMIT order (the encoder appends
                            forward; the decoder reads from the END
                            backward) — lets the device encoder use the
                            same forward window-append as every other
                            kernel here
    xbits                   bit-packed extra bits, LSB-first, token order
    u32  adler32            of the original bytes (big-endian, zlib-style)

LZ layer: the SAME per-byte run tokenizer as the deflate path
(codecs/dyndeflate.tokenize_bytes_np) — symbols 0..255
literals, 256..284 length codes with 0..5 extra bits, all matches at
distance 1, so no distance field is coded at all (deflate spends >=1 bit on
it).  Token i belongs to interleave lane i % W; the encoder walks tokens
last-to-first emitting renormalization bytes backward (descending lane order
within a step), the decoder walks first-to-last consuming them forward —
the classic interleaved rANS construction (Duda 2013; Giesen's ryg_rans).

rANS parameters: M = 4096 (12-bit quantization), byte renormalization,
state in [2^23, 2^31).
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np
import torch

from ..ops import hopper_decode, hopper_deflate, hopper_gaps, hopper_rans
from ..ops.bitpack import bitunpack_values_device, packed_group_shape
from ..profiling import annotate
from .dyndeflate import LEN_BASE, LEN_EXTRA, NO_TOKEN, tokenize_bytes_np

MAGIC = 0xA5
VERSION = 1
SCHEME_CODE = 12
PROB_BITS = 12
M = 1 << PROB_BITS
RANS_L = 1 << 23              # state lower bound
NWAYS_DEFAULT = 512
N_SYM = 286                   # 0..255 literals, 256 unused (EOB slot kept
#                               for table parity with deflate), 257..284 len
GAP_BITS = 12                 # gap-mode symbol width (alphabet 4096)
GAP_ESCAPE = (1 << GAP_BITS) - 1   # 4095: advance 4095 positions, no bit

_HDR_FIXED = 4 + 4 * 4        # magic..xbits_bytes


def quantize_freqs(counts: np.ndarray, total: int = M) -> np.ndarray:
    """Quantize symbol counts to sum exactly ``total``, every used symbol
    >= 1 (deterministic: largest-remainder with stable ordering, then steal
    from the largest entries).

    Operates on the nonzero support only — with 4096-bin gap alphabets the
    full-size lexsort cost 0.15 ms per call and this runs twice per frame
    in the device scheme-12 host stage.  Identical output to the full-size
    formulation (zero-count symbols keep q=0 and sorted after all nonzero
    remainders, exactly as the old ``rema[counts == 0] = -1`` ordering)."""
    counts = np.asarray(counts, dtype=np.int64)
    n = counts.sum()
    if n == 0:
        q = np.zeros(counts.size, np.int64)
        q[0] = total
        return q.astype(np.uint16)
    sup = np.flatnonzero(counts)
    cs = counts[sup]
    ideal = cs * total / n
    qs = np.floor(ideal).astype(np.int64)
    qs[qs == 0] = 1
    diff = total - qs.sum()
    if diff > 0:
        rema = ideal - np.floor(ideal)
        order = np.lexsort((np.arange(sup.size), -rema))
        qs[order[:diff]] += 1
    elif diff < 0:
        for _ in range(-diff):
            cand = np.where(qs > 1, qs, -1)
            qs[int(cand.argmax())] -= 1
    q = np.zeros(counts.size, np.int64)
    q[sup] = qs
    assert q.sum() == total and (qs >= 1).all()
    return q.astype(np.uint16)


def _token_syms_and_extras(lut_idx: np.ndarray):
    """Token stream -> (symbols, extra_values, extra_bit_counts)."""
    tok = lut_idx[lut_idx != NO_TOKEN]
    is_lit = tok < 256
    take = np.where(is_lit, 0, tok - 256 + 3)
    c = (np.searchsorted(LEN_BASE, take, side="right") - 1).astype(np.int64)
    syms = np.where(is_lit, tok, 257 + c)
    eb = np.where(is_lit, 0, LEN_EXTRA[np.clip(c, 0, 28)])
    ev = np.where(is_lit, 0, take - LEN_BASE[np.clip(c, 0, 28)])
    return syms.astype(np.int64), ev.astype(np.int64), eb.astype(np.int64)


def _pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """LSB-first variable-width bit packing (token order)."""
    total = int(nbits.sum())
    if total == 0:
        return b""
    out = np.zeros((total + 7) // 8, np.uint8)
    offs = np.concatenate([[0], np.cumsum(nbits)[:-1]]) if nbits.size else \
        np.zeros(0, np.int64)
    sv = values.astype(np.uint64) << (offs % 8).astype(np.uint64)
    tgt = offs // 8
    for k in range(3):
        contrib = ((sv >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8)
        t = np.minimum(tgt + k, max(out.size - 1, 0))
        np.add.at(out, t, contrib)
    return out.tobytes()


def _unpack_bits(blob: bytes, nbits: np.ndarray) -> np.ndarray:
    data = np.frombuffer(blob, np.uint8)
    out = np.zeros(nbits.size, np.int64)
    if data.size == 0:
        return out
    offs = np.concatenate([[0], np.cumsum(nbits)[:-1]]) if nbits.size else \
        np.zeros(0, np.int64)
    for k in range(3):
        idx = np.minimum(offs // 8 + k, max(data.size - 1, 0))
        out |= data[idx].astype(np.int64) << (8 * k)
    out >>= offs % 8
    return out & ((1 << nbits) - 1)


def rans_encode_interleaved(syms: np.ndarray, freq: np.ndarray,
                            nways: int) -> Tuple[bytes, np.ndarray]:
    """Interleaved rANS encode (numpy reference).

    Token i belongs to lane i % nways.  Tokens are processed last-to-first;
    within one position, renormalization bytes are emitted in DESCENDING
    lane order.  Returns (body bytes in EMIT order — the decoder walks them
    backward — and final states u32[nways] = the decoder's initial states).
    """
    freq = np.asarray(freq, np.int64)
    cum = np.zeros(freq.size + 1, np.int64)
    cum[1:] = np.cumsum(freq)
    m = syms.size
    x = np.full(nways, RANS_L, np.int64)
    chunks: List[bytes] = []
    # process whole interleave rows from the last; lanes within a row step
    # together (vectorized over lanes, like the device kernel); bytes within
    # a row in descending lane order, low byte first per lane.  Each lane
    # emits at most 2 bytes per symbol (x < 2^31, threshold f << 19).
    x_max_mul = (RANS_L >> PROB_BITS) << 8   # per unit freq
    start = (m - 1) - ((m - 1) % nways) if m else 0
    rev = np.arange(nways - 1, -1, -1)
    for row in range(start, -1, -nways):
        w = min(nways, m - row)
        s = syms[row: row + w]
        f = freq[s]
        c = cum[s]
        xr = x[:w]
        xm = x_max_mul * f
        e0 = xr >= xm
        b0 = xr & 0xFF
        x1 = np.where(e0, xr >> 8, xr)
        e1 = e0 & (x1 >= xm)
        b1 = x1 & 0xFF
        x2 = np.where(e1, x1 >> 8, x1)
        if e0.any():
            # (lane desc, low byte first): interleave per-lane (b0, b1)
            pairs = np.empty((w, 2), np.uint8)
            pairs[:, 0] = b0
            pairs[:, 1] = b1
            keep = np.empty((w, 2), bool)
            keep[:, 0] = e0
            keep[:, 1] = e1
            r = rev[nways - w:] if w != nways else rev
            chunks.append(pairs[r][keep[r]].tobytes())
        x[:w] = ((x2 // f) << PROB_BITS) + (x2 % f) + c
    return b"".join(chunks), x.astype(np.uint32)


def rans_decode_interleaved(body: bytes, states: np.ndarray, m: int,
                            freq: np.ndarray, nways: int) -> np.ndarray:
    """Inverse of :func:`rans_encode_interleaved` -> symbols i64[m]."""
    freq = np.asarray(freq, np.int64)
    cum = np.zeros(freq.size + 1, np.int64)
    cum[1:] = np.cumsum(freq)
    slot2sym = np.repeat(np.arange(freq.size), freq).astype(np.int64)
    # body is in emit order: reverse once, then read forward (vectorized
    # over lanes per row, the same structure as the device kernel; each
    # lane consumes 0..2 bytes per symbol, decidable from the state alone)
    drev = np.frombuffer(body, np.uint8)[::-1].astype(np.int64)
    x = np.asarray(states, np.int64).copy()
    c = 0
    out = np.zeros(m, np.int64)
    for row in range(0, m, nways):
        w = min(nways, m - row)
        xr = x[:w]
        slot = xr & (M - 1)
        s = slot2sym[slot]
        out[row: row + w] = s
        xp = freq[s] * (xr >> PROB_BITS) + slot - cum[s]
        nb = (xp < RANS_L).astype(np.int64) + (xp < (RANS_L >> 8))
        total = int(nb.sum())
        if c + total > drev.size:
            raise ValueError("TPU-rANS stream corrupt (body underflow)")
        pos = c + np.cumsum(nb) - nb
        safe1 = np.minimum(pos, drev.size - 1) if drev.size else pos * 0
        safe2 = np.minimum(pos + 1, drev.size - 1) if drev.size else pos * 0
        b1 = drev[safe1] if drev.size else np.zeros(w, np.int64)
        b2 = drev[safe2] if drev.size else np.zeros(w, np.int64)
        x1 = np.where(nb >= 1, (xp << 8) | b1, xp)
        x2 = np.where(nb == 2, (x1 << 8) | b2, x1)
        x[:w] = x2
        c += total
    return out


def _syms_to_tokens(syms: np.ndarray, extras: np.ndarray) -> np.ndarray:
    """(symbol, extra value) -> byte-stream reconstruction tokens
    (value, run_take): literals (v, 1); matches (copy-prev, take)."""
    is_lit = syms < 256
    c = np.where(is_lit, 0, syms - 257)
    take = np.where(is_lit, 1, LEN_BASE[np.clip(c, 0, 28)] + extras)
    return take.astype(np.int64)


def _finish_stream(n, m, nways, freq, states, body, xbits, adler) -> bytes:
    """Assemble a coded scheme-12 stream from its parts (shared by the
    numpy and device encoders)."""
    hdr = bytearray()
    hdr += bytes([MAGIC, VERSION, int(np.log2(nways)), 0])
    hdr += int(n).to_bytes(4, "little")
    hdr += int(m).to_bytes(4, "little")
    hdr += len(body).to_bytes(4, "little")
    hdr += len(xbits).to_bytes(4, "little")
    freq = np.asarray(freq)
    used = freq > 0
    hdr += np.packbits(used, bitorder="little").tobytes()
    hdr += freq[used].astype("<u2").tobytes()
    hdr += np.asarray(states).astype("<u4").tobytes()
    return bytes(hdr) + body + xbits + int(adler).to_bytes(4, "big")


def _finish_stream_symbols(n, m, nways, sym_bits, freq_sparse_syms,
                           freq_sparse_vals, states, body, adler,
                           gap: bool = False) -> bytes:
    """Assemble a SYMBOL-MODE (flags bit1) scheme-12 stream.

    Symbol mode codes the pixel-value stream directly over ``sym_bits``-wide
    symbols instead of bytes of the packed stream — real detector residuals
    are peaked near zero (Datta et al. 2021), and byte-granular models lose
    ~1 bit/value to the 12-bit pack phase misalignment; direct symbols
    recover it (measured: ideal 12-bit model is 25-80% smaller than
    byte-deflate on exponential residuals).  The frequency table is sparse
    (u16 symbol ids + u16 freqs), since peaked data uses few of the 2^b
    symbols."""
    hdr = bytearray()
    hdr += bytes([MAGIC, VERSION, int(np.log2(nways)), 6 if gap else 2])
    hdr += int(n).to_bytes(4, "little")
    hdr += int(m).to_bytes(4, "little")
    hdr += len(body).to_bytes(4, "little")
    hdr += (0).to_bytes(4, "little")          # no extra-bits stream
    hdr += bytes([int(sym_bits), 0])
    hdr += int(len(freq_sparse_syms)).to_bytes(2, "little")
    hdr += np.asarray(freq_sparse_syms).astype("<u2").tobytes()
    hdr += np.asarray(freq_sparse_vals).astype("<u2").tobytes()
    hdr += np.asarray(states).astype("<u4").tobytes()
    return bytes(hdr) + body + int(adler).to_bytes(4, "big")


def _stored_stream(raw: bytes, adler: int) -> bytes:
    """Stored-block fallback stream (flags bit0): header + raw + adler."""
    n = len(raw)
    hdr = bytes([MAGIC, VERSION, 0, 1]) + n.to_bytes(4, "little") \
        + (0).to_bytes(4, "little") + n.to_bytes(4, "little") \
        + (0).to_bytes(4, "little")
    return hdr + raw + int(adler).to_bytes(4, "big")


# a stored stream is n + _STORED_OVERHEAD bytes; the coded stream wins only
# if strictly smaller
_STORED_OVERHEAD = _HDR_FIXED + 4


def _parse_header(stream: bytes) -> dict:
    """Validated parse of a scheme-12 stream into its fields.

    Every length is checked against the buffer before use and the frequency
    table must sum to exactly M — corrupt or truncated input raises
    ValueError instead of reading out of bounds (the native C++ decoder
    applies the same checks)."""
    if len(stream) < _HDR_FIXED or stream[0] != MAGIC:
        raise ValueError("not a TPU-rANS stream")
    if stream[1] != VERSION:
        raise ValueError(f"unsupported TPU-rANS version {stream[1]}")
    if stream[2] > 16:
        raise ValueError("TPU-rANS stream corrupt (lane count)")
    nways = 1 << stream[2]
    flags = stream[3]
    n = int.from_bytes(stream[4:8], "little")
    m = int.from_bytes(stream[8:12], "little")
    body_bytes = int.from_bytes(stream[12:16], "little")
    xbits_bytes = int.from_bytes(stream[16:20], "little")
    p = _HDR_FIXED
    if flags & 1:
        if p + n + 4 > len(stream):
            raise ValueError("TPU-rANS stream truncated")
        raw = stream[p: p + n]
        adler = int.from_bytes(stream[p + n: p + n + 4], "big")
        if zlib.adler32(raw) != adler:
            raise ValueError("TPU-rANS stream corrupt (adler mismatch)")
        return {"stored": raw}
    if flags & 2:  # symbol mode: sparse frequency table over 2^sym_bits
        if p + 4 > len(stream):
            raise ValueError("TPU-rANS stream truncated")
        sym_bits = stream[p]
        if not 8 <= sym_bits <= 16:
            raise ValueError("TPU-rANS stream corrupt (symbol width)")
        if (flags & 4) and sym_bits != GAP_BITS:
            raise ValueError("TPU-rANS stream corrupt (gap symbol width)")
        n_used = int.from_bytes(stream[p + 2: p + 4], "little")
        p += 4
        if n_used == 0 or n_used > (1 << sym_bits) or \
                p + 4 * n_used + 4 * nways + body_bytes + 4 > len(stream):
            raise ValueError("TPU-rANS stream truncated")
        sp_syms = np.frombuffer(stream[p: p + 2 * n_used], "<u2").astype(np.int64)
        p += 2 * n_used
        sp_vals = np.frombuffer(stream[p: p + 2 * n_used], "<u2").astype(np.int64)
        p += 2 * n_used
        if (sp_syms >= (1 << sym_bits)).any() or \
                (np.diff(sp_syms) <= 0).any() or sp_vals.sum() != M:
            raise ValueError("TPU-rANS stream corrupt (frequency table)")
        freq = np.zeros(1 << sym_bits, np.int64)
        freq[sp_syms] = sp_vals
        states = np.frombuffer(stream[p: p + 4 * nways], "<u4")
        p += 4 * nways
        body = stream[p: p + body_bytes]
        p += body_bytes
        adler = int.from_bytes(stream[p: p + 4], "big")
        return {"nways": nways, "n": n, "m": m, "freq": freq,
                "states": states, "body": body, "adler": adler,
                "sym_bits": sym_bits, "gap": bool(flags & 4)}
    bm_len = (N_SYM + 7) // 8
    if p + bm_len > len(stream):
        raise ValueError("TPU-rANS stream truncated")
    used = np.unpackbits(
        np.frombuffer(stream[p: p + bm_len], np.uint8),
        bitorder="little")[:N_SYM].astype(bool)
    p += bm_len
    n_used = int(used.sum())
    if p + 2 * n_used + 4 * nways + body_bytes + xbits_bytes + 4 > len(stream):
        raise ValueError("TPU-rANS stream truncated")
    freq = np.zeros(N_SYM, np.int64)
    freq[used] = np.frombuffer(stream[p: p + 2 * n_used], "<u2")
    p += 2 * n_used
    if freq.sum() != M:
        raise ValueError("TPU-rANS stream corrupt (frequency table)")
    states = np.frombuffer(stream[p: p + 4 * nways], "<u4")
    p += 4 * nways
    body = stream[p: p + body_bytes]
    p += body_bytes
    xbits = stream[p: p + xbits_bytes]
    p += xbits_bytes
    adler = int.from_bytes(stream[p: p + 4], "big")
    return {"nways": nways, "n": n, "m": m, "freq": freq, "states": states,
            "body": body, "xbits": xbits, "adler": adler}


def _reconstruct_bytes(syms: np.ndarray, xbits: bytes, n: int,
                       adler: int) -> bytes:
    """Symbols + extra-bit stream -> original bytes, adler-verified.

    A literal emits its byte; a match copies the previous byte ``take``
    times (all matches are distance 1).  Match tokens replicate the byte
    before their start: the tokenizer guarantees a run's leading literal
    precedes its matches, so filling forward over match spans reproduces
    the bytes exactly."""
    from .. import native

    raw = None
    try:
        raw = native.rans_reconstruct(syms, xbits, n)  # memcpy-class C loop
    except ValueError:
        raise ValueError("TPU-rANS stream corrupt (length mismatch)")
    if raw is None:
        # numpy fallback: every op runs at TOKEN granularity (4-5x fewer
        # elements than bytes); the single per-byte pass is the np.repeat
        # expansion.  A match copies the last literal at or before it in
        # token order, which equals the run's leading literal (distance-1
        # matches; see docstring).
        eb = np.where(syms < 256, 0,
                      LEN_EXTRA[np.clip(syms - 257, 0, 28)]).astype(np.int64)
        ev = _unpack_bits(xbits, eb)
        takes = _syms_to_tokens(syms, ev)
        if (takes.sum() if takes.size else 0) != n:
            raise ValueError("TPU-rANS stream corrupt (length mismatch)")
        is_lit = syms < 256
        m = syms.size
        last_idx = np.maximum.accumulate(np.where(is_lit, np.arange(m), -1))
        vals = np.where(last_idx >= 0, syms[np.maximum(last_idx, 0)],
                        0).astype(np.uint8)   # corrupt leading match -> 0
        raw = np.repeat(vals, takes).tobytes()
    if zlib.adler32(raw) != adler:
        raise ValueError("TPU-rANS stream corrupt (adler mismatch)")
    return raw


def _host_decompress(stream: bytes) -> bytes:
    """Fast host decode: the native C++ decoder when available, else the
    numpy reference (whose rANS loop is per-token Python — slow)."""
    from .. import native

    if native.available():
        return native.rans_decompress(stream)
    return decompress(stream)



def compress(data: bytes, nways: int = NWAYS_DEFAULT) -> bytes:
    """Compress ``data`` into a TPU-rANS stream (numpy reference path)."""
    raw = np.frombuffer(bytes(data), np.uint8)
    n = raw.size
    lut_idx, _ = tokenize_bytes_np(raw)
    syms, ev, eb = _token_syms_and_extras(lut_idx)
    m = syms.size
    # small streams: fewer interleave lanes (4 B of final state per lane)
    while nways > 8 and nways > m:
        nways //= 2
    counts = np.bincount(syms, minlength=N_SYM)
    freq = quantize_freqs(counts)
    body, states = rans_encode_interleaved(syms, freq, nways)
    xbits = _pack_bits(ev, eb)
    adler = zlib.adler32(bytes(data))

    stream = _finish_stream(n, m, nways, freq, states, body, xbits, adler)
    if len(stream) > n + _STORED_OVERHEAD:
        return _stored_stream(bytes(data), adler)
    return stream


def compress_symbols(data: bytes, sym_bits: int,
                     nways: int = NWAYS_DEFAULT) -> bytes:
    """Compress a bit-packed value stream over ``sym_bits``-wide symbols.

    ``data`` is an LSB-first packed stream of ``sym_bits``-bit values (the
    container's packed-pixval wire format, oracle.bit_pack); symbols are
    coded directly, skipping the byte-granularity model.  Falls back to the
    byte-mode coder or a stored stream when those are smaller (many distinct
    symbols, tiny streams).  Requires 8 <= sym_bits <= 16."""
    if not 8 <= sym_bits <= 16:
        raise ValueError("symbol mode supports 8..16-bit symbols")
    data = bytes(data)
    n = len(data)
    m = n * 8 // sym_bits
    # 4*nways bytes of final state are pure header overhead: cap lanes so
    # states stay ~1.5% of the symbol count (64 symbols/lane amortizes them),
    # floor 8 so tiny streams still interleave
    eff = min(nways, max(8, 1 << int(np.log2(max(m // 64, 1)))))

    from .. import native

    if native.available():
        # the C encoder is byte-identical to the numpy path below (parity
        # test in test_native.py) and ~1000x faster on big streams
        stream = native.rans_compress_symbols_native(data, sym_bits, eff)
        if stream is None:   # pad bits nonzero / alphabet too wide
            return native.rans_compress(data, nways)
        alt = native.rans_compress(data, nways)
        if len(alt) < len(stream):
            return alt
        if len(stream) > n + _STORED_OVERHEAD:
            return _stored_stream(data, zlib.adler32(data))
        return stream

    adler = zlib.adler32(data)
    from .. import oracle

    vals = oracle.bit_unpack(data, sym_bits, m,
                             dtype=np.uint32).astype(np.int64)
    # trailing pad bits must be zero or re-packing won't reproduce the bytes
    repack = oracle.bit_pack(vals.astype(np.uint64), sym_bits)
    if repack.tobytes() != data:
        return compress(data, nways)
    counts = np.bincount(vals, minlength=1 << sym_bits)
    used = counts > 0
    n_used = int(used.sum())
    if n_used > M:            # every used symbol needs freq >= 1 out of M
        return compress(data, nways)
    freq = quantize_freqs(counts).astype(np.int64)
    body, states = rans_encode_interleaved(vals, freq, eff)
    sp = np.flatnonzero(used)
    stream = _finish_stream_symbols(n, m, eff, sym_bits, sp, freq[sp],
                                    states, body, adler)
    alt = compress(data, nways)
    if len(alt) < len(stream):
        return alt
    if len(stream) > n + _STORED_OVERHEAD:
        return _stored_stream(data, adler)
    return stream


def bitmap_to_gaps(bitmap: np.ndarray) -> np.ndarray:
    """LSB-first bitmap bytes -> gap-mode symbol stream (int64).

    For each set bit at linear position ``p`` (previous set position
    ``prev``, starting at -1), the run of clear bits ``g = p - prev - 1`` is
    emitted as ``g // 4095`` escape symbols (4095) followed by the literal
    ``g % 4095``.  Trailing clear bits after the last set bit are implied by
    the bitmap length (the stream header's ``n_bytes``)."""
    bits = np.unpackbits(np.ascontiguousarray(bitmap, dtype=np.uint8),
                         bitorder="little")
    pos = np.flatnonzero(bits).astype(np.int64)
    if pos.size == 0:
        return np.zeros(0, np.int64)
    gaps = np.diff(pos, prepend=np.int64(-1)) - 1
    esc = gaps // GAP_ESCAPE
    m = int(esc.sum()) + gaps.size
    syms = np.full(m, GAP_ESCAPE, np.int64)
    syms[np.cumsum(esc + 1) - 1] = gaps % GAP_ESCAPE
    return syms


def gaps_to_bitmap(syms: np.ndarray, n_bytes: int) -> bytes:
    """Inverse of :func:`bitmap_to_gaps` (raises ValueError on overrun)."""
    syms = np.asarray(syms, np.int64)
    is_lit = syms != GAP_ESCAPE
    adv = np.where(is_lit, syms + 1, np.int64(GAP_ESCAPE))
    ends = np.cumsum(adv)
    pos = ends[is_lit] - 1
    if pos.size and int(pos[-1]) >= n_bytes * 8:
        raise ValueError("TPU-rANS stream corrupt (gap overrun)")
    bits = np.zeros(n_bytes * 8, np.uint8)
    bits[pos] = 1
    return np.packbits(bits, bitorder="little").tobytes()


def compress_gaps(bitmap: bytes, nways: int = NWAYS_DEFAULT) -> bytes:
    """Compress an LSB-first BITMAP via the gap transform (flags 2|4).

    Size-equivalent to byte-symbol coding of the same bitmap (identical
    entropy) but with one symbol per SET BIT instead of one per byte —
    ~1/occupancy fewer trips through the serial rANS chain.  Falls back to
    byte-symbol mode when the transform cannot win (empty or dense bitmaps,
    where set bits outnumber bytes)."""
    bitmap = bytes(bitmap)
    n = len(bitmap)
    syms = bitmap_to_gaps(np.frombuffer(bitmap, np.uint8))
    m = syms.size
    if m == 0 or m > n:
        return compress_symbols(bitmap, 8, nways)
    adler = zlib.adler32(bitmap)
    eff = min(nways, max(8, 1 << int(np.log2(max(m // 64, 1)))))

    from .. import native

    if native.available():
        stream = native.rans_compress_gaps_native(bitmap, eff)
    else:
        counts = np.bincount(syms, minlength=1 << GAP_BITS)
        freq = quantize_freqs(counts).astype(np.int64)
        body, states = rans_encode_interleaved(syms, freq, eff)
        sp = np.flatnonzero(counts > 0)
        stream = _finish_stream_symbols(n, m, eff, GAP_BITS, sp, freq[sp],
                                        states, body, adler, gap=True)
    if stream is None:
        return compress_symbols(bitmap, 8, nways)
    # the sparse gap table (4 bytes/used symbol, up to 4096 entries) can
    # outweigh the transform at very low occupancy — keep whichever wins
    alt = compress_symbols(bitmap, 8, nways)
    if len(alt) < len(stream):
        return alt
    if len(stream) > n + _STORED_OVERHEAD:
        return _stored_stream(bitmap, adler)
    return stream


def decompress(stream: bytes) -> bytes:
    """Decompress a scheme-12 stream (numpy reference path)."""
    h = _parse_header(stream)
    if "stored" in h:
        return h["stored"]
    syms = rans_decode_interleaved(h["body"], h["states"], h["m"], h["freq"],
                                   h["nways"])
    return _symbols_to_bytes(syms, h)


def _symbols_to_bytes(syms: np.ndarray, h: dict) -> bytes:
    """A coded stream's decoded symbols -> its original bytes, adler-checked:
    the gap transform's bitmap, the re-packed symbol stream, or the
    byte-mode reconstruction."""
    if "sym_bits" not in h:
        return _reconstruct_bytes(syms, h["xbits"], h["n"], h["adler"])
    if h.get("gap"):
        raw = gaps_to_bitmap(syms, h["n"])
    else:
        from .. import oracle

        raw = oracle.bit_pack(np.asarray(syms).astype(np.uint64), h["sym_bits"]).tobytes()
        raw = raw[: h["n"]] + b"\x00" * (h["n"] - len(raw))
    if zlib.adler32(raw) != h["adler"]:
        raise ValueError("TPU-rANS stream corrupt (adler mismatch)")
    return raw


# ------------------------------------------------------- device pipelines
#
# The device half on torch tensors (CUDA: the port's kernels; CPU: their
# twins).  Against the JAX version: no ``interpret``, no TPU capacity
# buckets or geometry guards, one body buffer sized from the symbol counts,
# adler32 from exact int64 reductions, and one capacity for the bitmap ->
# positions kernel (#12) where the JAX coder climbs its capacity buckets.

# The write side's spans (``profiling.annotate``), for a profile to read:
# ``rans.encode`` around each call of a symbol- or gap-mode batch encoder;
# inside it ``rans.code`` (the device work, through the fetch of its
# outputs: the gap symbols, the value unpack, the histogram, the adler32
# sums, the interleaved encode and its bodies, counts and states) and
# ``rans.host_stage`` (frequency quantisation and the per-stream loop:
# headers, stored blocks, host-coded streams).  Inside the loop, one span a
# stream: ``rans.assemble`` for a stream coded on the card (child
# ``rans.stored`` where the stored block replaces it), ``rans.host_coder``
# for one the host coder takes (fewer than 65536 symbols, escape gaps, more
# set bits than bytes, or the whole batch where the positions overflow).

W_LANES = 1024                  # lanes of one group (format log2_nways = 10)
ROWS_R = 8                      # groups of a call whose streams are all long
KERNEL_NWAYS = (W_LANES, ROWS_R * W_LANES)
DEVICE_MIN_SYMBOLS = 65536      # below: the host coder and its adaptive lanes
GROUPS8_MIN_SYMBOLS = 1 << 21   # 32 KB of states amortized to < ~3%


def _groups_for(ms: np.ndarray) -> int:
    """8 (nways 8192) when every stream of the call with at least 65536
    symbols has at least 2^21 of them, else 1: the JAX coder's choice,
    which counts the host-coded long streams too."""
    long = ms[ms >= DEVICE_MIN_SYMBOLS]
    return ROWS_R if long.size and int(long.min()) >= GROUPS8_MIN_SYMBOLS else 1


def _adler32_device(streams, lengths) -> list:
    """adler32 of each row's first ``lengths[i]`` bytes from exact int64
    reductions on the streams' device: A = 1 + sum d_i and
    B = n + sum (n - i) d_i, both taken mod 65521 at the end."""
    B, nb = streams.shape
    lens = torch.as_tensor(np.asarray(lengths, np.int64), device=streams.device)
    idx = torch.arange(nb, dtype=torch.int64, device=streams.device)
    d = torch.where(idx[None, :] < lens[:, None], streams.to(torch.int64), 0)
    s1 = d.sum(dim=1).cpu().numpy()
    s2 = (d * (lens[:, None] - idx[None, :])).sum(dim=1).cpu().numpy()
    n = np.asarray(lengths, np.int64)
    return [int((((n[i] + s2[i]) % 65521) << 16) | ((1 + s1[i]) % 65521)) for i in range(B)]


def _raw_reader(streams, lengths, raw_cb):
    """raw(i): stream i's bytes, from ``raw_cb`` or read back from the device."""
    def raw(i):
        if raw_cb is not None:
            return raw_cb(i)
        return streams[i, :int(lengths[i])].cpu().numpy().tobytes()
    return raw


def freq_tables(hist: np.ndarray, alphabet: int):
    """The device coders' tables from histograms (B, >= alphabet): each
    row's quantized frequencies of its first ``alphabet`` counts, (B, 4096)
    int64 with the alphabet in front, and their exclusive prefix."""
    freqs = np.zeros((len(hist), hopper_rans.ALPHABET), np.int64)
    for i, row in enumerate(hist):
        freqs[i, :alphabet] = quantize_freqs(row[:alphabet])
    cums = np.zeros_like(freqs)
    cums[:, 1:] = np.cumsum(freqs, axis=1)[:, :-1]
    return freqs, cums


def token_capacity(ms: np.ndarray) -> int:
    """The dense token capacity of a byte-mode batch: its largest token
    count, rounded up to the 1024 lanes."""
    return -(-max(int(np.max(ms)), 1) // W_LANES) * W_LANES


def _code_streams(syms, ms: np.ndarray, coded: np.ndarray, alphabet: int):
    """Histogram, host quantized tables and interleaved-rANS encode of the
    ``coded`` rows of ``syms`` (B, NPAD) int32.  Returns (freqs (B, 4096),
    lanes, bodies (B, max count) uint8, counts (B,), states (B, lanes))."""
    dev = syms.device
    m_coded = np.where(coded, ms, 0).astype(np.int32)
    with annotate("rans.code"):
        m_dev = torch.from_numpy(m_coded).to(dev)
        hist = hopper_rans.rans_hist(syms, m_dev).cpu().numpy()
    with annotate("rans.host_stage"):
        freqs, cums = freq_tables(hist, alphabet)
    groups = _groups_for(ms)
    out_bound = 2 * int(m_coded.max()) + 16   # <= 2 bytes a symbol
    with annotate("rans.code"):
        body, states, counts = hopper_rans.rans_encode(
            syms, *(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (freqs, cums)),
            m_dev, out_bound, groups)
        counts = counts.cpu().numpy()
        if (counts > out_bound).any():
            raise RuntimeError("rANS body exceeded its bound of 2 bytes a symbol")
        bodies = body[:, :int(counts.max())].cpu().numpy()
        states = states.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    return freqs, groups * W_LANES, bodies, counts, states


def _unpack_symbols(packed, sym_bits: int):
    """(B, NB) uint8 packed ``sym_bits``-wide values -> (B, >= NB*8/sym_bits)
    int32: the 12-bit unpack kernel at 12 bits, the bytes themselves at 8."""
    if sym_bits == 8:
        return packed.to(torch.int32)
    _, g_bytes = packed_group_shape(sym_bits)
    pad = -packed.shape[1] % g_bytes
    if pad:
        packed = torch.nn.functional.pad(packed, (0, pad))
    return bitunpack_values_device(packed.contiguous(), sym_bits)


def rans_symbols_batch_device(packed, plens, sym_bits: int, raw_cb=None) -> list:
    """Scheme-12 SYMBOL-mode (flags bit1) encode of bit-packed value streams.

    ``packed`` (B, NB) uint8 on the CPU or a CUDA device, LSB-first
    ``sym_bits``-bit values; ``plens`` (B,) true byte lengths.  The unpack,
    histogram and interleaved-rANS coding run where the streams lie; the
    host quantizes frequencies and assembles headers.  Streams of fewer than
    65536 symbols take the host coder; a coded stream longer than stored
    blocks becomes stored.  Returns B scheme-12 streams.

    Spans: ``rans.encode`` around the call, and its children (above).
    """
    if not 8 <= sym_bits <= 12:
        raise ValueError("device symbol mode supports 8..12-bit symbols")
    with annotate("rans.encode"):
        B = packed.shape[0]
        plens = np.asarray(plens, np.int64)
        ms = plens * 8 // sym_bits
        coded = ms >= DEVICE_MIN_SYMBOLS
        raw = _raw_reader(packed, plens, raw_cb)
        if not coded.any():
            return _finish_batch(B, coded, raw, lambda r: compress_symbols(r, sym_bits), None)
        with annotate("rans.code"):
            values = _unpack_symbols(packed, sym_bits)
        freqs, nways, bodies, counts, states = _code_streams(values, ms, coded, 1 << sym_bits)
        with annotate("rans.code"):
            adlers = _adler32_device(packed, plens)

        def finish(i):
            sp = np.flatnonzero(freqs[i] > 0)
            return plens[i], adlers[i], _finish_stream_symbols(
                int(plens[i]), int(ms[i]), nways, sym_bits, sp, freqs[i][sp], states[i],
                bodies[i, :counts[i]].tobytes(), adlers[i])
        return _finish_batch(B, coded, raw, lambda r: compress_symbols(r, sym_bits), finish)


def _finish_batch(B: int, coded: np.ndarray, raw, host_coder, finish) -> list:
    """The per-stream loop of a batch encoder (span ``rans.host_stage``):
    ``host_coder(raw(i))`` for a stream not ``coded`` on the card, else
    ``finish(i)``'s (length, adler32, coded stream), stored where that is
    the smaller."""
    results = []
    with annotate("rans.host_stage"):
        for i in range(B):
            if not coded[i]:
                with annotate("rans.host_coder"):
                    results.append(host_coder(raw(i)))
                continue
            with annotate("rans.assemble"):
                n, adler, stream = finish(i)
                if len(stream) > n + _STORED_OVERHEAD:
                    with annotate("rans.stored"):
                        stream = _stored_stream(raw(i), adler)
            results.append(stream)
    return results


def rans_gaps_batch_device(bitmaps, blens, raw_cb=None, positions=None,
                           pos_counts=None, out_bound=None) -> list:
    """Scheme-12 GAP-mode (flags 2|4) encode of a bitmap batch.

    ``bitmaps`` (B, NB) uint8 LSB-first bitmaps, zero past ``blens`` (B,),
    their true byte lengths.  ``positions`` (B, P) int32 ascending set-bit
    positions and ``pos_counts`` (B,) int32 their counts, as the L1 encode
    kernel's positions output gives them; without them the bitmap ->
    positions kernel (:func:`hopper_gaps.bitmap_positions`) extracts them
    with the JAX coder's capacity, ``out_bound`` (default 2 * NB, one set
    bit in four) rounded up to 8192; if any frame holds more set bits, the
    whole batch takes the host coder, as the JAX coder does when its
    capacity buckets run out.
    First-order gaps, histogram and interleaved-rANS coding run where the
    tensors lie.  A frame with a run
    of 4095 or more clear bits (escape symbols), with fewer than 65536 set
    bits, or with more set bits than bitmap bytes takes the host coder.
    Returns B scheme-12 streams.

    Spans: ``rans.encode`` around the call, and its children (above).
    """
    with annotate("rans.encode"):
        B = bitmaps.shape[0]
        blens = np.asarray(blens, np.int64)
        raw = _raw_reader(bitmaps, blens, raw_cb)
        if positions is None:
            if out_bound is None:
                out_bound = 2 * bitmaps.shape[1]
            out_bound = -(-out_bound // (ROWS_R * W_LANES)) * ROWS_R * W_LANES
            with annotate("rans.code"):
                positions, pos_counts, overflow = hopper_gaps.bitmap_positions(bitmaps,
                                                                              out_bound)
                overflow = bool(overflow.any())
            if overflow:
                return _finish_batch(B, np.zeros(B, bool), raw, compress_gaps, None)
        with annotate("rans.code"):
            pos = positions.to(torch.int32)
            cnt = pos_counts.to(torch.int32)
            valid = torch.arange(pos.shape[1], device=pos.device)[None, :] < cnt[:, None]
            prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=pos.device),
                              pos[:, :-1]], dim=1)
            syms = torch.where(valid, pos - prev - 1, 0)
            ms = cnt.cpu().numpy().astype(np.int64)
            escape = ((syms >= GAP_ESCAPE) & valid).any(dim=1).cpu().numpy()
        coded = ~escape & (ms >= DEVICE_MIN_SYMBOLS) & (ms <= blens)
        if not coded.any():
            return _finish_batch(B, coded, raw, compress_gaps, None)
        with annotate("rans.code"):
            syms = syms.clamp(max=GAP_ESCAPE - 1).contiguous()
        freqs, nways, bodies, counts, states = _code_streams(syms, ms, coded, 1 << GAP_BITS)
        with annotate("rans.code"):
            adlers = _adler32_device(bitmaps, blens)

        def finish(i):
            sp = np.flatnonzero(freqs[i] > 0)
            return blens[i], adlers[i], _finish_stream_symbols(
                int(blens[i]), int(ms[i]), nways, GAP_BITS, sp, freqs[i][sp], states[i],
                bodies[i, :counts[i]].tobytes(), adlers[i], gap=True)
        return _finish_batch(B, coded, raw, compress_gaps, finish)


# ------------------------------------------------------ the writer's rules
#
# The mode of each stream of a frame, as the JAX writer chooses it.  It pads
# its streams to its deflate kernel's 16384-byte step before the coders see
# them: the L1 dense test compares the value count with the padded width,
# and the gap coder's positions capacity is two a byte of it.
_JAX_BITMAP_STEP = 16384


def _gaps_padded(streams, lens, out_bound=None) -> list:
    pad = -streams.shape[1] % _JAX_BITMAP_STEP
    if pad:
        streams = torch.nn.functional.pad(streams, (0, pad))
    return rans_gaps_batch_device(streams, lens, out_bound=out_bound)


def _l1_streams(streams, lens, value_counts, positions=None, pos_counts=None) -> list:
    """Gap mode, or 8-bit symbols where a frame's values reach the padded
    width and gaps cannot win; gaps from the encode's positions where given,
    else from the bitmap -> positions kernel at the most values + 4096."""
    most = int(value_counts.max())
    if most >= -(-streams.shape[1] // _JAX_BITMAP_STEP) * _JAX_BITMAP_STEP:
        return rans_symbols_batch_device(streams, lens, 8)
    if positions is not None:
        return rans_gaps_batch_device(streams, lens, positions=positions, pos_counts=pos_counts)
    return _gaps_padded(streams, lens, most + 4096)


def encode_bitmaps_device(bitmaps, level: int, bit_depth: int, plens=None, positions=None,
                          pos_counts=None) -> list:
    """A device batch's bitmap streams (B, NB) uint8: at L1 by
    :func:`_l1_streams`, with the value counts of ``plens`` (the packed
    values' byte lengths) and the encode's positions; at L2-L4 in gap mode."""
    lens = np.full(bitmaps.shape[0], bitmaps.shape[1], np.int32)
    if level == 1:
        return _l1_streams(bitmaps, lens, plens * 8 // bit_depth, positions, pos_counts)
    return _gaps_padded(bitmaps, lens)


def encode_values_device(packed, plens, level: int, bit_depth: int) -> list:
    """A device batch's packed value streams: L1 values of 8..12 bits as
    symbols of their width, other L1 widths by :func:`_l1_streams`, L2
    statistics in gap mode."""
    if level == 1 and 8 <= bit_depth <= 12:
        return rans_symbols_batch_device(packed, plens, bit_depth)
    if level == 1:
        return _l1_streams(packed, plens, plens * 8 // bit_depth)
    return _gaps_padded(packed, plens)


def host_coders(level: int, bit_depth: int):
    """(bitmap coder, values coder) of one frame on the host: gaps for the
    bitmap, L1 values of 9..16 bits as symbols of their width, others as
    8-bit symbols."""
    sym_bits = bit_depth if level == 1 and 9 <= bit_depth <= 16 else 8
    return compress_gaps, lambda values: compress_symbols(values, sym_bits)


def extra_bits_lut() -> np.ndarray:
    """(48, 32) float32 token LUT of the deflate assembler
    (:func:`hopper_deflate.assemble`) that packs byte mode's extra bits: per
    token index over 768 (rows 0..23 the value ev, rows 24..47 its bit count
    eb; matches only), the counterpart of rows 48..95 of the TPU's
    encode_luts_radix."""
    idx = np.arange(768)
    take = idx - 253
    is_match = (idx >= 256) & (idx < NO_TOKEN)
    code = np.clip(np.searchsorted(LEN_BASE, take, side="right") - 1, 0, 28)
    ev = np.where(is_match, take - LEN_BASE[code], 0)
    eb = np.where(is_match, LEN_EXTRA[code], 0)
    return np.concatenate([ev.reshape(24, 32), eb.reshape(24, 32)]).astype(np.float32)


def rans_batch_device(streams, lengths, raw_cb=None) -> list:
    """Byte-mode scheme-12 encode of a batch of byte streams.

    ``streams`` (B, NPAD) uint8 on the CPU or a CUDA device, ``lengths``
    (B,) valid bytes.  The deflate tokenizer (tokens, histogram, adler32),
    the token compaction, the interleaved-rANS encode of the tokens
    (:func:`hopper_rans.rans_encode_tokens`) and the extra-bits packing
    (the deflate assembler with :func:`extra_bits_lut`) run where the
    streams lie; the host quantizes 286 frequencies a stream and builds the
    headers.  Always 1024 lanes, as the JAX coder: a stream of at least 1024
    tokens equals ``compress(raw, nways=1024)``; shorter ones, where the host
    coder narrows its lanes, decode the same.  A coded stream longer than a
    stored one becomes stored (raw bytes from ``raw_cb(i)`` or read back).
    Returns B scheme-12 streams.
    """
    B = streams.shape[0]
    if B == 0:
        return []
    dev = streams.device
    lengths = np.asarray(lengths, np.int32)
    tok, hist, adler = hopper_deflate.tokenize(streams, torch.from_numpy(lengths.copy()).to(dev))
    hist = hist.cpu().numpy()[:, :N_SYM].astype(np.int64)
    adlers = adler.cpu().numpy()
    ms = hist.sum(axis=1)
    # the rANS kernel codes dense tokens: one capacity, the largest count
    tok_bound = token_capacity(ms)
    dense, _, overflow = hopper_deflate.compact_tokens(tok, tok_bound)
    if bool(overflow.any()):
        raise RuntimeError("token compaction overflowed its exact bound")
    freqs, cums = freq_tables(hist, N_SYM)
    out_bound = 2 * tok_bound + 16        # <= 2 bytes a token
    body, states, counts = hopper_rans.rans_encode_tokens(
        dense, *(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (freqs, cums, ms)),
        out_bound)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    lut = torch.from_numpy(extra_bits_lut()).to(dev).expand(B, 48, 32).contiguous()
    xbody, xbits, xoverflow = hopper_deflate.assemble(dense, lut, zeros, zeros,
                                                      (5 * tok_bound + 7) // 8 + 256)
    counts = counts.cpu().numpy()
    if (counts > out_bound).any() or bool(xoverflow.any()):
        raise RuntimeError("rANS body or extra bits exceeded their bounds")
    bodies = body[:, :int(counts.max())].cpu().numpy()
    xbytes = (xbits.cpu().numpy().astype(np.int64) + 7) // 8
    xbodies = xbody[:, :int(xbytes.max())].cpu().numpy()
    states = states.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    raw = _raw_reader(streams, lengths, raw_cb)
    results = []
    for i in range(B):
        n = int(lengths[i])
        stream = _finish_stream(n, int(ms[i]), W_LANES, freqs[i, :N_SYM], states[i],
                                bodies[i, :counts[i]].tobytes(), xbodies[i, :xbytes[i]].tobytes(),
                                int(adlers[i]))
        if len(stream) > n + _STORED_OVERHEAD:
            stream = _stored_stream(raw(i), int(adlers[i]))
        results.append(stream)
    return results


def _decode_inputs(metas: list, device) -> dict:
    """Padded tensors on ``device`` for a batch of parsed coded streams that
    share one lane count: reversed bodies and their lengths, states, symbol
    counts and slot tables."""
    B = len(metas)
    ms = np.array([h["m"] for h in metas], np.int32)
    blens = np.array([len(h["body"]) for h in metas], np.int32)
    bodies = np.zeros((B, max(int(blens.max()), 1)), np.uint8)
    for k, h in enumerate(metas):
        bodies[k, :blens[k]] = np.frombuffer(h["body"], np.uint8)[::-1]
    states = np.stack([h["states"] for h in metas]).astype(np.int64).astype(np.int32)
    tables = np.stack([hopper_rans.decode_tables(h["freq"]) for h in metas])
    nways = metas[0]["nways"]
    return {"body": torch.from_numpy(bodies).to(device),
            "blen": torch.from_numpy(blens).to(device),
            "states": torch.from_numpy(states).to(device),
            "m": torch.from_numpy(ms).to(device),
            "tables": torch.from_numpy(tables).to(device),
            "npad": max(int(ms.max()), 1), "groups": nways // W_LANES,
            "ms": ms, "ns": np.array([h["n"] for h in metas], np.int64)}


def _decode_symbols(inp: dict):
    """(B, npad) int32 symbols of a batch from :func:`_decode_inputs`."""
    syms, underflow = hopper_rans.rans_decode(inp["body"], inp["blen"], inp["states"], inp["m"],
                                              inp["tables"], inp["npad"], inp["groups"])
    if bool(underflow.any()):
        raise ValueError("TPU-rANS stream corrupt (body underflow)")
    return syms


def rans_decompress_device_batch(streams_in, device) -> list:
    """Batched decode of scheme-12 streams on ``device`` (the reader's bulk
    byte path): one decode launch per lane count covers every coded stream;
    stored streams pass through and streams of other lane counts take the
    host decoder.  Returns the byte payloads, each adler-checked."""
    outs: list = [None] * len(streams_in)
    metas = []
    for i, st in enumerate(streams_in):
        h = _parse_header(st)
        if "stored" in h:
            outs[i] = h["stored"]
        elif h["nways"] not in KERNEL_NWAYS:
            outs[i] = _host_decompress(st)
        else:
            metas.append((i, h))
    for nways in KERNEL_NWAYS:
        batch = [(i, h) for i, h in metas if h["nways"] == nways]
        if not batch:
            continue
        syms = _decode_symbols(_decode_inputs([h for _, h in batch], device)).cpu().numpy()
        for k, (i, h) in enumerate(batch):
            outs[i] = _symbols_to_bytes(syms[k, :h["m"]].astype(np.int64), h)
    return outs


def gap_chain_inputs(streams, kind: str, device):
    """Decode inputs (:func:`_decode_inputs`) of per-frame streams that are
    all of one kind and one kernel lane count, or None: kind "gap" (bitmap
    as clear-run gaps, flags 2|4), "sym" (12-bit values, flags 2) or "bm8"
    (bitmap bytes as 8-bit symbols, flags 2)."""
    metas = []
    for st in streams:
        h = _parse_header(st)
        if "stored" in h or "sym_bits" not in h:
            return None
        if kind == "gap" and not h["gap"]:
            return None
        if kind == "sym" and (h["gap"] or h["sym_bits"] != 12):
            return None
        if kind == "bm8" and (h["gap"] or h["sym_bits"] != 8):
            return None
        if h["nways"] not in KERNEL_NWAYS or (metas and h["nways"] != metas[0]["nways"]):
            return None
        metas.append(h)
    return _decode_inputs(metas, device)


def gap_chain_dense(bm_in: dict, pk_in: dict, height: int, width: int):
    """The scheme-12 gap read chain: gaps -> positions (a cumsum), values
    rank-aligned with them, then the positions decode.  The bitmap never
    exists.  Returns (dense (B, H, W) uint16, overflow (B,) bool)."""
    gaps = _decode_symbols(bm_in)
    vals = _decode_symbols(pk_in)
    m = bm_in["m"]
    live = torch.arange(gaps.shape[1], device=gaps.device)[None, :] < m[:, None]
    pos = torch.cumsum(torch.where(live, gaps + 1, 0), dim=1, dtype=torch.int32) - 1
    out = max(pos.shape[1], vals.shape[1])
    pos = torch.nn.functional.pad(pos, (0, out - pos.shape[1])).contiguous()
    vals = torch.nn.functional.pad(vals, (0, out - vals.shape[1])).contiguous()
    return hopper_decode.posdecode(pos, vals, m, height, width)


def decode_l1_gap_device(bm_streams, pk_streams, height: int, width: int, device,
                         verify: bool = False):
    """The fully-device scheme-12 L1 read (gap bitmaps, 12-bit symbol values).

    Returns dense (B, H, W) uint16 on ``device``, or None when the streams
    are not all kernel-decodable gap/symbol streams with equal counts
    (stored, host lane counts, escapes; the caller takes the byte path), or
    with ``verify=True``: this chain never forms the bitmap bytes, so it
    cannot check their adler32, and the byte path does.  The JAX version's
    geometry guard served its TPU kernel's chunk limits; the positions
    kernel here takes any frame.  A decoded position outside the frame
    raises.  The chain, from its first launch through the overflow check,
    is the span ``reader.rans_chain`` (the reader's, which calls it):
    entered only where the chain runs.
    """
    if verify or not bm_streams or len(bm_streams) != len(pk_streams):
        return None
    bm_in = gap_chain_inputs(bm_streams, "gap", device)
    pk_in = gap_chain_inputs(pk_streams, "sym", device)
    if bm_in is None or pk_in is None or not np.array_equal(bm_in["ms"], pk_in["ms"]):
        return None
    with annotate("reader.rans_chain"):
        dense, overflow = gap_chain_dense(bm_in, pk_in, height, width)
        overflow = bool(overflow.any())
    if overflow:
        raise ValueError("TPU-rANS stream corrupt (a decoded position lies outside the frame)")
    return dense


def symbol_chain_dense(bm_in: dict, pk_in: dict, height: int, width: int):
    """The scheme-12 symbol read chain for dense frames: bitmap bytes decode
    as 8-bit symbols straight into the L1 decode kernel, the values as 12-bit
    symbols, rank-aligned.  Returns (dense (B, H, W) uint16, overflow)."""
    bitmap = _decode_symbols(bm_in)[:, :int(bm_in["ns"][0])].to(torch.uint8).contiguous()
    vals = _decode_symbols(pk_in)
    return hopper_decode.decode_l1(bitmap, vals, height, width)


def decode_l1_symbol_device(bm_streams, pk_streams, height: int, width: int, device,
                            verify: bool = False):
    """The fully-device scheme-12 L1 read for bitmaps coded as 8-bit symbols
    (the size winner on dense frames); contract of :func:`decode_l1_gap_device`."""
    if verify or not bm_streams or len(bm_streams) != len(pk_streams):
        return None
    bm_in = gap_chain_inputs(bm_streams, "bm8", device)
    pk_in = gap_chain_inputs(pk_streams, "sym", device)
    if bm_in is None or pk_in is None or (bm_in["ns"] != height * width // 8).any() \
            or height * width % 8:
        return None
    with annotate("reader.rans_chain"):
        dense, overflow = symbol_chain_dense(bm_in, pk_in, height, width)
        overflow = bool(overflow.any())
    if overflow:
        raise ValueError("TPU-rANS stream corrupt (more foreground pixels than values)")
    return dense
