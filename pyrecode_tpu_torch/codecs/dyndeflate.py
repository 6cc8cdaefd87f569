"""Scheme-0 dynamic deflate: the host helpers and the device entropy stage.

The port's own copy of the numpy half of pyrecode_tpu/codecs/dyndeflate.py
(the per-byte tokenizer reference, the pairs tokenizer reference
``tokens_from_pairs_np`` with its closed-form gap schedule, the length-code
tables, and the stream finishing: end-of-block splice, stored-block
fallback, adler trailer), and
the port of its device half (``deflate_batch_device``,
``_tables_assemble_finish``) on torch tensors.  Tokens, histograms, adler32
and the bit assembly run on the streams' device (:mod:`..ops.hopper_deflate`);
the host builds each stream's canonical Huffman tables, block header and
token LUT with ``native.entropy_host_tables``.  Every stream is
byte-identical to ``native.deflate_sparse``.

Against the JAX version: no ``interpret`` (a CPU tensor runs the kernels'
twins), no ``compact`` switch (compaction is chosen as the JAX default
chooses it), no environment switches (``split_assemble=True`` takes the
place of ``PYRECODE_SPLIT_ASSEMBLE=1``), one token capacity instead of the
TPU's capacity buckets, and one read of all bodies instead of one per
stream.  The native host library is required: without it the JAX
version's three-step table path fails too (``native.dyn_tables`` raises).

The tokenizer rule (the native encoder's, made data-parallel): every byte
emits at most one token, decided by its offset ``p`` in its run and its
distance ``d`` to the run's end:

 * run length < 4          -> every byte is a literal
 * p == 0                  -> literal (the run's leading literal)
 * p >= 1, run >= 4, q = p-1:
     q % 258 == 0 and d >= 261          -> match take=258
     q % 258 == 0 and d in {259, 260}   -> match take=255   (keep tail >= 3)
     q % 258 == 0 and 3 <= d <= 258     -> match take=d     (final take)
     q % 258 == 255 and d in {4, 5}     -> match take=d     (post-255 tail)
     otherwise                          -> no token (covered by a match)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..ops import hopper_deflate as hd

# RFC 1951 length-code table: codes 257+c encode match lengths
# [LEN_BASE[c], LEN_BASE[c+1]) with LEN_EXTRA[c] extra bits
LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
                    dtype=np.int32)
LEN_EXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3,
                      3, 4, 4, 4, 4, 5, 5, 5, 5, 0], dtype=np.int32)

# token index: 0..255 = literal byte, 256..511 = match take (3 + idx-256),
# 512 = no token.  (take 258 -> idx 511.)
NO_TOKEN = 512


def length_code(take: np.ndarray) -> np.ndarray:
    """Length-code index c (0..28) for match length 3..258."""
    return (np.searchsorted(LEN_BASE, np.asarray(take, dtype=np.int32),
                            side="right") - 1).astype(np.int32)


def tokenize_bytes_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-byte token decision (numpy reference of the rule above).

    Returns (lut_idx i32[n], sym i32[n]): the token index per byte
    (NO_TOKEN for covered bytes) and the literal/length symbol (0..285, or -1
    for covered bytes) for histogramming.
    """
    x = np.asarray(x, dtype=np.uint8)
    n = x.size
    if n == 0:
        return (np.zeros(0, np.int32),) * 2
    idx = np.arange(n, dtype=np.int32)
    change = np.ones(n, dtype=bool)
    change[1:] = x[1:] != x[:-1]
    # s: index of this byte's run start (last change at or before i)
    s = np.maximum.accumulate(np.where(change, idx, -1).astype(np.int32))
    # e: run end (next change after i, or n)
    starts = np.flatnonzero(change).astype(np.int32)
    run_of = np.cumsum(change, dtype=np.int32)
    run_of -= 1                              # run ordinal per byte
    ends = np.append(starts[1:], np.int32(n))
    e = ends[run_of]
    p = idx - s
    d = e - idx
    run = e - s

    is_lit = (p == 0) | (run < 4)
    q = p - 1
    qm = q % np.int32(258)
    m0 = (qm == 0) & ~is_lit
    take = np.where(d >= 261, np.int32(258),
                    np.where(d >= 259, np.int32(255), d))
    is_match0 = m0 & (d >= 3)
    is_match255 = (qm == 255) & ~is_lit & ((d == 4) | (d == 5))
    take = np.where(is_match255, d, take)
    is_match = is_match0 | is_match255

    lut_idx = np.full(n, NO_TOKEN, dtype=np.int32)
    lut_idx[is_lit] = x[is_lit]
    lut_idx[is_match] = (256 + take[is_match] - 3).astype(np.int32)

    sym = np.full(n, -1, dtype=np.int32)
    sym[is_lit] = x[is_lit]
    sym[is_match] = 257 + length_code(take[is_match])
    return lut_idx, sym


def histogram_np(sym: np.ndarray) -> np.ndarray:
    """286-symbol literal/length frequency table (EOB included)."""
    freq = np.bincount(sym[sym >= 0], minlength=286).astype(np.uint32)
    freq[256] += 1  # end of block
    return freq


def gap_token_count(G: np.ndarray) -> np.ndarray:
    """Number of tokens coding a maximal zero-run of ``G`` bytes.

    Closed form of the per-byte rules above evaluated over one run:
    G <= 3 -> G literals; G >= 4 -> 1 leading literal + j258 take-258
    matches + (2 if the remainder is 259/260 — a 255-take then its 4/5
    tail — else 1) final matches.
    """
    G = np.asarray(G, dtype=np.int64)
    j258 = np.maximum(0, (G - 262) // 258 + 1)
    rem_after = G - 1 - 258 * j258
    tail = np.where(rem_after >= 259, 2, 1)
    return np.where(G <= 3, G, 1 + j258 + tail).astype(np.int64)


def gap_token_value(G: np.ndarray, j: np.ndarray) -> np.ndarray:
    """LUT index of the ``j``-th token (0-based) of a ``G``-byte zero run.

    j == 0 (or any j < G for G <= 3) -> literal 0; otherwise match take
    per the run schedule: 258-takes, then 255 + its 4/5 tail, or the
    direct final take.  Callers guarantee 0 <= j < gap_token_count(G).
    """
    G = np.asarray(G, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    j258 = np.maximum(0, (G - 262) // 258 + 1)
    rem_after = G - 1 - 258 * j258
    # match ordinal (1-based): j itself (slot 0 is the leading literal)
    take = np.where(j <= j258, 258,
                    np.where(rem_after >= 259,
                             np.where(j == j258 + 1, 255, rem_after - 255),
                             rem_after))
    lut = np.where((G <= 3) | (j == 0), 0, 256 + take - 3)
    return lut.astype(np.int32)


def tokens_from_pairs_np(idx: np.ndarray, val: np.ndarray, n: int
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Dense deflate token stream straight from (byte index, byte value)
    pairs of the NONZERO bitmap bytes — the numpy reference for the
    positions-driven device tokenizer (no 2 MB byte scan; work scales with
    foreground bytes, 12x fewer at 1% occupancy).

    ``idx`` strictly ascending nonzero-byte indices, ``val`` their values
    (> 0), ``n`` total bitmap bytes.  Returns (lut_idx, sym) dense token
    arrays identical to compacting :func:`tokenize_bytes_np`'s per-byte
    output, or ``None`` when a nonzero run of length >= 4 exists (equal
    values at >= 4 consecutive indices — those runs emit matches, which
    this per-isolated-byte formulation does not model; callers fall back
    to the byte tokenizer.  Nonzero runs of length <= 3 are all literals
    under the run < 4 rule, so they need no special casing).
    """
    idx = np.asarray(idx, dtype=np.int64)
    val = np.asarray(val, dtype=np.int64)
    if idx.size >= 4:
        # a nonzero run of length >= 4 <=> 3 consecutive "continues the
        # run" flags somewhere
        run = (idx[1:] == idx[:-1] + 1) & (val[1:] == val[:-1])
        if np.any(run[2:] & run[1:-1] & run[:-2]):
            return None
    # element list: each nonzero byte preceded by its zero gap, plus one
    # sentinel element for the tail gap (no literal of its own)
    gaps = np.diff(np.concatenate(([-1], idx, [n]))) - 1  # per element + tail
    gap_counts = gap_token_count(gaps)
    t = gap_counts + 1
    t[-1] -= 1                                  # sentinel: gap tokens only
    offs = np.concatenate(([0], np.cumsum(t)))
    total = int(offs[-1])
    lut_idx = np.zeros(total, dtype=np.int32)
    sym = np.zeros(total, dtype=np.int32)
    for i in range(gaps.size):
        G = int(gaps[i])
        o = int(offs[i])
        tc = int(gap_counts[i])
        if tc:
            jj = np.arange(tc)
            lv = gap_token_value(G, jj)
            lut_idx[o: o + tc] = lv
            sym[o: o + tc] = np.where(
                lv < 256, lv, 257 + length_code(lv - 256 + 3))
        if i < idx.size:
            lut_idx[o + tc] = val[i]
            sym[o + tc] = val[i]
    return lut_idx, sym


def quantize_bound(n: int, ch: int) -> int:
    """Round ``n`` up to the next quarter-octave grid point that is a
    multiple of ``ch`` ({1, 1.25, 1.5, 1.75} x 2^k): token and output
    bounds stay within 25% of what they hold."""
    n = max(int(n), 1)
    m = max((n - 1).bit_length() - 1, 0)
    step = max(1 << max(m - 2, 0), ch)
    return max(-(-n // step) * step, ch)


def stored_blocks(raw: bytes, n: int) -> bytes:
    """RFC 1951 stored (btype 00) blocks wrapping ``raw[:n]`` + zlib header."""
    pieces = [b"\x78\x01"]
    k = 0
    while True:
        take = min(n - k, 65535)
        final = 1 if k + take >= n else 0
        pieces.append(bytes([final, take & 0xFF, take >> 8,
                             (~take) & 0xFF, ((~take) >> 8) & 0xFF]))
        pieces.append(raw[k: k + take])
        k += take
        if k >= n:
            break
    return b"".join(pieces)


def finish_stream(hdr_bytes: np.ndarray, hdr_bits: int, body: np.ndarray,
                  body_bits: int, adler: int, n: int,
                  raw: Optional[bytes] = None) -> bytes:
    """Assemble the final zlib stream from header + device-packed body.

    ``body`` starts at the header's last partial byte (bit offset
    ``hdr_bits % 8`` within its first byte) and already contains the
    end-of-block code; ``body_bits`` counts from that byte's bit 0.  Applies
    the native encoder's stored-block fallback rule (raw bytes required for
    it) and appends the big-endian adler32.
    """
    full_hdr = hdr_bytes[: hdr_bits // 8].tobytes()
    stream = full_hdr + body[: (body_bits + 7) // 8].tobytes()
    stored_size = 2 + n + 5 * (n // 65535 + 1)
    if len(stream) > stored_size and raw is not None:
        stream = stored_blocks(raw, n)
    return stream + int(adler).to_bytes(4, "big")


def splice_eob(body: np.ndarray, total_bits: int, eob_val: int, eob_len: int
               ) -> Tuple[np.ndarray, int]:
    """Append the end-of-block code at bit ``total_bits`` of ``body``."""
    nfull = total_bits // 8
    ph = total_bits % 8
    head = int(body[nfull]) if ph else 0
    word = head | (int(eob_val) << ph)
    nb = (ph + eob_len + 7) // 8
    tail = np.frombuffer(bytes((word >> (8 * i)) & 255 for i in range(nb)),
                         dtype=np.uint8)
    return np.concatenate([body[:nfull], tail]), total_bits + eob_len


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def deflate_batch_device(streams: torch.Tensor, lengths, raw_cb=None, hint_state=None,
                         split_assemble: bool = False):
    """Deflate a batch of byte streams on their device; returns B zlib streams.

    ``streams`` (B, NPAD) uint8 on the CPU or a CUDA device; ``lengths``
    (B,) valid byte counts.  ``raw_cb(i)`` may return stream i's raw bytes
    for the stored-block fallback; without it the fallback reads
    ``streams[i, :n]`` back from the device, and only then.

    ``hint_state`` is an optional dict carrying the observed token density
    from call to call (key ``"density"``).  With a density below 0.5 the
    fused tokenize-and-compact kernel runs; otherwise tokenize, then
    compaction (sparse tokens) or a slice to the longest stream (literal-
    dense tokens).  A token bound that proves too small is retried with the
    exact bound from the histogram: the hint is a speed heuristic, never an
    input to the bytes.

    ``split_assemble`` takes the split bit assembly
    (:func:`..ops.hopper_deflate.assemble_split`) in place of the one-pass
    one; the streams are the same.
    """
    B, npad = streams.shape
    if B == 0:
        return []
    lengths = np.asarray(lengths, dtype=np.int32)
    lengths_dev = torch.from_numpy(lengths.copy()).to(streams.device)
    hint = None if hint_state is None else hint_state.get("density")
    max_len = max(int(lengths.max()), 1)
    tok = None

    if hint is not None and hint < 0.5:
        tok_bound = quantize_bound(max(int(max_len * hint * 1.6), 1), hd.TILE)
        for _ in range(2):
            if tok_bound >= npad:
                break  # not worth compacting: the two-pass route below
            dense, hist, adler, _, overflow = hd.tokenize_compact(streams, lengths_dev, tok_bound)
            hist_np, adler_np = _to_host(hist), _to_host(adler)
            tok_counts = hist_np[:, :286].sum(axis=1).astype(np.int64)
            if not bool(overflow.any()):
                out_bound = min(2 * npad, (tok_bound * hd.MAX_TOKEN_BITS + 7) // 8) + 256
                tok, npad = dense, tok_bound
                break
            # the histogram is exact even on overflow: retry with the exact bound
            tok_bound = quantize_bound(int(tok_counts.max()), hd.TILE)

    if tok is None:
        tok, hist, adler = hd.tokenize(streams, lengths_dev)
        hist_np, adler_np = _to_host(hist), _to_host(adler)
        tok_counts = hist_np[:, :286].sum(axis=1).astype(np.int64)
        tok_bound = quantize_bound(int(tok_counts.max()), hd.TILE)
        # every token of a literal-dense stream lies before its stream's
        # length, so a slice to the longest stream drops the padding for
        # free; compaction pays only where tokens are sparse within it
        slice_cols = min(npad, quantize_bound(max_len, hd.TILE))
        if 2 * tok_bound <= slice_cols and tok_bound < npad:
            dense, _, overflow = hd.compact_tokens(tok, tok_bound)
            if bool(overflow.any()):
                raise RuntimeError("token compaction overflowed its exact bound")
            out_bound = min(2 * npad, (tok_bound * hd.MAX_TOKEN_BITS + 7) // 8) + 256
            tok, npad = dense, tok_bound
        else:
            if slice_cols < npad:
                # through int16: CUDA implements few uint16 operations
                tok = tok.view(torch.int16)[:, :slice_cols].contiguous().view(torch.uint16)
                npad = slice_cols
            out_bound = 2 * npad + 256

    if hint_state is not None:
        hint_state["density"] = float((tok_counts / np.maximum(lengths.astype(np.int64), 1)).max())

    return _tables_assemble_finish(tok, out_bound, hist_np, adler_np, lengths, raw_cb, streams,
                                   split_assemble)


class HostTables(NamedTuple):
    """Each stream's dynamic-block tables, built on the host from its
    tokenizer histogram by ``native.entropy_host_tables``."""

    luts: np.ndarray       # (B, 48, 32) f32, the assembler's token LUTs
    phases: np.ndarray     # (B,) i32, bits of the header's last, partial byte
    partials: np.ndarray   # (B,) i32, that byte
    headers: list          # (header bytes, header bits) per stream
    eobs: list             # (end-of-block code, its bit count) per stream
    body_bits: np.ndarray  # (B,) i64, exact bits of the body without end of block


def host_tables(hist_np: np.ndarray) -> HostTables:
    """Tables of every stream from the tokenizer's (B, 512) histograms."""
    B = int(hist_np.shape[0])
    luts = np.zeros((B, *hd.LUT_SHAPE), np.float32)
    phases = np.zeros(B, np.int32)
    partials = np.zeros(B, np.int32)
    body_bits = np.zeros(B, np.int64)
    headers, eobs = [], []
    for i in range(B):
        tables = native.entropy_host_tables(hist_np[i, :286].astype(np.uint32), luts[i])
        if tables is None:
            raise RuntimeError("device deflate needs the native host library "
                               "(native.available() is False)")
        hdr, hdr_bits, eob_val, eob_len, body_bits[i] = tables
        headers.append((hdr, hdr_bits))
        eobs.append((eob_val, eob_len))
        phases[i] = hdr_bits % 8
        partials[i] = int(hdr[-1]) if hdr_bits % 8 else 0
    return HostTables(luts, phases, partials, headers, eobs, body_bits)


def _tables_assemble_finish(tok, out_bound, hist_np, adler_np, lengths, raw_cb, streams,
                            split_assemble: bool = False):
    """Host Huffman tables and headers, the early all-stored exit, the bit
    assembly on the device (the split form with ``split_assemble``), then
    the end-of-block splice, the per-stream stored fallback and the adler
    trailer on the host."""
    B = int(hist_np.shape[0])
    t = host_tables(hist_np)

    def raw(i):
        n = int(lengths[i])
        return raw_cb(i) if raw_cb is not None else _to_host(streams[i, :n]).tobytes()

    def stored_size(i):
        n = int(lengths[i])
        return 2 + n + 5 * (n // 65535 + 1)

    # the dynamic block's size is exact from the histogram and the tables, so
    # a batch whose every stream takes stored blocks skips the assembly
    final_len = [hdr_bits // 8 + (int(t.phases[i]) + int(t.body_bits[i]) + t.eobs[i][1] + 7) // 8
                 for i, (_, hdr_bits) in enumerate(t.headers)]
    if all(final_len[i] > stored_size(i) for i in range(B)):
        return [stored_blocks(raw(i), int(lengths[i])) + int(adler_np[i]).to_bytes(4, "big")
                for i in range(B)]

    dev = tok.device
    assemble = hd.assemble_split if split_assemble else hd.assemble
    body, totbits, overflow = assemble(
        tok, *(torch.from_numpy(a).to(dev) for a in (t.luts, t.phases, t.partials)), out_bound)
    totbits_np, overflow_np = _to_host(totbits), _to_host(overflow)
    if overflow_np.any():
        # cannot happen: the bound exceeds the worst case of 21 bits a token
        raise RuntimeError(f"device deflate output overflow (streams {np.flatnonzero(overflow_np)})")
    nbytes = [(int(totbits_np[i]) + t.eobs[i][1] + 7) // 8 + 1 for i in range(B)]
    bodies = _to_host(body[:, :max(nbytes)])

    results = []
    for i in range(B):
        hdr, hdr_bits = t.headers[i]
        spliced, bits2 = splice_eob(bodies[i, :nbytes[i]], int(totbits_np[i]), *t.eobs[i])
        fallback = hdr_bits // 8 + (bits2 + 7) // 8 > stored_size(i)
        results.append(finish_stream(hdr, hdr_bits, spliced, bits2, int(adler_np[i]),
                                     int(lengths[i]), raw=raw(i) if fallback else None))
    return results
