"""Device deflate: scheme-0 zlib streams from the tokenize and assemble kernels.

Port of the device half of pyrecode_tpu/codecs/dyndeflate.py
(``deflate_batch_device``, ``_tables_assemble_finish``) on torch tensors.
Tokens, histograms, adler32 and the bit assembly run on the streams'
device (:mod:`..ops.hopper_deflate`); the host builds each stream's
canonical Huffman tables, block header and token LUT with
``native.entropy_host_tables``, and splices the end-of-block code, the
stored-block fallback and the adler trailer with the JAX package's own
helpers.  Every stream is byte-identical to ``native.deflate_sparse``.

Against the JAX version: no ``interpret`` (a CPU tensor runs the kernels'
twins), no ``compact`` switch (compaction is chosen as the JAX default
chooses it), no environment switches, one token capacity instead of the
TPU's capacity buckets, and one read of all bodies instead of one per
stream.  The native host library is required: without it the JAX
version's three-step table path fails too (``native.dyn_tables`` raises).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyrecode_tpu import native
from pyrecode_tpu.codecs.dyndeflate import finish_stream, quantize_bound, splice_eob, stored_blocks

from ..ops import hopper_deflate as hd


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def deflate_batch_device(streams: torch.Tensor, lengths, raw_cb=None, hint_state=None):
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

    return _tables_assemble_finish(tok, out_bound, hist_np, adler_np, lengths, raw_cb, streams)


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
                               "(pyrecode_tpu.native.available() is False)")
        hdr, hdr_bits, eob_val, eob_len, body_bits[i] = tables
        headers.append((hdr, hdr_bits))
        eobs.append((eob_val, eob_len))
        phases[i] = hdr_bits % 8
        partials[i] = int(hdr[-1]) if hdr_bits % 8 else 0
    return HostTables(luts, phases, partials, headers, eobs, body_bits)


def _tables_assemble_finish(tok, out_bound, hist_np, adler_np, lengths, raw_cb, streams):
    """Host Huffman tables and headers, the early all-stored exit, the bit
    assembly on the device, then the end-of-block splice, the per-stream
    stored fallback and the adler trailer on the host."""
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
    body, totbits, overflow = hd.assemble(
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
