"""Deflate tokenize and assemble kernels (``csrc/tokenize.cu``,
``csrc/assemble.cu``) and their plain twins.

The device half of the scheme-0 entropy stage, in place of
pyrecode_tpu/ops/pallas_deflate.py: ``tokenize`` replaces
``tokenize_pallas``, ``tokenize_compact`` replaces
``tokenize_compact_pallas``, ``assemble`` replaces ``assemble_pallas`` and
``assemble_split`` replaces ``assemble_pallas_split`` (the same contract
and bytes by a parallel phase-0 scatter of each tile, then a shift of each
tile into its bit phase).
The token rules are those of pyrecode_tpu/codecs/dyndeflate.py
(``tokenize_bytes_np``); the streams the JAX package's host step finishes
from these outputs are byte-identical to ``native.deflate_sparse``.

Differences from the TPU kernels, none of which changes a byte of output:

* any row width (the TPU kernels need multiples of their 16384-byte and
  4096-token grid steps);
* ``tokenize_compact`` has one capacity, ``out_bound``: the TPU's per-row
  ``TOKEN_BUCKETS`` are VMEM sizes, so overflow here means only that a
  stream has more than ``out_bound`` tokens (the histogram stays exact, and
  the caller retries with the exact bound);
* ``assemble`` and ``assemble_split`` take no scatter-window size: the
  TPU's window presets bound a VMEM matmul and have no counterpart here;
* adler32 comes back as int64, not uint32.

Constants are defined here, not imported: pallas_deflate imports JAX.
"""

from __future__ import annotations

import torch

from . import _build, _launch
from .hopper_encode import encode_l1, encode_l1_plain

NO_TOKEN = 512          # LUT index of "no token"; tokens travel as NO_TOKEN - index
SYM_NONE = 287          # histogram slot of covered and pad bytes
HIST_BINS = 512         # histogram row: (sym >> 5, sym & 31) row-major
MAX_TOKEN_BITS = 21     # literal code <= 15; match = length code 15 + extra 5 + distance 1
MAX_RUN_LOOKAHEAD = 522
TILE = 4096             # bytes (tokenize) or tokens (assemble) per kernel block
LUT_SHAPE = (48, 32)    # values in rows 0..23, bit counts in rows 24..47
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83,
            99, 115, 131, 163, 195, 227, 258)
_ADLER_MOD = 65521
_MAX_COLS = (1 << 31) - 2 * TILE  # positions and bit offsets stay in int32 in the kernels

TOKENIZE_LAUNCHES = _launch.LaunchCounter()
TOKENIZE_COMPACT_LAUNCHES = _launch.LaunchCounter()
ASSEMBLE_LAUNCHES = _launch.LaunchCounter()
ASSEMBLE_SPLIT_LAUNCHES = _launch.LaunchCounter()


def _check_streams(streams: torch.Tensor, lengths: torch.Tensor) -> None:
    _launch.require(streams, "streams", torch.uint8, 2)
    _launch.require(lengths, "lengths", torch.int32, 1)
    B, npad = streams.shape
    if lengths.shape[0] != B:
        raise ValueError(f"lengths has {lengths.shape[0]} entries for {B} streams")
    if not 0 < B < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {B}")
    if npad > _MAX_COLS:
        raise ValueError(f"streams of {npad} bytes are too long (at most {_MAX_COLS})")


# ------------------------------------------------------------------ tokenize


def _tokenize_tiles(npad: int) -> int:
    """Tiles of the tokenize kernels for rows of npad bytes."""
    return int(_build.load().pr_tokenize_tiles(npad))


def tokenize_plain(streams: torch.Tensor, lengths: torch.Tensor):
    """Plain PyTorch version of :func:`tokenize`, on any device."""
    _check_streams(streams, lengths)
    B, npad = streams.shape
    dev = streams.device
    x = streams.to(torch.int32)
    n = lengths.to(torch.int32).clamp(0, npad).reshape(B, 1)
    i = torch.arange(npad, dtype=torch.int32, device=dev).reshape(1, npad)
    valid = i < n
    differs = x != torch.nn.functional.pad(x[:, :-1], (1, 0), value=-1)
    # run start: the last change at or before i; run end: the first change
    # (or stream end) after i
    s = torch.cummax(torch.where(differs, i, -1), dim=1).values
    cand = torch.where(differs | ~valid, i, npad)
    first_after = torch.flip(torch.cummin(torch.flip(cand, [1]), dim=1).values, [1])
    e = torch.nn.functional.pad(first_after[:, 1:], (0, 1), value=npad)

    p = i - s
    d = (e - i).clamp(max=MAX_RUN_LOOKAHEAD)
    is_lit = (p == 0) | (e - s < 4)
    qm = torch.remainder(p - 1, 258)
    take0 = torch.where(d >= 261, 258, torch.where(d >= 259, 255, d))
    m255 = (qm == 255) & ((d == 4) | (d == 5))
    take = torch.where(m255, d, take0)
    is_match = ~is_lit & (((qm == 0) & (d >= 3)) | m255)
    lut = torch.where(is_lit, x, torch.where(is_match, 256 + take - 3, NO_TOKEN))
    lut = torch.where(valid, lut, NO_TOKEN)
    base = torch.tensor(LEN_BASE, dtype=torch.int32, device=dev)
    code = torch.bucketize(take, base, right=True) - 1
    sym = torch.where(is_lit, x, torch.where(is_match, 257 + code, SYM_NONE))
    sym = torch.where(valid, sym, SYM_NONE).to(torch.int64)
    hist = torch.zeros((B, HIST_BINS), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, sym, torch.ones_like(sym, dtype=torch.int32))

    xm = torch.where(valid, x, 0).to(torch.int64)
    s1 = xm.sum(dim=1)
    s2 = (xm * i.to(torch.int64)).sum(dim=1)
    n64 = n.reshape(B).to(torch.int64)
    a = (1 + s1) % _ADLER_MOD
    b = (n64 + n64 * s1 - s2) % _ADLER_MOD
    tok = _launch.i32_to_u16(NO_TOKEN - lut)
    return tok, hist, (b << 16) | a


def tokenize(streams: torch.Tensor, lengths: torch.Tensor):
    """Per-byte tokens, histogram and adler32 of a batch of byte streams.

    ``streams`` (B, NPAD) uint8, ``lengths`` (B,) int32 valid bytes (clamped
    to [0, NPAD]), both on one device.  Returns (tok (B, NPAD) uint16, the
    inverted tokens NO_TOKEN - LUT index: 1..512 a token, 0 a covered or pad
    byte; hist (B, 512) int32, (sym >> 5, sym & 31) row-major, end of block
    not counted, slot 287 the covered and pad bytes; adler (B,) int64).
    """
    _check_streams(streams, lengths)
    if _launch.on_host(streams, lengths):
        return tokenize_plain(streams, lengths)
    B, npad = streams.shape
    dev = streams.device
    tok = torch.empty((B, npad), dtype=torch.uint16, device=dev)
    hist = torch.empty((B, HIST_BINS), dtype=torch.int32, device=dev)
    adler = torch.empty(B, dtype=torch.int64, device=dev)
    # each tile's last run start and adler32 sums
    scratch = torch.empty(3 * B * _tokenize_tiles(npad), dtype=torch.int32, device=dev)
    _launch.launch(TOKENIZE_LAUNCHES, "pr_tokenize", dev,
                   _launch.ptr(streams), _launch.ptr(lengths), _launch.ptr(tok),
                   _launch.ptr(hist), _launch.ptr(adler), _launch.ptr(scratch), B, npad)
    return tok, hist, adler


def _as_frames(tok: torch.Tensor):
    """Inverted tokens (B, N) uint16 as B frames of 1 x N and a zero
    threshold: the L1 encode's foreground values are then the tokens."""
    B, npad = tok.shape
    zero = torch.zeros((1, npad), dtype=torch.int16, device=tok.device).view(torch.uint16)
    return tok.reshape(B, 1, npad), zero


def tokenize_compact_plain(streams: torch.Tensor, lengths: torch.Tensor, out_bound: int):
    """Plain PyTorch version of :func:`tokenize_compact`, on any device."""
    tok, hist, adler = tokenize_plain(streams, lengths)
    _, comp, counts, overflow = encode_l1_plain(*_as_frames(tok), out_bound)
    return comp, hist, adler, counts, overflow


def tokenize_compact(streams: torch.Tensor, lengths: torch.Tensor, out_bound: int):
    """:func:`tokenize` with the tokens compacted on the way out.

    Returns (comp (B, out_bound) int32, each stream's inverted tokens in
    order and zeros after them; hist and adler as :func:`tokenize`; counts
    (B,) int32 tokens per stream; overflow (B,) bool, count > out_bound, in
    which case comp holds the first out_bound tokens).
    """
    _check_streams(streams, lengths)
    if out_bound < 0:
        raise ValueError(f"out_bound must be >= 0, got {out_bound}")
    if _launch.on_host(streams, lengths):
        return tokenize_compact_plain(streams, lengths, out_bound)
    B, npad = streams.shape
    dev = streams.device
    comp = torch.empty((B, out_bound), dtype=torch.int32, device=dev)
    hist = torch.empty((B, HIST_BINS), dtype=torch.int32, device=dev)
    adler = torch.empty(B, dtype=torch.int64, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    tiles = _tokenize_tiles(npad)
    scratch = torch.empty(3 * B * tiles, dtype=torch.int32, device=dev)
    status = torch.empty(B * tiles + 1, dtype=torch.int64, device=dev)   # a word a tile, a ticket
    _launch.launch(TOKENIZE_COMPACT_LAUNCHES, "pr_tokenize_compact", dev,
                   _launch.ptr(streams), _launch.ptr(lengths), _launch.ptr(comp),
                   _launch.ptr(hist), _launch.ptr(adler), _launch.ptr(counts),
                   _launch.ptr(overflow), _launch.ptr(scratch), _launch.ptr(status), B, npad,
                   out_bound)
    return comp, hist, adler, counts, overflow


def compact_tokens(tok: torch.Tensor, tok_bound: int):
    """Squeeze the covered slots out of :func:`tokenize`'s token stream.

    As pyrecode_tpu/ops/pallas_deflate.py:compact_tokens, through the L1
    encode kernel with a zero threshold: the inverted tokens (B, NPAD)
    uint16 are frames whose foreground values are the tokens.  Returns
    (comp (B, tok_bound) int32, counts (B,) int32, overflow (B,) bool).
    """
    _launch.require(tok, "tok", torch.uint16, 2)
    _, comp, counts, overflow = encode_l1(*_as_frames(tok), tok_bound)
    return comp, counts, overflow


# ------------------------------------------------------------------ assemble


def _check_assemble(tok, lut, phase, partial, out_bound):
    if tok.dtype not in (torch.uint16, torch.int32):
        raise TypeError(f"tok must be uint16 or int32, got {tok.dtype}")
    _launch.require(tok, "tok", tok.dtype, 2)
    _launch.require(lut, "lut", torch.float32, 3)
    _launch.require(phase, "phase", torch.int32, 1)
    _launch.require(partial, "partial", torch.int32, 1)
    B, ncols = tok.shape
    if tuple(lut.shape) != (B, *LUT_SHAPE):
        raise ValueError(f"lut must be ({B}, 48, 32), got {tuple(lut.shape)}")
    if phase.shape[0] != B or partial.shape[0] != B:
        raise ValueError("phase and partial need one entry per stream")
    if not 0 < B < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {B}")
    if ncols * MAX_TOKEN_BITS >= _MAX_COLS:
        raise ValueError(f"{ncols} tokens per stream are too many")
    if out_bound < 0:
        raise ValueError(f"out_bound must be >= 0, got {out_bound}")
    return -(-out_bound // 128) * 128


def assemble_plain(tok, lut, phase, partial, out_bound: int):
    """Plain PyTorch version of :func:`assemble`, on any device."""
    out_bound = _check_assemble(tok, lut, phase, partial, out_bound)
    B = tok.shape[0]
    inv = _launch.u16_to_i32(tok) if tok.dtype == torch.uint16 else tok
    is_tok = (inv >= 1) & (inv <= NO_TOKEN)
    idx = torch.where(is_tok, NO_TOKEN - inv, 0).to(torch.int64)
    flat = lut.reshape(B, -1)
    val = torch.where(is_tok, torch.gather(flat, 1, idx).to(torch.int64), 0)
    bits = torch.where(is_tok, torch.gather(flat, 1, idx + 768).to(torch.int64), 0)
    ph = phase.to(torch.int64).reshape(B, 1)
    off = ph + torch.cumsum(bits, dim=1) - bits
    shifted = val << (off & 7)
    body = torch.zeros((B, out_bound + 1), dtype=torch.int64, device=tok.device)
    for k in range(4):
        target = (off >> 3) + k
        body.scatter_add_(1, torch.where(target < out_bound, target, out_bound),
                          (shifted >> (8 * k)) & 255)
    body = body[:, :out_bound]
    if out_bound:
        body[:, 0] |= partial.to(torch.int64) & 255
    total = ph.reshape(B) + bits.sum(dim=1)
    return body.to(torch.uint8), total.to(torch.int32), (total + 7) // 8 > out_bound


def assemble(tok: torch.Tensor, lut: torch.Tensor, phase: torch.Tensor, partial: torch.Tensor,
             out_bound: int):
    """Pack inverted tokens into the LSB-first body of a dynamic block.

    ``tok`` (B, N) uint16 or int32 inverted tokens (0 = no token), as
    :func:`tokenize`, :func:`tokenize_compact` or :func:`compact_tokens`
    give them; ``lut`` (B, 48, 32) float32 as
    ``codecs.dyndeflate.luts_as_radix`` and ``native.entropy_host_tables``
    lay it out; ``phase`` (B,) int32 the header's trailing bit count and
    ``partial`` (B,) int32 its trailing partial byte.  Returns (body (B,
    out_bound rounded up to a multiple of 128) uint8, starting at the
    header's partial byte; total bits (B,) int32, phase included; overflow
    (B,) bool, the body needs more than the rounded out_bound bytes).
    """
    out_rounded = _check_assemble(tok, lut, phase, partial, out_bound)
    if _launch.on_host(tok, lut, phase, partial):
        return assemble_plain(tok, lut, phase, partial, out_bound)
    B, ncols = tok.shape
    dev = tok.device
    body = torch.empty((B, out_rounded), dtype=torch.uint8, device=dev)
    totbits = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    tile_bits = torch.empty((B, _launch.deflate_tiles(ncols)), dtype=torch.int32, device=dev)
    _launch.launch(ASSEMBLE_LAUNCHES, "pr_assemble", dev,
                   _launch.ptr(tok), int(tok.dtype == torch.int32), _launch.ptr(lut),
                   _launch.ptr(phase), _launch.ptr(partial), _launch.ptr(body),
                   _launch.ptr(totbits), _launch.ptr(overflow), _launch.ptr(tile_bits),
                   B, ncols, out_rounded)
    return body, totbits, overflow


def assemble_split(tok: torch.Tensor, lut: torch.Tensor, phase: torch.Tensor,
                   partial: torch.Tensor, out_bound: int):
    """:func:`assemble` by the split form: each TILE of tokens is scattered
    at bit phase 0 into its own window, then every window is shifted into
    its phase and placed in the body.  Same arguments, outputs and bytes;
    its twin is :func:`assemble_plain`."""
    out_rounded = _check_assemble(tok, lut, phase, partial, out_bound)
    if _launch.on_host(tok, lut, phase, partial):
        return assemble_plain(tok, lut, phase, partial, out_bound)
    B, ncols = tok.shape
    dev = tok.device
    tiles = _launch.deflate_tiles(ncols)
    body = torch.empty((B, out_rounded), dtype=torch.uint8, device=dev)
    totbits = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    tile_bits = torch.empty((B, tiles), dtype=torch.int32, device=dev)
    windows = torch.empty((B, tiles, int(_build.load().pr_split_window_words())),
                          dtype=torch.int32, device=dev)
    _launch.launch(ASSEMBLE_SPLIT_LAUNCHES, "pr_assemble_split", dev,
                   _launch.ptr(tok), int(tok.dtype == torch.int32), _launch.ptr(lut),
                   _launch.ptr(phase), _launch.ptr(partial), _launch.ptr(body),
                   _launch.ptr(totbits), _launch.ptr(overflow), _launch.ptr(tile_bits),
                   _launch.ptr(windows), B, ncols, out_rounded)
    return body, totbits, overflow
