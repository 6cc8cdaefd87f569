"""Interleaved-rANS kernels of scheme 12 and their twins.

* :func:`rans_hist` (``csrc/rans_hist.cu``) replaces
  pyrecode_tpu/ops/pallas_rans.py:hist_symbols_pallas: (B, NPAD) int32
  symbols and counts m (B,) -> (B, 4096) int32 histograms; entries at or
  beyond m, and symbols outside 0..4095, count nowhere.
* :func:`rans_encode` (``csrc/rans_encode.cu``) replaces
  rans_encode_symbols_pallas, groups 1 and 8: the contract of
  codecs/rans.py:rans_encode_interleaved at nways = 1024 * groups.  It takes
  the frequency table and its prefix (``cum``), not the TPU's radix LUT.
  A call is a chain pass (each lane's states and bytes, a thread a lane)
  and a placing pass (each row's bytes at their place, the zeros after
  the count); a step divides by the symbol's exact reciprocal
  (:func:`rans_encode_state` exposes that update for the tests).
* :func:`rans_encode_tokens` (the same source, token mode) replaces
  rans_encode_pallas: the byte-mode encode of deflate tokens, the contract
  of rans_encode_interleaved(_token_syms_and_extras(lut_idx)[0], freq,
  1024), with the same table layout (the 286-symbol alphabet in front).
* :func:`rans_decode` (``csrc/rans_decode.cu``) replaces rans_decode_pallas,
  groups 1 and 8: the contract of rans_decode_interleaved.  It takes the
  (3, 4096) slot table of :func:`decode_tables`.

The TPU kernels' radix LUTs, f32 division ladder, one-hot emit matmuls and
narrow fetch window with its rerun are Mosaic workarounds with no
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, _launch
from .hopper_deflate import LEN_BASE, NO_TOKEN

W_LANES = 1024             # interleaved states per group (format log2_nways = 10)
GROUPS = (1, 8)            # nways 1024 and 8192
ALPHABET = 4096
PROB_BITS = 12
RANS_L = 1 << 23
# symbol of each token index: literals 0..255, then 257 + the length code of take = idx - 253
TOKEN_SYMBOL = tuple(range(256)) + tuple(
    257 + sum(base <= idx - 253 for base in LEN_BASE) - 1 for idx in range(256, NO_TOKEN))

HIST_LAUNCHES = _launch.LaunchCounter()
ENCODE_LAUNCHES = _launch.LaunchCounter()
ENCODE_TOKENS_LAUNCHES = _launch.LaunchCounter()
ENCODE_STATE_LAUNCHES = _launch.LaunchCounter()
DECODE_LAUNCHES = _launch.LaunchCounter()

_U32 = 0xFFFFFFFF


def _check_groups(groups: int) -> int:
    if groups not in GROUPS:
        raise ValueError(f"groups must be 1 or 8, got {groups}")
    return groups * W_LANES


def _check_counts(m: torch.Tensor, batch: int, name: str = "m") -> None:
    _launch.require(m, name, torch.int32, 1)
    if m.shape[0] != batch:
        raise ValueError(f"{name} has {m.shape[0]} entries for a batch of {batch}")


# ------------------------------------------------------------------ histogram


def rans_hist_plain(values: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`rans_hist`, on any device."""
    B, npad = values.shape
    idx = torch.arange(npad, device=values.device)
    live = (idx[None, :] < m[:, None].to(torch.int64)) & (values >= 0) & (values < ALPHABET)
    rows = torch.arange(B, device=values.device)[:, None] * ALPHABET
    flat = (rows + values.to(torch.int64))[live]
    hist = torch.zeros(B * ALPHABET, dtype=torch.int32, device=values.device)
    hist.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist.reshape(B, ALPHABET)


def rans_hist(values: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, NPAD) int32 symbols, m (B,) int32 -> (B, 4096) int32 histograms."""
    _launch.require(values, "values", torch.int32, 2)
    _check_counts(m, values.shape[0])
    if _launch.on_host(values, m):
        return rans_hist_plain(values, m)
    B, npad = values.shape
    if B >= 1 << 16:
        raise ValueError(f"at most 65535 streams a call, got {B}")
    hist = torch.empty((B, ALPHABET), dtype=torch.int32, device=values.device)
    _launch.launch(HIST_LAUNCHES, "pr_rans_hist", values.device, _launch.ptr(values),
                   _launch.ptr(m), _launch.ptr(hist), B, npad)
    return hist


# --------------------------------------------------------------------- encode


def _check_tables(tok, freq, cum, m, out_bound) -> int:
    """Checks the encode's arguments; returns the largest m (0 for no
    streams), read back from the device as one copy of m."""
    B = tok.shape[0]
    _launch.require(freq, "freq", torch.int32, 2)
    _launch.require(cum, "cum", torch.int32, 2)
    _check_counts(m, B)
    for t, name in ((freq, "freq"), (cum, "cum")):
        if tuple(t.shape) != (B, ALPHABET):
            raise ValueError(f"{name} must be ({B}, {ALPHABET}), got {tuple(t.shape)}")
    if out_bound < 0:
        raise ValueError(f"out_bound must be >= 0, got {out_bound}")
    m_max = int(m.cpu().max()) if B else 0
    if m_max > tok.shape[1]:
        raise ValueError(f"m ({m_max}) exceeds the {tok.shape[1]} symbols given")
    return m_max


def _check_encode(values, freq, cum, m, out_bound, groups):
    """Checks the arguments; returns nways and the largest m."""
    _launch.require(values, "values", torch.int32, 2)
    m_max = _check_tables(values, freq, cum, m, out_bound)
    return _check_groups(groups), m_max


def _encode_outputs(B: int, out_bound: int, m_max: int, nways: int, dev):
    """The kernels' body, states, counts and scratch, and the scratch's rows
    (the longest stream's rows of nways symbols)."""
    rows = -(-m_max // nways)
    words = _build.load().pr_rans_encode_scratch_words(B, rows, nways)
    return (torch.empty((B, out_bound), dtype=torch.uint8, device=dev),
            torch.empty((B, nways), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(words, dtype=torch.int32, device=dev), rows)


def _encode_rows(f_pos, c_pos, m, out_bound: int, nways: int):
    """The rows of codecs/rans.py:rans_encode_interleaved, vectorized over
    lanes, from each position's frequency and cum (B, N) int64."""
    B = f_pos.shape[0]
    dev = f_pos.device
    body = torch.zeros((B, out_bound), dtype=torch.uint8, device=dev)
    states = torch.empty((B, nways), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    for b in range(B):
        mb = int(m[b])
        x = torch.full((nways,), RANS_L, dtype=torch.int64, device=dev)
        chunks = []
        last = (mb - 1) // nways * nways if mb > 0 else -1
        for row0 in range(last, -1, -nways):
            w = min(nways, mb - row0)
            f, c = f_pos[b, row0:row0 + w], c_pos[b, row0:row0 + w]
            xr, xmax = x[:w], f << 19
            e0 = xr >= xmax
            x1 = torch.where(e0, xr >> 8, xr)
            e1 = e0 & (x1 >= xmax)
            x2 = torch.where(e1, x1 >> 8, x1)
            # descending lanes, low byte first per lane
            pairs = torch.stack([xr & 0xFF, x1 & 0xFF], dim=1).flip(0)
            keep = torch.stack([e0, e1], dim=1).flip(0)
            chunks.append(pairs[keep])
            x[:w] = ((x2 // f) << PROB_BITS) + x2 % f + c
        data = torch.cat(chunks) if chunks else torch.zeros(0, dtype=torch.int64, device=dev)
        counts[b] = data.numel()
        kept = data[:out_bound]
        body[b, :kept.numel()] = kept.to(torch.uint8)
        states[b] = x.to(torch.int32)
    return body, states, counts


def rans_encode_plain(values, freq, cum, m, out_bound: int, groups: int = 1):
    """Plain PyTorch version of :func:`rans_encode`, on any device: the rows
    of codecs/rans.py:rans_encode_interleaved, vectorized over lanes."""
    nways, _ = _check_encode(values, freq, cum, m, out_bound, groups)
    s = values.to(torch.int64) & (ALPHABET - 1)
    f_pos = torch.gather(freq.to(torch.int64).clamp(min=1), 1, s)
    c_pos = torch.gather(cum.to(torch.int64), 1, s)
    return _encode_rows(f_pos, c_pos, m, out_bound, nways)


def rans_encode(values: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor, m: torch.Tensor,
                out_bound: int, groups: int = 1):
    """Interleaved-rANS encode of each stream's first m symbols.

    values (B, NPAD) int32 symbols < 4096; freq (B, 4096) int32 quantized
    frequencies (sum 4096) and cum (B, 4096) int32 their exclusive prefix;
    m (B,) int32.  Returns (body (B, out_bound) uint8 in emit order, states
    (B, 1024 * groups) int32, counts (B,) int32 body bytes).  A count above
    ``out_bound`` means the body did not fit (bytes past it are dropped).
    """
    nways, m_max = _check_encode(values, freq, cum, m, out_bound, groups)
    if _launch.on_host(values, freq, cum, m):
        return rans_encode_plain(values, freq, cum, m, out_bound, groups)
    B, npad = values.shape
    dev = values.device
    body, states, counts, scratch, rows = _encode_outputs(B, out_bound, m_max, nways, dev)
    if B:
        _launch.launch(ENCODE_LAUNCHES, "pr_rans_encode", dev, _launch.ptr(values),
                       _launch.ptr(freq), _launch.ptr(cum), _launch.ptr(m), _launch.ptr(body),
                       _launch.ptr(states), _launch.ptr(counts), _launch.ptr(scratch), B, npad,
                       rows, out_bound, groups)
    return body, states, counts


def _check_tokens(tok, freq, cum, m, out_bound) -> int:
    """Checks the arguments; returns the largest m."""
    if tok.dtype not in (torch.uint16, torch.int32):
        raise TypeError(f"tok must be uint16 or int32, got {tok.dtype}")
    _launch.require(tok, "tok", tok.dtype, 2)
    return _check_tables(tok, freq, cum, m, out_bound)


def rans_encode_tokens_plain(tok, freq, cum, m, out_bound: int):
    """Plain PyTorch version of :func:`rans_encode_tokens`, on any device:
    each token's symbol as codecs/rans.py:_token_syms_and_extras maps it,
    then the rows of :func:`rans_encode_plain`."""
    _check_tokens(tok, freq, cum, m, out_bound)
    dev = tok.device
    inv = _launch.u16_to_i32(tok) if tok.dtype == torch.uint16 else tok
    idx = NO_TOKEN - inv.to(torch.int64)
    is_tok = (idx >= 0) & (idx < NO_TOKEN)
    sym = torch.tensor(TOKEN_SYMBOL, dtype=torch.int64, device=dev)[idx.clamp(0, NO_TOKEN - 1)]
    f_pos = torch.where(is_tok, torch.gather(freq.to(torch.int64).clamp(min=1), 1, sym), 1)
    c_pos = torch.where(is_tok, torch.gather(cum.to(torch.int64), 1, sym), 0)
    return _encode_rows(f_pos, c_pos, m, out_bound, W_LANES)


def rans_encode_tokens(tok: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                       m: torch.Tensor, out_bound: int):
    """Byte-mode interleaved-rANS encode of each stream's first m tokens.

    ``tok`` (B, N) uint16 or int32 inverted deflate tokens (index =
    NO_TOKEN - tok, pad 0), as hopper_deflate.tokenize / compact_tokens
    give them; index < 256 is literal symbol index, 256 <= index < 512 a
    match of take index - 253 and symbol 257 + its length code; any other
    index codes as frequency 1, cum 0.  freq and cum (B, 4096) int32 as
    :func:`rans_encode` takes them, the 286-symbol alphabet in front; m (B,)
    int32.  Returns (body (B, out_bound) uint8 in emit order, states (B,
    1024) int32, counts (B,) int32 body bytes; above ``out_bound`` the body
    did not fit and bytes past it are dropped).
    """
    m_max = _check_tokens(tok, freq, cum, m, out_bound)
    if _launch.on_host(tok, freq, cum, m):
        return rans_encode_tokens_plain(tok, freq, cum, m, out_bound)
    B, npad = tok.shape
    dev = tok.device
    body, states, counts, scratch, rows = _encode_outputs(B, out_bound, m_max, W_LANES, dev)
    if B:
        _launch.launch(ENCODE_TOKENS_LAUNCHES, "pr_rans_encode_tokens", dev, _launch.ptr(tok),
                       int(tok.dtype == torch.int32), _launch.ptr(freq), _launch.ptr(cum),
                       _launch.ptr(m), _launch.ptr(body), _launch.ptr(states),
                       _launch.ptr(counts), _launch.ptr(scratch), B, npad, rows, out_bound)
    return body, states, counts


def rans_encode_state_plain(x, freq, cum):
    """Plain PyTorch version of :func:`rans_encode_state`, on any device."""
    xs = x.to(torch.int64) & _U32
    f = freq.to(torch.int64).clamp(min=1)
    out = ((xs // f) << PROB_BITS) + xs % f + cum.to(torch.int64)
    return (out & _U32).to(torch.int32)   # the u32 state's bits


def rans_encode_state(x: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """The state update of one encode step, x -> (x / f << 12) + x % f +
    cum, as the encode kernels compute it (by a reciprocal, without a
    division): x (n,) int32 holding u32 states below 2^31, freq and cum
    (n,) int32 of at most 4096 (f = 0 codes as 1).  Returns (n,) int32
    holding the u32 results.  For tests that hold the reciprocal against
    the division."""
    for t, name in ((x, "x"), (freq, "freq"), (cum, "cum")):
        _launch.require(t, name, torch.int32, 1)
    if not x.shape == freq.shape == cum.shape:
        raise ValueError(f"x, freq and cum differ in shape: {x.shape}, {freq.shape}, {cum.shape}")
    if _launch.on_host(x, freq, cum):
        return rans_encode_state_plain(x, freq, cum)
    out = torch.empty_like(x)
    _launch.launch(ENCODE_STATE_LAUNCHES, "pr_rans_encode_state", x.device, _launch.ptr(x),
                   _launch.ptr(freq), _launch.ptr(cum), _launch.ptr(out), x.numel())
    return out


# --------------------------------------------------------------------- decode


def decode_tables(freq: np.ndarray) -> np.ndarray:
    """(3, 4096) int32 slot table of a stream's frequencies (sum 4096): per
    slot its symbol, that symbol's frequency and slot - cum(symbol)."""
    freq = np.asarray(freq, np.int64)
    cum = np.zeros(freq.size + 1, np.int64)
    cum[1:] = np.cumsum(freq)
    slot2sym = np.repeat(np.arange(freq.size), freq)
    if slot2sym.size != ALPHABET:
        raise ValueError("TPU-rANS stream corrupt (frequency table)")
    return np.stack([slot2sym, freq[slot2sym],
                     np.arange(ALPHABET) - cum[slot2sym]]).astype(np.int32)


def _check_decode(body_rev, blen, states, m, tables, npad, groups):
    nways = _check_groups(groups)
    _launch.require(body_rev, "body_rev", torch.uint8, 2)
    _launch.require(states, "states", torch.int32, 2)
    _launch.require(tables, "tables", torch.int32, 3)
    B = body_rev.shape[0]
    _check_counts(blen, B, "blen")
    _check_counts(m, B)
    if tuple(states.shape) != (B, nways):
        raise ValueError(f"states must be ({B}, {nways}), got {tuple(states.shape)}")
    if tuple(tables.shape) != (B, 3, ALPHABET):
        raise ValueError(f"tables must be ({B}, 3, {ALPHABET}), got {tuple(tables.shape)}")
    if npad < 0:
        raise ValueError(f"npad must be >= 0, got {npad}")


def rans_decode_plain(body_rev, blen, states, m, tables, npad: int, groups: int = 1):
    """Plain PyTorch version of :func:`rans_decode`, on any device: the rows
    of codecs/rans.py:rans_decode_interleaved, vectorized over lanes."""
    _check_decode(body_rev, blen, states, m, tables, npad, groups)
    nways = groups * W_LANES
    B, width = body_rev.shape
    dev = body_rev.device
    syms = torch.zeros((B, npad), dtype=torch.int32, device=dev)
    underflow = torch.zeros(B, dtype=torch.bool, device=dev)
    for b in range(B):
        mb = int(m[b])
        n_body = min(int(blen[b]), width)
        drev = body_rev[b, :n_body].to(torch.int64)
        sym_t, f_t, rem_t = tables[b].to(torch.int64)
        x = states[b].to(torch.int64) & _U32
        cursor = 0
        for row0 in range(0, mb, nways):
            w = min(nways, mb - row0)
            xr = x[:w]
            slot = xr & (ALPHABET - 1)
            stored = min(w, npad - row0)
            if stored > 0:
                syms[b, row0:row0 + stored] = sym_t[slot[:stored]].to(torch.int32)
            xp = (f_t[slot] * (xr >> PROB_BITS) + rem_t[slot]) & _U32
            take = (xp < RANS_L).to(torch.int64) + (xp < (RANS_L >> 8)).to(torch.int64)
            total = int(take.sum())
            if cursor + total > n_body:
                underflow[b] = True
                break
            at = cursor + torch.cumsum(take, 0) - take
            last = max(n_body - 1, 0)
            b1 = drev[at.clamp(max=last)] if n_body else torch.zeros_like(xp)
            b2 = drev[(at + 1).clamp(max=last)] if n_body else torch.zeros_like(xp)
            x1 = torch.where(take >= 1, ((xp << 8) | b1) & _U32, xp)
            x[:w] = torch.where(take == 2, ((x1 << 8) | b2) & _U32, x1)
            cursor += total
    return syms, underflow


def rans_decode(body_rev: torch.Tensor, blen: torch.Tensor, states: torch.Tensor,
                m: torch.Tensor, tables: torch.Tensor, npad: int, groups: int = 1):
    """Interleaved-rANS decode of each stream's first m symbols.

    body_rev (B, BW) uint8: each stream's body reversed, ``blen`` (B,) int32
    of its bytes valid; states (B, 1024 * groups) int32; m (B,) int32;
    tables (B, 3, 4096) int32 from :func:`decode_tables`.  Returns (syms
    (B, npad) int32, 0 from m on, underflow (B,) bool: the body ran out,
    where the numpy decoder raises; the rows after the one that ran out are
    0).  A stream with m > npad is decoded to its end (for ``underflow``),
    and its symbols at or past npad are not stored.
    """
    _check_decode(body_rev, blen, states, m, tables, npad, groups)
    if _launch.on_host(body_rev, blen, states, m, tables):
        return rans_decode_plain(body_rev, blen, states, m, tables, npad, groups)
    B, width = body_rev.shape
    dev = body_rev.device
    syms = torch.empty((B, npad), dtype=torch.int32, device=dev)
    underflow = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _launch.launch(DECODE_LAUNCHES, "pr_rans_decode", dev, _launch.ptr(body_rev),
                       _launch.ptr(blen), _launch.ptr(states), _launch.ptr(m),
                       _launch.ptr(tables), _launch.ptr(syms), _launch.ptr(underflow), B, width,
                       npad, groups)
    return syms, underflow
