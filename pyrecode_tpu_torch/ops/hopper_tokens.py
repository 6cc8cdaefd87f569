"""Pairs-driven deflate tokenizer (``csrc/tokens_from_pairs.cu``) and its twin.

Replaces pyrecode_tpu/ops/pallas_tokens.py:tokens_from_pairs_device: the
nonzero bytes of a bitmap as ``(byte_index << 8) | value`` pairs (the
``pairs_out`` output of :func:`.hopper_encode.encode_l1`) become the dense
inverted deflate token stream and its histogram without a pass over the
bitmap's bytes.  The tokens equal the compacted output of
:func:`.hopper_deflate.tokenize_compact` on the same bitmap, and the
contract is ``codecs.dyndeflate.tokens_from_pairs_np``.

Differences from the JAX function:

* no gap limit: the TPU kernel flags a frame with a zero gap of more than
  ``GAP_MAX = 1549`` bytes (its 8 token slots an element); here such a gap
  is tokenized like any other;
* no ``count >= NP`` gate and any number of pairs NP (the TPU needs
  ``NP % 4096 == 0`` and a free pad slot for its tail sentinel);
* the histogram's bins past 285 are 0 (the TPU counts its dead slots in bin
  287);
* the flag is the run gate alone: a nonzero run of 4 or more equal bytes,
  whose tokens the pairs formulation does not model (the caller takes the
  byte tokenizer for that frame, as the JAX docstring prescribes);
* overflow (more tokens than ``tok_bound``) shows in the counts, which stay
  exact, as does the histogram; the caller retries with the exact bound.

Adler32 is a closed form over the pairs (A = 1 + sum v, B = n + sum (n -
idx) v, mod 65521), which the JAX package computes at the XLA level; here
the kernel's count pass sums it per tile and its scatter pass adds the
tiles, and :func:`adler_from_pairs` is the plain version's.
"""

from __future__ import annotations

import torch

from . import _build, _launch
from .hopper_deflate import HIST_BINS, LEN_BASE, NO_TOKEN

LAUNCHES = _launch.LaunchCounter()
_ADLER_MOD = 65521


def _check(pairs: torch.Tensor, counts: torch.Tensor, n: int, tok_bound: int) -> None:
    _launch.require(pairs, "pairs", torch.int32, 2)
    _launch.require(counts, "counts", torch.int32, 1)
    B, np_ = pairs.shape
    if counts.shape[0] != B:
        raise ValueError(f"counts has {counts.shape[0]} entries for {B} frames")
    if not 0 < B < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {B}")
    if not 0 <= n < 1 << 31 or np_ >= (1 << 31) - 1:
        raise ValueError(f"n={n} and {np_} pairs a frame must stay below 2**31")
    if tok_bound < 0:
        raise ValueError(f"tok_bound must be >= 0, got {tok_bound}")


def adler_from_pairs(pairs: torch.Tensor, counts: torch.Tensor, n: int) -> torch.Tensor:
    """Adler32 (B,) int64 of the n-byte streams whose nonzero bytes the
    first ``counts`` pairs of each row are."""
    B, np_ = pairs.shape
    live = torch.arange(np_, device=pairs.device).reshape(1, np_) < counts.to(torch.int64).reshape(B, 1)
    p = pairs.to(torch.int64)
    v = torch.where(live, p & 255, 0)
    a = (1 + v.sum(dim=1)) % _ADLER_MOD
    b = (n + ((n - (p >> 8)) * v).sum(dim=1)) % _ADLER_MOD
    return (b << 16) | a


def gap_schedule(G: torch.Tensor):
    """(token count, take-258 matches, remainder) of zero runs of G bytes
    (int64), as ``codecs.dyndeflate.gap_token_count``; no tokens for G <= 0."""
    j258 = torch.where(G >= 262, torch.div(G - 262, 258, rounding_mode="floor") + 1, 0)
    rem = G - 1 - 258 * j258
    count = torch.where(G <= 0, 0, torch.where(G <= 3, G, 1 + j258 + torch.where(rem >= 259, 2, 1)))
    return count, j258, rem


def tokens_from_pairs_plain(pairs: torch.Tensor, counts: torch.Tensor, n: int, tok_bound: int):
    """Plain PyTorch version of :func:`tokens_from_pairs`, on any device:
    each element's tokens expanded by ``repeat_interleave``, then the closed
    forms; no Python loop over elements."""
    _check(pairs, counts, n, tok_bound)
    B, np_ = pairs.shape
    dev = pairs.device
    cnt = counts.to(torch.int64).clamp(0, np_).reshape(B, 1)
    e = torch.arange(np_ + 1, device=dev).reshape(1, np_ + 1)
    p = torch.nn.functional.pad(pairs.to(torch.int64), (0, 1))
    real = e < cnt
    idx = torch.where(real, p >> 8, n)
    val = torch.where(real, p & 255, 0)
    prev = torch.nn.functional.pad(idx[:, :-1], (1, 0), value=-1)
    G = idx - prev - 1
    gc, j258, rem = gap_schedule(G)
    t = torch.where(e <= cnt, gc + (val > 0), 0)

    run = real[:, 1:] & (idx[:, 1:] == idx[:, :-1] + 1) & (val[:, 1:] == val[:, :-1]) & \
        (val[:, 1:] > 0)
    flag = (run[:, 2:] & run[:, 1:-1] & run[:, :-2]).any(dim=1) if np_ >= 3 else \
        torch.zeros(B, dtype=torch.bool, device=dev)

    flat_t = t.reshape(-1)
    total = int(flat_t.sum())
    elem = torch.repeat_interleave(torch.arange(flat_t.numel(), device=dev), flat_t,
                                   output_size=total)
    starts = torch.cumsum(flat_t, 0) - flat_t
    k = torch.arange(total, device=dev)
    j = k - starts[elem]
    row = torch.div(elem, np_ + 1, rounding_mode="floor")
    tok_counts = t.sum(dim=1)
    rank = k - (torch.cumsum(tok_counts, 0) - tok_counts)[row]

    g, jj, rm = G.reshape(-1)[elem], j258.reshape(-1)[elem], rem.reshape(-1)[elem]
    take = torch.where(j <= jj, 258, torch.where(rm >= 259, torch.where(j == jj + 1, 255, rm - 255),
                                                  rm))
    gap_lut = torch.where((g <= 3) | (j == 0), 0, 256 + take - 3)
    lut = torch.where(j < gc.reshape(-1)[elem], gap_lut, val.reshape(-1)[elem])
    base = torch.tensor(LEN_BASE, dtype=torch.int64, device=dev)
    sym = torch.where(lut < 256, lut, 257 + torch.bucketize(lut - 253, base, right=True) - 1)

    tok = torch.zeros((B, tok_bound + 1), dtype=torch.int32, device=dev)
    slot = row * (tok_bound + 1) + torch.where(rank < tok_bound, rank, tok_bound)
    tok.view(-1)[slot] = (NO_TOKEN - lut).to(torch.int32)
    hist = torch.bincount(row * HIST_BINS + sym, minlength=B * HIST_BINS)
    return (tok[:, :tok_bound].contiguous(), hist.reshape(B, HIST_BINS).to(torch.int32),
            tok_counts.to(torch.int32), flag, adler_from_pairs(pairs, counts, n))


def tokens_from_pairs(pairs: torch.Tensor, counts: torch.Tensor, n: int, tok_bound: int):
    """Dense inverted deflate tokens from nonzero-byte pairs.

    ``pairs`` (B, NP) int32 ``(byte_index << 8) | value`` in ascending
    byte order, of which the first ``counts`` (B,) int32 are valid (clamped
    to [0, NP]); ``n`` the byte stream's length, shared by every frame.
    Returns (tokens (B, tok_bound) int32, NO_TOKEN - LUT index, zeros from
    the count on; hist (B, 512) int32, bins 0..285 the literal/length
    symbols, end of block not counted, the rest 0; token counts (B,) int32,
    exact even past tok_bound; flag (B,) bool, a nonzero run of 4 or more
    equal bytes, whose frame needs the byte tokenizer; adler32 (B,) int64).
    """
    _check(pairs, counts, n, tok_bound)
    if _launch.on_host(pairs, counts):
        return tokens_from_pairs_plain(pairs, counts, n, tok_bound)
    B, np_ = pairs.shape
    dev = pairs.device
    tok = torch.empty((B, tok_bound), dtype=torch.int32, device=dev)
    hist = torch.empty((B, HIST_BINS), dtype=torch.int32, device=dev)
    tok_counts = torch.empty(B, dtype=torch.int32, device=dev)
    flag = torch.empty(B, dtype=torch.bool, device=dev)
    adler = torch.empty(B, dtype=torch.int64, device=dev)
    # each tile's token count and adler32 sums, then the overflow bytes of the scan
    tiles = int(_build.load().pr_pairs_tiles(np_))
    scratch = torch.empty(3 * B * tiles + -(-B // 4), dtype=torch.int32, device=dev)
    _launch.launch(LAUNCHES, "pr_tokens_from_pairs", dev,
                   _launch.ptr(pairs), _launch.ptr(counts), _launch.ptr(tok), _launch.ptr(hist),
                   _launch.ptr(tok_counts), _launch.ptr(flag), _launch.ptr(adler),
                   _launch.ptr(scratch), B, np_, n, tok_bound)
    return tok, hist, tok_counts, flag, adler
