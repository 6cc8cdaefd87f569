"""Fused L1/L3 encode kernel (``csrc/encode_l1.cu``) and its twin.

Replaces the plain path of pyrecode_tpu/ops/pallas_encode.py:encode_l1_pallas
with one capacity, ``out_size``: the TPU kernel's per-sub-row capacity
buckets are VMEM sizes and have no counterpart here.  For frames (B, H, W)
uint16 and a threshold (H, W) uint16:

* mask = frame > threshold (unsigned), residual = frame - threshold;
* bitmap (B, ceil(H*W/8)) uint8, raster order, LSB-first in each byte;
* comp (B, out_size) int32: the foreground residuals in raster order, zeros
  from ``count`` on (a packed stream of an odd count then ends in the same
  byte as the host encoder's); None without values;
* counts (B,) int32; overflow (B,) bool = count > out_size (always False
  without values).

``with_values=False`` is L3.

``with_positions=True`` (kernel #1a, the ``with_positions`` output of the
TPU kernel, pallas_encode.py:342,400) adds a fifth output, pos (B,
out_size) int32: the pixel index of each stored value within its frame, at
the value's rank, zeros from ``count`` on.  ``pos_vbits`` > 0 then masks
the stored values to their low ``pos_vbits`` bits, as the TPU kernel does
(the scheme-12 symbol alphabet needs it; the packed stream keeps exactly
those bits anyway).

``pairs_out`` > 0 (kernel #1b, the ``pairs_out`` output of the TPU kernel,
pallas_encode.py:572-600) adds two outputs, with or without values: pairs
(B, pairs_out) int32, ``(byte_index << 8) | byte_value`` of every nonzero
byte of the frame's bitmap in ascending byte order, zeros from the count on
(the input of :func:`.hopper_tokens.tokens_from_pairs`); and pair_counts
(B,) int32.  The overflow flag then also says pair_count > pairs_out.  It
cannot be combined with ``with_positions``.  Against the TPU kernel: the
counts stay exact on overflow (the TPU clamps its running offset at the
capacity), the flag is raised at exactly ``pairs_out`` (the TPU rounds its
capacity up to 128), and there are no per-sub-row capacity buckets.
``pairs_out = out_size`` always suffices when the values do not overflow:
every nonzero byte holds a foreground pixel.
"""

from __future__ import annotations

import torch

from . import _build, _launch
from .bitpack import pack_bits
from .compact import stream_compact

LAUNCHES = _launch.LaunchCounter()
POSITIONS_LAUNCHES = _launch.LaunchCounter()   # the launches that store positions
PAIRS_LAUNCHES = _launch.LaunchCounter()       # the launches that store bitmap-byte pairs
PHASES_LAUNCHES = _launch.LaunchCounter()      # the phase probe's cut-offs (P1)
MAX_PAIR_BYTES = 1 << 23                        # a pair keeps its byte index in 23 bits
PHASES = ("load", "bitmap", "scan", "full")     # encode_l1_phases' cut-offs, in order


def _check(frames: torch.Tensor, threshold: torch.Tensor, with_values: bool = True,
           with_positions: bool = False, pos_vbits: int = 0, pairs_out: int = 0) -> None:
    _launch.require(frames, "frames", torch.uint16, 3)
    _launch.require(threshold, "threshold", torch.uint16, 2)
    if tuple(threshold.shape) != tuple(frames.shape[1:]):
        raise ValueError(f"threshold shape {tuple(threshold.shape)} does not match "
                         f"frames {tuple(frames.shape)}")
    B, H, W = frames.shape
    if H * W >= 1 << 31:
        raise ValueError("frames of 2**31 pixels or more are not supported")
    if not 0 < B < 1 << 16:
        raise ValueError(f"batch must be in 1..65535, got {B}")
    if with_positions and not with_values:
        raise ValueError("with_positions needs with_values")
    if not 0 <= pos_vbits <= 16:
        raise ValueError(f"pos_vbits must be in 0..16, got {pos_vbits}")
    if pairs_out < 0:
        raise ValueError(f"pairs_out must be >= 0, got {pairs_out}")
    if pairs_out and with_positions:
        raise ValueError("pairs_out cannot be combined with with_positions")
    if pairs_out and (H * W + 7) // 8 >= MAX_PAIR_BYTES:
        raise ValueError(f"pairs need bitmaps of fewer than {MAX_PAIR_BYTES} bytes, "
                         f"got {(H * W + 7) // 8}")


def _scratch(B: int, n: int, with_values: bool, pairs: bool, device) -> torch.Tensor:
    """The kernel's int32 scratch: a foreground count a (frame, tile), a
    nonzero-byte count too with pairs, and the staged values of each
    (frame, tile) with values (``pr_encode_scratch_words``)."""
    words = _build.load().pr_encode_scratch_words(B, n, int(with_values), int(pairs))
    return torch.empty(words, dtype=torch.int32, device=device)


def bitmap_pairs(bitmap: torch.Tensor, pairs_out: int):
    """(byte_index << 8) | value of each nonzero byte of bitmaps (B, NB)
    uint8, compacted to (B, pairs_out) int32, and their counts (B,) int32."""
    B, nb = bitmap.shape
    v = bitmap.to(torch.int32)
    index = torch.arange(nb, dtype=torch.int32, device=bitmap.device).reshape(1, nb)
    return stream_compact((index << 8) | v, v != 0, pairs_out)


def encode_l1_plain(frames: torch.Tensor, threshold: torch.Tensor, out_size: int,
                    with_values: bool = True, with_positions: bool = False, pos_vbits: int = 0,
                    pairs_out: int = 0):
    """Plain PyTorch version of :func:`encode_l1`, on any device."""
    _check(frames, threshold, with_values, with_positions, pos_vbits, pairs_out)
    B, H, W = frames.shape
    n = H * W
    f = _launch.u16_to_i32(frames).reshape(B, n)
    t = _launch.u16_to_i32(threshold).reshape(1, n)
    mask = f > t
    counts = mask.sum(dim=1, dtype=torch.int32)
    bitmap = pack_bits(torch.nn.functional.pad(mask.to(torch.uint8), (0, -n % 8)))
    if with_values:
        residual = f - t
        if with_positions and pos_vbits:
            residual = residual & ((1 << pos_vbits) - 1)
        comp = stream_compact(residual, mask, out_size)[0]
        overflow = counts > out_size
    else:
        comp, overflow = None, torch.zeros(B, dtype=torch.bool, device=frames.device)
    if with_positions:
        index = torch.arange(n, dtype=torch.int32, device=frames.device).expand(B, n)
        pos = stream_compact(index, mask, out_size)[0]
        return bitmap, comp, counts, overflow, pos
    if pairs_out:
        pairs, pair_counts = bitmap_pairs(bitmap, pairs_out)
        return bitmap, comp, counts, overflow | (pair_counts > pairs_out), pairs, pair_counts
    return bitmap, comp, counts, overflow


def encode_l1(frames: torch.Tensor, threshold: torch.Tensor, out_size: int,
              with_values: bool = True, with_positions: bool = False, pos_vbits: int = 0,
              pairs_out: int = 0):
    """Returns (bitmap, comp or None, counts, overflow[, pos | , pairs,
    pair_counts]) as described above."""
    _check(frames, threshold, with_values, with_positions, pos_vbits, pairs_out)
    if out_size < 0:
        raise ValueError(f"out_size must be >= 0, got {out_size}")
    if not with_positions:
        pos_vbits = 0
    if _launch.on_host(frames, threshold):
        return encode_l1_plain(frames, threshold, out_size, with_values, with_positions,
                               pos_vbits, pairs_out)
    B, H, W = frames.shape
    n = H * W
    dev = frames.device
    bitmap = torch.empty((B, (n + 7) // 8), dtype=torch.uint8, device=dev)
    comp = torch.empty((B, out_size if with_values else 0), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    scratch = _scratch(B, n, with_values, bool(pairs_out), dev)
    pos = torch.empty_like(comp) if with_positions else None
    if with_positions:
        POSITIONS_LAUNCHES.add()
    pairs = pair_counts = None
    if pairs_out:
        pairs = torch.empty((B, pairs_out), dtype=torch.int32, device=dev)
        pair_counts = torch.empty(B, dtype=torch.int32, device=dev)
        PAIRS_LAUNCHES.add()
    opt = [_launch.ptr(t) if t is not None else None for t in (pos, pairs, pair_counts)]
    _launch.launch(LAUNCHES, "pr_encode_l1", dev,
                   _launch.ptr(frames), _launch.ptr(threshold), _launch.ptr(bitmap),
                   _launch.ptr(comp), _launch.ptr(counts), _launch.ptr(overflow),
                   _launch.ptr(scratch), opt[0], pos_vbits, B, n, out_size, int(with_values),
                   *opt[1:], pairs_out)
    if with_positions:
        return bitmap, comp, counts, overflow, pos
    if pairs_out:
        return bitmap, comp if with_values else None, counts, overflow, pairs, pair_counts
    return bitmap, comp if with_values else None, counts, overflow


def encode_l1_phases_plain(frames: torch.Tensor, threshold: torch.Tensor, out_size: int,
                           with_values: bool = True, stop_after: str = "full"):
    """Plain PyTorch version of :func:`encode_l1_phases`, on any device."""
    _check(frames, threshold, with_values)
    B, H, W = frames.shape
    n = H * W
    n_tiles = -(-n // _launch.TILE_PIXELS)
    if stop_after == "load":
        f = _launch.u16_to_i32(frames).reshape(B, n).to(torch.int64)
        t = _launch.u16_to_i32(threshold).reshape(1, n).to(torch.int64)
        return (_launch.tile_sums(f - t, n_tiles),)
    if stop_after == "full":
        return encode_l1_plain(frames, threshold, out_size, with_values)
    bitmap, _, counts, overflow = encode_l1_plain(frames, threshold, out_size, with_values)
    mask = (_launch.u16_to_i32(frames).reshape(B, n) > _launch.u16_to_i32(threshold).reshape(1, n))
    tiles = _launch.tile_sums(mask.to(torch.int32), n_tiles).to(torch.int32)
    if stop_after == "bitmap":
        return bitmap, tiles
    return bitmap, (torch.cumsum(tiles, dim=1) - tiles).to(torch.int32), counts, overflow


def encode_l1_phases(frames: torch.Tensor, threshold: torch.Tensor, out_size: int,
                     with_values: bool = True, stop_after: str = "full"):
    """The encode cut after one of its passes (PHASES), for the phase probe
    (``pyrecode_tpu_torch.tools.probe_phases``; kernel P1, replacing the
    truncated kernels of tools/probe_phases.py:build_phase_kernel).  Returns

    * "load": (sums (B, n_tiles) int64,), frame - threshold summed over each
      tile of TILE_PIXELS pixels: the dense pass's read alone;
    * "bitmap": (bitmap, tiles (B, n_tiles) int32 foreground counts): the
      dense pass;
    * "scan": (bitmap, tile offsets (B, n_tiles) int32, counts, overflow):
      then the placing kernel's offsets, no value moved;
    * "full": :func:`encode_l1`'s outputs without positions or pairs.
    """
    if stop_after not in PHASES:
        raise ValueError(f"stop_after must be one of {PHASES}, got {stop_after!r}")
    _check(frames, threshold, with_values)
    if out_size < 0:
        raise ValueError(f"out_size must be >= 0, got {out_size}")
    if _launch.on_host(frames, threshold):
        return encode_l1_phases_plain(frames, threshold, out_size, with_values, stop_after)
    B, H, W = frames.shape
    n = H * W
    dev = frames.device
    n_tiles = _launch.num_tiles(n)
    bitmap = torch.empty((B, (n + 7) // 8), dtype=torch.uint8, device=dev)
    comp = torch.empty((B, out_size if with_values else 0), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    tiles = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    sums = torch.empty((B, n_tiles) if stop_after == "load" else (0,), dtype=torch.int64,
                       device=dev)
    scratch = _scratch(B, n, with_values, False, dev)
    _launch.launch(PHASES_LAUNCHES, "pr_encode_l1_phases", dev,
                   _launch.ptr(frames), _launch.ptr(threshold), _launch.ptr(bitmap),
                   _launch.ptr(comp), _launch.ptr(counts), _launch.ptr(overflow),
                   _launch.ptr(tiles), _launch.ptr(sums), _launch.ptr(scratch), B, n, out_size,
                   int(with_values), PHASES.index(stop_after))
    if stop_after == "load":
        return (sums,)
    if stop_after == "bitmap":
        return bitmap, tiles
    if stop_after == "scan":
        return bitmap, tiles, counts, overflow
    return bitmap, comp if with_values else None, counts, overflow
