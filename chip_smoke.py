#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. card: name and power limit from nvidia-smi, CUDA version; CUDA required;
2. build: the kernels from pyrecode_tpu_torch/csrc with one nvcc call (sm_90a);
3. kernels vs twins: each kernel against its plain PyTorch twin on the card,
   exactly, at the slice's shapes (4 x 4096^2 frames, ~1% foreground, and the
   streams of that batch: bitmaps and packed values for the deflate
   tokenizer and assembler, gap and value symbols for the rANS histogram,
   encode and decode, positions and values for the positions decode, the
   bitmaps' deflate tokens for the token rANS encode) plus edge cases; one
   frame against the host oracle; every stream deflated on the card against
   native.deflate_sparse, every bitmap coded by the byte-mode
   rans_batch_device against native.rans_compress; CUDA-event times beside each
   kernel's bound and, where one PyTorch call computes the same function,
   that call's time;
4. the scheme-0 slice: ReCoDeServer('batch') with 2 thread-mode nodes on 16
   frames of 4096^2 uint16 (L1, mode 1, scheme 0, 12-bit; device entropy,
   the default on the card) -> merge_parts -> ReCoDeReader.read_frames_dense,
   bit-exact against the data and against the host sparse decode, with
   every kernel of the path launched on the way;
5. entropy paths: one node's part file of the same frames written with
   device entropy and with host entropy, byte-equal, and both write times;
6. the scheme-12 slice: the same server run with compression scheme 12
   (interleaved rANS on the card) -> merge_parts -> read_frames_dense
   through the gap chain and with verify=True, bit-exact; every stream of
   the merged file decoded by the host rans.decompress; for one batch the
   device coders on CUDA tensors equal the same coders on CPU tensors;
7. the L2/L3/L4 slices: the same server run on 16 frames of electron
   puddles (make_puddle_frames) at L2 sum / scheme 12, L4 weighted_average
   / scheme 0 and L3 / scheme 12 -> merge_parts -> read_frames_dense,
   bit-exact against the plain version's bitmaps on every frame and against
   oracle.reduce_frame on two; L2 summary_stats of get_frame equal to the
   oracle's; every scheme-12 stream decoded by the host rans.decompress;
   one L4 part file written with device and with host entropy, byte-equal;
8. the multi-device path on 8 of those frames (L2/L4 on 8 puddle frames):
   pyrecode_tpu_torch.parallel.dryrun_multidevice on a 2 x 1 and a 2 x 2
   mesh (shard_rows) of the one card, every step checked (each frame against
   the unsharded encode, two against oracle.reduce_frame, the entropy steps
   against native.deflate_sparse, the rANS steps' symbols against the host
   tokenizer, rans_batch_device against native.rans_compress, a two-writer
   merge), then two gloo ranks started with the spawn method, each encoding
   its half of the frames on the card, whose gathered blocks must equal one
   process's; every kernel of the path launched by the path's own steps
   (the dryruns count them without the references they are checked against);
9. the alternates path (the JAX package's byte-identical alternatives of
   production kernels) on the 16 L1 frames of phase 4 and the 16 puddle
   frames of phase 7, in batches of 4: encode_l1(pairs_out=) -> the values
   packed as words by bitpack12_words (whose bytes must equal bitpack12's) ->
   the bitmaps tokenized from their nonzero-byte pairs by tokens_from_pairs
   (a frame it flags goes through tokenize_compact) -> host tables ->
   assemble_split, and the values through deflate_batch_device(
   split_assemble=True); every stream equal to native.deflate_sparse and to
   the default path's, each of the four kernels launched, and the path's
   wall beside the default path's.

10. the tools (pyrecode_tpu_torch.tools): the encode and decode phase
   probes at 4 x 4096^2, 1% (each cut-off against its twin, "full" against
   encode_l1 / decode_l1), the butterfly probe (four variants, SUB 512 and
   2048, four densities, each alone and the four in one launch through
   butterfly_all, against the twins and the stable-compaction oracle), the f32-dot
   probe (tf32 / 3xtf32 / fp32 bit for bit against the twins, 3xtf32 and
   fp32 exact) and the eight lowering probes (against numpy and the twins,
   each alone and all eight in one launch through mosaic_all, which is what
   the phase times), each probe's lines printed with the card; then one L1
   scheme-0 writer on the 16 frames of phase 4 without and with
   run(profile_dir=) (equal part files, one Chrome trace) and the device
   busy share from that trace.

11. the modules (run_modules), at 4096^2 uint16, 12-bit, on detector frames
   made on the card from a seed (make_detector_frames): (a) 32 flat-field
   frames written as SEQ (em_reader.write_seq) and calibrated by
   ``python -m pyrecode_tpu_torch calibrate --use_acc`` in a subprocess,
   every threshold file equal to utils.calibration.make_calibration_frames
   on the host (device="cpu"), and pixel_median_std /
   accurate_pixel_thresholds timed on the card beside their byte bounds;
   (b) the CLI's ``server`` (batch, 2 thread nodes, L1, scheme 0, device
   entropy, the accurate threshold file as --calibration_file,
   --validation_frame_gap 4) on 16 SEQ frames, then ``merge`` and ``read``,
   and the merged file read densely, bit-exact against oracle.reduce_frame
   of each frame with that threshold, with every kernel of the path
   launched; (c) ReCoDeServer("batch", isolation="process") with 2 worker
   processes on 4 of the frames, its merged file byte-equal to a thread-mode
   run on the card and no worker with CUDA initialised; (d) ReCoDeViewer
   over (b)'s part files and verify_against_validation_frames on (b)'s
   validation frames.

Phase 6 also writes 8 of the frames as 8-bit values (clipped at 255) at
scheme 12 with one writer and the card's default entropy: both streams on
the device, every stream through the host rans.decompress, the read exact;
then 4 of the frames as an int16 source (signed_frames: negative darks and
background pixels that only a signed comparison leaves out) at schemes 0
and 12 through the server -> merge -> reader, exact against the residuals:
the encode kernels on the sign-flipped frames, then the entropy and decode
kernels, each of the path's kernels launched (run_signed_slices).

Phase 3 also holds the label kernel (all five L2/L4 modes) and the bitmap
-> positions kernel against their twins on a batch of puddle frames, its
bitmaps and statistics streams, and an edge battery, and the four kernels
of phase 9 on the slice batch and their own edge batteries.  The label
kernel's battery includes puddles across its tile borders and frames of
the tile batteries' shapes (label_tile_shapes) and one 1 x 2^20 row; the
positions decode has a span battery (posdecode_span_battery); the rANS
encode step's reciprocal is held against / and % for every f in 1..4096
(state_battery).  The device
operations of one call of the L1 encode (slice), the label kernel, the
positions decode, the three tokenizers (tokenize, tokenize_compact,
tokens_from_pairs, on the slice bitmaps), the rANS decode and encode
(slice gaps), the token rANS encode (slice bitmap tokens) and the bitmap ->
positions kernel (L2/L3 bitmaps) are timed from one profiler trace each
(device_passes); the encode's must be its dense pass and its placing
kernel, the pairs tokenizer's its own three kernels, adler32 included, the
decode's its one kernel, each rANS encode's the copy of m its argument
check reads, its chain pass and its placing pass, and the positions' a
memset and its two kernels.

The bit assembler's two kernels (and the split form's two), the
histogram's one cluster launch and the L1 decode's two kernels are held
the same way, and against their twins on their edge batteries
(assemble_battery, hist_battery, decode_battery).

``python3 chip_smoke.py passes`` prints only the redesigned kernels' times
(kernel_passes, with the probes' probe_passes: P3, P4 and P5 beside their
yardsticks): CUDA-event ms, host ms and the device operations of one call
each.

The last lines are the card, the per-kernel JSON object and the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import cli, native, oracle
from pyrecode_tpu_torch.codecs import dyndeflate, rans
from pyrecode_tpu_torch.codecs.dyndeflate import quantize_bound
from pyrecode_tpu_torch.constants import rc_cfg as rc
from pyrecode_tpu_torch.ops import (_build, _launch, hopper_bitpack, hopper_decode, hopper_deflate,
                                    hopper_encode, hopper_gaps, hopper_label, hopper_probes,
                                    hopper_rans, hopper_tokens)
from pyrecode_tpu_torch.ops.bitpack import bitpack_values, unpack_bits
from pyrecode_tpu_torch.ops.encode import count_foreground, encode_frames_auto
from pyrecode_tpu_torch.profiling import cuda_event_time, trace
from pyrecode_tpu_torch.tools import (probe_butterfly, probe_decode_phases, probe_f32dot,
                                      probe_mosaic, probe_phases)
from pyrecode_tpu_torch.tools._common import HBM_BYTES_PER_S, max_abs_err, sparse_batch
from pyrecode_tpu_torch.em_reader import write_seq
from pyrecode_tpu_torch.utils import calibration
from pyrecode_tpu_torch.utils.validate import verify_against_validation_frames
from pyrecode_tpu_torch.utils.viewer import ReCoDeViewer
from pyrecode_tpu_torch.writer import _bucket_for

REPO = Path(__file__).resolve().parent
SEED = 20261016
EPSILON = 2
OCCUPANCY = 0.01

KERNELS = {
    "encode_l1": ("pyrecode_tpu_torch/csrc/encode_l1.cu", "pyrecode_tpu/ops/pallas_encode.py:760"),
    "bitpack12": ("pyrecode_tpu_torch/csrc/bitpack12.cu", "pyrecode_tpu/ops/pallas_bitpack.py:129"),
    "tokenize": ("pyrecode_tpu_torch/csrc/tokenize.cu", "pyrecode_tpu/ops/pallas_deflate.py:468"),
    "tokenize_compact": ("pyrecode_tpu_torch/csrc/tokenize.cu",
                         "pyrecode_tpu/ops/pallas_deflate.py:443"),
    "assemble": ("pyrecode_tpu_torch/csrc/assemble.cu", "pyrecode_tpu/ops/pallas_deflate.py:951"),
    "bitunpack12": ("pyrecode_tpu_torch/csrc/bitpack12.cu",
                    "pyrecode_tpu/ops/pallas_bitpack.py:178"),
    "decode_l1": ("pyrecode_tpu_torch/csrc/decode_l1.cu", "pyrecode_tpu/ops/pallas_decode.py:269"),
    "rans_hist": ("pyrecode_tpu_torch/csrc/rans_hist.cu", "pyrecode_tpu/ops/pallas_rans.py:809"),
    "rans_encode": ("pyrecode_tpu_torch/csrc/rans_encode.cu",
                    "pyrecode_tpu/ops/pallas_rans.py:319"),
    "rans_encode_tokens": ("pyrecode_tpu_torch/csrc/rans_encode.cu",
                           "pyrecode_tpu/ops/pallas_rans.py:297"),
    "rans_decode": ("pyrecode_tpu_torch/csrc/rans_decode.cu",
                    "pyrecode_tpu/ops/pallas_rans.py:674"),
    "posdecode": ("pyrecode_tpu_torch/csrc/posdecode.cu", "pyrecode_tpu/ops/pallas_decode.py:457"),
    "label_l2l4": ("pyrecode_tpu_torch/csrc/label_l2l4.cu", "pyrecode_tpu/ops/pallas_label.py:459"),
    "bitmap_positions": ("pyrecode_tpu_torch/csrc/bitmap_positions.cu",
                         "pyrecode_tpu/ops/pallas_gaps.py:119"),
    "encode_l1_pairs": ("pyrecode_tpu_torch/csrc/encode_l1.cu",
                        "pyrecode_tpu/ops/pallas_encode.py:760 (pairs_out)"),
    "tokens_from_pairs": ("pyrecode_tpu_torch/csrc/tokens_from_pairs.cu",
                          "pyrecode_tpu/ops/pallas_tokens.py:287"),
    "assemble_split": ("pyrecode_tpu_torch/csrc/assemble.cu",
                       "pyrecode_tpu/ops/pallas_deflate.py:926"),
    "bitpack12_words": ("pyrecode_tpu_torch/csrc/bitpack12.cu",
                        "pyrecode_tpu/ops/pallas_bitpack.py:78"),
    "encode_l1_phases": ("pyrecode_tpu_torch/csrc/encode_l1.cu", "tools/probe_phases.py:152"),
    "decode_l1_phases": ("pyrecode_tpu_torch/csrc/decode_l1.cu",
                         "tools/probe_decode_phases.py:129"),
    "probe_mosaic": ("pyrecode_tpu_torch/csrc/probe_mosaic.cu", "tools/probe_mosaic.py:20,95,114"),
    "probe_f32dot": ("pyrecode_tpu_torch/csrc/probe_f32dot.cu", "tools/probe_f32dot.py:23"),
    "probe_butterfly": ("pyrecode_tpu_torch/csrc/probe_butterfly.cu",
                        "tools/probe_butterfly.py:127"),
}
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate (NVIDIA's data sheet)
# the kernels each slice's main path must launch
SCHEME0_KERNELS = ("encode_l1", "bitpack12", "tokenize", "tokenize_compact", "assemble",
                   "bitunpack12", "decode_l1")
SCHEME12_KERNELS = ("encode_l1", "encode_l1_positions", "bitpack12", "rans_hist", "rans_encode",
                    "bitunpack12", "rans_decode", "posdecode", "decode_l1")
MULTIDEVICE_KERNELS = ("encode_l1", "bitpack12", "label_l2l4", "tokenize", "assemble",
                       "rans_encode_tokens", "rans_decode", "bitunpack12", "decode_l1")
ALTERNATES_KERNELS = ("encode_l1_pairs", "bitpack12_words", "tokens_from_pairs", "assemble_split")
# the int16 source's L1 path: one batch, so no compact tokenizer (it takes the
# density hint of an earlier batch)
SIGNED_SCHEME0_KERNELS = tuple(k for k in SCHEME0_KERNELS if k != "tokenize_compact")
# the device operations of one tokens_from_pairs call ...
TOKENS_FROM_PAIRS_PASSES = ("tfp_count_kernel", "scan_tiles_kernel", "tfp_scatter_kernel")
# ... of one rans_decode call and one bitmap_positions call
RANS_DECODE_PASSES = ("rans_decode_kernel",)
BITMAP_POSITIONS_PASSES = ("gpu_memset", "pos_tile_kernel", "pos_tail_kernel")
# ... and of one encode_l1 call: the dense pass, then the placing and zero-tail kernel
ENCODE_L1_PASSES = ("encode_tile_kernel", "encode_place_kernel")
# ... of one assemble call: the tile counts (and the body's zeros), then the placing
ASSEMBLE_PASSES = ("asm_count_kernel", "asm_place_kernel")
# ... of one assemble_split call: the windows (and the body's zeros), then the placing
ASSEMBLE_SPLIT_PASSES = ("split_par_kernel", "split_cat_kernel")
# ... and of one decode_l1 call: the tile counts, then the expand (offsets included)
DECODE_L1_PASSES = ("decode_count_kernel", "decode_expand_kernel")
# ... of one rans_hist call: one cluster launch
RANS_HIST_PASSES = ("rans_hist_kernel",)
# ... and of one rans_encode or rans_encode_tokens call: the argument check's
# copy of m (m <= npad, and the scratch's rows), the chain pass, the placing
# pass (zeros included)
RANS_ENCODE_PASSES = ("gpu_memcpy", "rans_chain_kernel", "rans_place_kernel")
TOOL_KERNELS = ("encode_l1_phases", "decode_l1_phases", "probe_mosaic", "probe_f32dot",
                "probe_butterfly")
MD_WORLD = 2              # phase 8 (b): gloo ranks, each on the one card
RANK_TIMEOUT_S = 300.0    # phase 8 (b): a rank that runs longer fails the script
ALT_BATCH = 4             # phase 9: frames a batch
CAL_FRAMES = 32           # phase 11 (a): flat-field frames
ACQ_FRAMES = 16           # phase 11 (b): acquisition frames
PROC_FRAMES = 4           # phase 11 (c): frames of the process-isolation run
VALIDATION_GAP = 4        # phase 11 (b): every 4th raw frame is archived
# the kernels of phase 11 (b): the CLI's server (one of the two tokenizers at
# least) and the dense read
MODULES_KERNELS = ("encode_l1", "bitpack12", "assemble", "bitunpack12", "decode_l1")
# (level, L2 statistic or L4 scheme, compression scheme) -> the kernels of that slice
LEVEL_SLICES = {
    (2, "sum", 12): ("label_l2l4", "bitpack12", "bitmap_positions", "rans_hist", "rans_encode",
                     "rans_decode"),
    (4, "weighted_average", 0): ("label_l2l4", "tokenize", "assemble"),
    (3, None, 12): ("encode_l1", "bitmap_positions", "rans_hist", "rans_encode", "rans_decode"),
}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_frames(rng, n: int, height: int, width: int, occupancy: float = OCCUPANCY):
    """Dark frame in 0..31, 12-bit frames whose background stays at or below
    dark + EPSILON and whose ~occupancy foreground lies above it with
    peaked residuals.  Returns (frames (n, h, w) u16, dark (h, w) u16)."""
    dark = rng.integers(0, 32, (height, width), dtype=np.uint16)
    thr = dark + EPSILON
    frames = np.empty((n, height, width), dtype=np.uint16)
    for i in range(n):
        frame = dark + rng.integers(0, EPSILON + 1, (height, width), dtype=np.uint16)
        fg = rng.random((height, width), dtype=np.float32) < occupancy
        vals = thr[fg].astype(np.int64) + 1 + rng.exponential(6.0, int(fg.sum())).astype(np.int64)
        frame[fg] = np.minimum(vals, 4095)
        frames[i] = frame
    return frames, dark


def make_puddle_frames(rng, n: int, height: int, width: int, hits: int = 40000):
    """Dark frame in 0..31 and frames of electron puddles: ``hits`` a
    4096^2 frame (scaled to the frame's area), each its centre pixel plus
    each of its eight neighbours with p = 0.3, so puddles of 1-9 pixels that
    sometimes merge (~1% foreground), whose raw values lie above dark +
    EPSILON with peaked excess; the rest stays at or below it.  Returns
    (frames (n, h, w) u16, dark (h, w) u16)."""
    dark = rng.integers(0, 32, (height, width), dtype=np.uint16)
    thr = dark + EPSILON
    k = max(1, round(hits * height * width / 4096 ** 2))
    frames = np.empty((n, height, width), dtype=np.uint16)
    for i in range(n):
        frame = dark + rng.integers(0, EPSILON + 1, (height, width), dtype=np.uint16)
        r, c = rng.integers(0, height, k), rng.integers(0, width, k)
        fg = np.zeros((height, width), dtype=bool)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                keep = rng.random(k) < (1.0 if dr == dc == 0 else 0.3)
                rr, cc = r[keep] + dr, c[keep] + dc
                ok = (rr >= 0) & (rr < height) & (cc >= 0) & (cc < width)
                fg[rr[ok], cc[ok]] = True
        vals = thr[fg].astype(np.int64) + 1 + rng.exponential(40.0, int(fg.sum())).astype(np.int64)
        frame[fg] = np.minimum(vals, 4095)
        frames[i] = frame
    return frames, dark


def _spiral(height: int, width: int) -> np.ndarray:
    """A one-pixel square spiral with one-pixel gaps between its turns: one
    puddle whose geodesic length is about half the frame's pixels."""
    out = np.zeros((height, width), dtype=bool)
    r = c = d = 0
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))

    def free(y, x):
        return 0 <= y < height and 0 <= x < width and not out[y, x]

    out[0, 0] = True
    while True:
        for turn in range(2):
            dr, dc = steps[(d + turn) % 4]
            y, x = r + dr, c + dc
            if free(y, x) and (not (0 <= y + dr < height and 0 <= x + dc < width)
                               or not out[y + dr, x + dc]):
                d = (d + turn) % 4
                r, c = y, x
                out[r, c] = True
                break
        else:
            return out


def _tile_border_masks(height: int, width: int) -> dict:
    """Puddles across the label kernel's tile borders (hopper_label.TILE_H x
    TILE_W), name -> (h, w) bool, for a frame that has such borders: pairs
    and diagonal pairs across each horizontal and each vertical border, a
    diagonal line through the tiles; and at each corner of four tiles a
    puddle in all four that meets only through diagonal pixels, the corner's
    two diagonals in turn."""
    th, tw = hopper_label.TILE_H, hopper_label.TILE_W
    ys, xs = range(th, height, th), range(tw, width, tw)
    if not ys and not xs:
        return {}
    across = np.zeros((height, width), bool)
    corners = np.zeros((height, width), bool)

    def put(mask, pixels):
        for r, c in pixels:
            if 0 <= r < height and 0 <= c < width:
                mask[r, c] = True

    for y in ys:   # row y is a tile's top row
        for c in range(3, width, 37):
            put(across, [(y - 1, c), (y, c)])                     # N
            put(across, [(y - 1, c + 9), (y, c + 10)])            # NW
            put(across, [(y - 1, c + 21), (y, c + 20)])           # NE
    for x in xs:   # column x is a tile's left column
        for r in range(0, height, 7):
            put(across, [(r, x - 1), (r, x)])                     # W
            put(across, [(r + 2, x - 1), (r + 3, x)])             # NW
            put(across, [(r + 4, x), (r + 5, x - 1)])             # NE of the left tile's column
    k = min(height, width)
    across[np.arange(k), np.arange(k)] = True
    for i, y in enumerate(ys):
        for j, x in enumerate(xs):
            if (i + j) % 2 == 0:   # joined through (y - 1, x - 1) and (y, x)
                put(corners, [(y - 1, x - 1), (y, x), (y - 2, x), (y, x - 2)])
            else:                  # joined through (y - 1, x) and (y, x - 1)
                put(corners, [(y - 1, x), (y, x - 1), (y - 2, x - 1), (y, x + 1)])
    return {"tile borders": across, "tile corners": corners}


def label_tile_shapes() -> dict:
    """The label kernel's tile batteries, name -> (h, w): just over one tile
    in each dimension; 2 x 3 tiles and a ragged edge (W % 8 == 0, so
    16-byte loads, while rows cross mask words); ragged in both (W % 8 !=
    0, the kernel's unaligned path)."""
    th, tw = hopper_label.TILE_H, hopper_label.TILE_W
    return {"just over one tile": (th + 1, tw + 1),
            "2 x 3 tiles and a ragged edge": (2 * th + 5, 3 * tw + 8),
            "ragged in both": (2 * th + 7, 2 * tw + 37)}


def label_edge_frames(rng, height: int, width: int) -> dict:
    """The label kernel's edge battery on a zero threshold, name -> (h, w)
    u16 frame (0 = background): an empty frame; a fully foreground one (one
    puddle, L2 sums saturate), with random and with equal values (L4 max
    takes the first pixel); a 24-row-tall puddle and a 12-pixel line, which
    overflow the TPU kernel's halo; a U whose arms join only at the bottom
    and a comb of them; puddles on every frame edge, including pixels at the
    end of one row and the start of the next (adjacent indices, not
    neighbours); runs over a row's end and the next row's start (across a
    mask word where W % 32 != 0); a stride-2 grid (the most puddles
    8-connectivity allows); a checkerboard (one puddle through diagonals);
    blobs of tied values; at 256^2 and below, a spiral; and, where the frame
    has tile borders of the label kernel, puddles across them
    (_tile_border_masks)."""
    H, W = height, width
    vals = rng.integers(1, 4096, (H, W)).astype(np.uint16)
    frames = {"empty": np.zeros((H, W), np.uint16), "full foreground": vals.copy(),
              "full, equal values": np.full((H, W), 7, np.uint16)}
    shapes = np.zeros((max(H, 40), max(W, 41)), bool)    # cropped to the frame below
    shapes[2:26, W // 2] = True                           # 24 rows tall
    shapes[max(H - 3, 0), 5:17] = True                    # a 12-pixel line
    shapes[5:25, 3] = shapes[5:25, 9] = shapes[24, 3:10] = True   # U, joined at the bottom
    shapes[30:40, 20:41:2] = True                         # a comb joined at the bottom
    shapes[39, 20:41] = True
    frames["tall, line, U, comb"] = np.where(shapes[:H, :W], vals, 0).astype(np.uint16)
    edges = np.zeros((H, W), bool)
    edges[0, ::3] = edges[-1, 1::3] = True
    edges[::6, 0] = edges[::6, -1] = True
    edges[[0, 0, -1, -1], [0, -1, 0, -1]] = True          # the corners
    edges[2::6, -1] = edges[3::6, 0] = True               # a row's end, the next row's start
    edges[1::6, 1] = edges[4::6, -2] = True               # diagonal neighbours of edge pixels
    frames["edges"] = np.where(edges, vals, 0).astype(np.uint16)
    runs = np.zeros(H * W, bool)
    for r in range(1, H, 5):
        runs[max(r * W - 5, 0):r * W + 4] = True          # 5 at a row's end, 4 at the next's start
    frames["row-end runs"] = np.where(runs.reshape(H, W), vals, 0).astype(np.uint16)
    grid = np.zeros((H, W), bool)
    grid[::2, ::2] = True
    frames["stride-2 grid"] = np.where(grid, vals, 0).astype(np.uint16)
    board = (np.arange(H)[:, None] + np.arange(W)[None, :]) % 2 == 0
    frames["checkerboard"] = np.where(board, vals, 0).astype(np.uint16)
    blobs = np.zeros((H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(12):
        cy, cx, rad = rng.integers(0, H), rng.integers(0, W), rng.integers(1, 11)
        blobs |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
    frames["tied blobs"] = np.where(blobs, rng.integers(1, 4, (H, W)), 0).astype(np.uint16)
    if H * W <= 256 * 256:
        frames["spiral"] = np.where(_spiral(H, W), vals, 0).astype(np.uint16)
    for name, mask in _tile_border_masks(H, W).items():
        frames[name] = np.where(mask, vals, 0).astype(np.uint16)
    return frames


def posdecode_span_battery(rng) -> list:
    """The positions decode's span battery, (what, positions (B, OUT) i32,
    values (B, OUT) i32, counts (B,) i32, height, width, flagged frames) of
    numpy arrays, spans of hopper_decode.POSDECODE_SPAN pixels: positions on
    the first and the last pixel of each span, an empty span beside a full
    one (count = width), count 0, H * W % 8 != 0 (frames and spans off the
    16-byte alignment), and repeated positions, flagged.  The first case has
    a geometry the JAX kernel takes (a power-of-two width, whole chunks of
    rows)."""
    S = hopper_decode.POSDECODE_SPAN
    cases = []

    def case(what, height, width, out, rows):
        n = height * width
        pos = np.zeros((len(rows), out), np.int32)
        counts = np.zeros(len(rows), np.int32)
        for b, row in enumerate(rows):
            pos[b, :len(row)] = row
            counts[b] = len(row)
        vals = rng.integers(0, 4096, pos.shape).astype(np.int32)
        assert all(np.all((r >= 0) & (r < n)) for r in rows)
        return [what, pos, vals, counts, height, width, [False] * len(rows)]

    def sparse(n, k, edges):
        return np.union1d(rng.choice(n, k, replace=False), edges).astype(np.int32)

    H, W = 2 * S // 64, 64
    n = H * W
    cases.append(case("span edges, empty and full spans, count 0 and = width", H, W, S, [
        sparse(n, 300, [0, S - 1, S, n - 1]),
        np.arange(S, 2 * S),
        np.zeros(0, np.int32),
        sparse(n, n // 100, [S - 1, S])]))
    H, W = 101, 167     # H * W % 8 == 3: three spans, frames off the alignment
    n = H * W
    cases.append(case("H*W % 8 != 0", H, W, 3 * S, [
        sparse(n, 200, [0, S - 1, S, 2 * S - 1, 2 * S, n - 1]),
        np.arange(2 * S, n),
        sparse(n, 5000, [S - 1]),
        np.arange(0, n, 3)]))
    cases.append(case("37x29 frames", 37, 29, 37 * 29, [
        sparse(37 * 29, 50, [0, 37 * 29 - 1]), np.arange(37 * 29),
        np.zeros(0, np.int32)]))
    rep = case("repeated positions", 2 * S // 64, 64, S, [
        sparse(2 * S, 300, [S - 1, S])] * 4)
    pos, counts = rep[1], rep[3]
    pos[0, 7] = pos[0, 6]                                  # inside a span
    k = int(np.searchsorted(pos[2, :counts[2]], S))
    pos[2, k] = pos[2, k - 1]                              # on a span's first pixel
    pos[3, counts[3] - 1] = pos[3, counts[3] - 2]          # the last one
    rep[6] = [True, False, True, True]
    cases.append(rep)
    return [tuple(c) for c in cases]


def expect(condition, message) -> None:
    if not condition:
        raise AssertionError(message)


def io_bytes(*items) -> int:
    """Bytes of tensors (each read or written once), or of nested tuples of them."""
    total = 0
    for x in items:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += io_bytes(*x)
    return total


def measure(entry, err: int, reps: int, plain_reps: int) -> dict:
    """CUDA-event times of a kernel, its twin and the library call (if any),
    and the kernel's bound: the bytes it must move over the card's memory
    rate (every kernel here does a few integer operations per byte)."""
    kernel, plain, nbytes, library = entry
    return {"max_abs_err": err, "ms": cuda_event_time(kernel, reps, 1),
            "plain_ms": cuda_event_time(plain, plain_reps, 1),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": cuda_event_time(library, reps, 1) if library is not None else None}


def deflate_battery(rng):
    """Byte streams at the deflate tokenizer's edges: runs across its tiles,
    one across more tiles than a block searches at a time for the run start,
    runs past its 522-byte run-end lookahead, the take boundaries of the
    native tokenizer, the empty, stored (random) and literal-dense cases."""
    t = hopper_deflate.TILE
    streams = [b"", b"\x00" * t, b"\x00" * (t + 1), b"\x00" * (3 * t + 17),
               b"\x00" * (300 * t) + b"\x01",
               b"X" * (t - 6) + b"\x00" * 5000 + b"Y", b"A" + b"\x00" * 520 + b"B",
               b"\x07" * 261 + b"xy" + b"\x07" * 519,
               (rng.integers(0, 256, 9000) * (rng.random(9000) < 0.02)).astype(np.uint8).tobytes(),
               rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
               rng.integers(0, 3, 11000, dtype=np.uint8).tobytes()]
    streams += [b"Q" * off + b"\x00" * 259 + b"R" * 40 for off in (t - 2, t - 1, t, t + 1)]
    streams += [b"Z" * (t - 3) + b"\x00" * gap + b"W" for gap in range(523, 528)]
    return streams


# decode_battery's frame shapes: (96, 160) rows on 16-byte boundaries; (37,
# 29) n % 8 != 0 (dense rows off 16-byte boundaries, a partial last byte);
# (100, 90) n % 16 != 0, bitmap rows of 1125 bytes; (96, 170) bitmap rows of
# 2040 bytes (not a multiple of 16); (300, 301) all three, 23 tiles, across
# an expand block's 16
DECODE_SHAPES = [(96, 160), (37, 29), (100, 90), (96, 170), (300, 301)]


def decode_battery(rng, shape, case: str):
    """Three frames' bitmaps (B, ceil(n / 8)) uint8, with junk bits past n in
    the last byte, and a list of values (B, V) int32 arrays in numpy, for the
    L1 decode at the edges of its kernel: "30%" foreground at random;
    "edges": a frame all set, one all clear, and one whose set bits sit on
    each side of every tile's and every expand block's first pixel and on
    the frame's first and last two.  Values (random int32, kept modulo
    2**16): V = the largest count, one less (an overflow by one), 100 and 0."""
    n = shape[0] * shape[1]
    if case == "30%":
        bits = rng.random((3, n)) < 0.3
    else:
        bits = np.zeros((3, n), bool)
        bits[0] = True
        edges = [e + d for step in (_launch.TILE_PIXELS, hopper_decode.EXPAND_PIXELS)
                 for e in range(step, n, step) for d in (-2, -1, 0, 1)]
        bits[2, [p for p in edges + [0, 1, n - 2, n - 1] if 0 <= p < n]] = True
    bitmap = np.packbits(bits, axis=1, bitorder="little")
    if n % 8:
        bitmap[:, -1] |= (0xFF << (n % 8)) & 0xFF
    top = int(bits.sum(axis=1).max())
    values = rng.integers(-2**31, 2**31, (3, top)).astype(np.int32)
    return bitmap, [np.ascontiguousarray(values[:, :v]) for v in (top, top - 1, min(100, top), 0)]


def assemble_battery(rng) -> list:
    """Token streams at the assembler's edges, (what, tok (B, N) int32, lut
    (B, 48, 32) float32, phase (B,) int32, partial (B,) int32) in numpy, on
    random LUTs of 1..21-bit codes (indices 0..15 take 1..3 bits):

    * "empty tiles": 4 tiles a stream, phases 0..7 with random partial bytes;
      tile 1 holds no token, tile 2 one short token at its end, tile 3 two;
      tile 0 is dense in even streams and one short token in odd ones, so
      that a 32-bit word there holds bits of three tiles and the partial;
    * "ragged": 40 streams of 2 * TILE + 1234 columns (rows not 16-byte
      aligned), tokens up to a random length at random densities, stream 0
      with no token and stream 1 a token in every column;
    * "odd columns": 8 streams of 3 * TILE + 1001 columns, phases 0..7 with
      random partial bytes: no token, one token, one in the last column,
      short tokens at the ends of tiles 0 and 2 with tile 1 empty (a word of
      three tiles), tokens dense in tile 3 alone, and three random
      densities."""
    t = hopper_deflate.TILE

    def tables(B):
        bits = rng.integers(1, hopper_deflate.MAX_TOKEN_BITS + 1, (B, hopper_deflate.NO_TOKEN))
        bits[:, :16] = rng.integers(1, 4, (B, 16))
        vals = rng.integers(0, 1 << 30, bits.shape) & ((1 << bits) - 1)
        lut = np.zeros((B, 2, 768), np.float32)
        lut[:, 0, :hopper_deflate.NO_TOKEN] = vals
        lut[:, 1, :hopper_deflate.NO_TOKEN] = bits
        phase = rng.integers(0, 8, B).astype(np.int32)
        partial = (rng.integers(0, 256, B) & ((1 << phase) - 1)).astype(np.int32)
        return lut.reshape(B, 48, 32), phase, partial

    def inverted(idx):
        return hopper_deflate.NO_TOKEN - idx

    idx = np.full((8, 4 * t), hopper_deflate.NO_TOKEN)
    dense = rng.random(t) < 0.3
    for b in range(8):
        if b % 2 == 0:
            idx[b, :t] = np.where(dense, rng.integers(0, hopper_deflate.NO_TOKEN, t),
                                  hopper_deflate.NO_TOKEN)
        else:
            idx[b, rng.integers(0, t)] = rng.integers(0, 16)
        idx[b, 3 * t - 1] = rng.integers(0, 16)
        idx[b, [3 * t, 3 * t + 100]] = rng.integers(0, 16, 2)
    lut = tables(8)[0]
    phase = np.arange(8, dtype=np.int32)
    partial = (rng.integers(0, 256, 8) & ((1 << phase) - 1)).astype(np.int32)
    cases = [("empty tiles", inverted(idx).astype(np.int32), lut, phase, partial)]

    n = 2 * t + 1234
    lengths = rng.integers(0, n + 1, 40)
    lengths[:2] = [0, n]
    density = rng.uniform(0.05, 1.0, 40)
    density[1] = 1.0
    live = (np.arange(n)[None, :] < lengths[:, None]) & (rng.random((40, n)) < density[:, None])
    idx = np.where(live, rng.integers(0, hopper_deflate.NO_TOKEN, (40, n)),
                   hopper_deflate.NO_TOKEN)
    cases.append(("ragged", inverted(idx).astype(np.int32), *tables(40)))

    n = 3 * t + 1001
    idx = np.full((8, n), hopper_deflate.NO_TOKEN)
    idx[1, rng.integers(0, n)] = rng.integers(0, hopper_deflate.NO_TOKEN)
    idx[2, n - 1] = rng.integers(0, hopper_deflate.NO_TOKEN)
    idx[3, [t - 1, 3 * t - 1, 3 * t]] = rng.integers(0, 16, 3)
    idx[4, 3 * t:] = rng.integers(0, hopper_deflate.NO_TOKEN, n - 3 * t)
    for b, d in zip((5, 6, 7), (0.01, 0.3, 1.0)):
        idx[b] = np.where(rng.random(n) < d, rng.integers(0, hopper_deflate.NO_TOKEN, n),
                          hopper_deflate.NO_TOKEN)
    lut = tables(8)[0]
    phase = np.arange(8, dtype=np.int32)
    partial = (rng.integers(0, 256, 8) & ((1 << phase) - 1)).astype(np.int32)
    cases.append(("odd columns", inverted(idx).astype(np.int32), lut, phase, partial))
    return cases


def hist_battery(rng) -> list:
    """Symbol streams at the histogram's edges, (what, values (B, NPAD)
    int32, m (B,) int32) in numpy: 2^21 copies of one symbol, all 4096
    symbols, m = 0 in every stream, symbols outside 0..4095 inside m and
    junk past it, an odd NPAD with m at 0..3 and NPAD - 3..NPAD (rows not
    16-byte aligned), 40 streams, and 2^21 + 1000 symbols beside 17."""
    peaked = lambda shape: np.minimum(rng.exponential(8.0, shape), 4095).astype(np.int32)
    junk = peaked((4, 10000))
    junk[:, ::7] = -1
    junk[:, 3::11] = 4096
    junk[:, 5::13] = rng.integers(-2**31, 2**31, junk[:, 5::13].shape)
    odd = 12347
    long = (1 << 21) + 1000
    return [
        ("one symbol 2^21 times", np.full((1, 1 << 21), 7, np.int32),
         np.array([1 << 21], np.int32)),
        ("all 4096 symbols", np.stack([rng.permutation(np.tile(np.arange(4096), 3)),
                                       np.arange(3 * 4096) % 4096]).astype(np.int32),
         np.array([3 * 4096, 3 * 4096 - 5], np.int32)),
        ("m = 0", peaked((3, 5000)), np.zeros(3, np.int32)),
        ("out of range inside m, junk past m", junk, np.array([6000, 10000, 1, 9999], np.int32)),
        ("odd NPAD", peaked((8, odd)), np.array([0, 1, 2, 3, odd - 3, odd - 2, odd - 1, odd],
                                                 np.int32)),
        ("40 streams", peaked((40, 3000)), rng.integers(0, 3001, 40).astype(np.int32)),
        ("2^21 + 1000 beside 17", peaked((2, long)), np.array([long, 17], np.int32)),
    ]


def assemble_tokens(tok, comp, n_tok: int, lengths):
    """The tokens the main path assembles: the compacted tokens of sparse
    streams, the dense tokens sliced to the longest stream of literal-dense
    ones (deflate_batch_device's two routes)."""
    cols = min(tok.shape[1], quantize_bound(int(lengths.max()), hopper_deflate.TILE))
    return comp if 2 * n_tok <= cols else \
        tok.view(torch.int16)[:, :cols].contiguous().view(torch.uint16)


def host_tables(hist, device):
    """The assembler's token LUTs, header phases and partial bytes from a
    tokenizer histogram, as deflate_batch_device builds them."""
    t = dyndeflate.host_tables(hist.cpu().numpy())
    return [torch.from_numpy(a).to(device) for a in (t.luts, t.phases, t.partials)]


def check_deflate(device, rng, check, bitmap, packed, plens):
    """Phase 3, deflate: tokenize, tokenize_compact and assemble against their
    twins on an edge battery and on the slice's bitmap and packed-value
    streams, and every stream deflate_batch_device makes, with and without a
    density hint, against native.deflate_sparse.  Returns, for the bitmap and
    the value streams, (kernel, twin) closures of each kernel at the inputs
    the main path gives it."""
    raws = deflate_battery(rng)
    edge = np.zeros((len(raws), max(map(len, raws)) + 5003), np.uint8)
    for i, raw in enumerate(raws):
        edge[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    full = torch.full((bitmap.shape[0],), bitmap.shape[1], dtype=torch.int32, device=device)
    cases = [("edge battery", torch.from_numpy(edge).to(device),
              torch.tensor([len(r) for r in raws], dtype=torch.int32, device=device)),
             ("slice bitmaps", bitmap, full), ("slice values", packed, plens)]
    timed = {}
    for what, streams, lengths in cases:
        tok, hist, adler = hopper_deflate.tokenize(streams, lengths)
        check("tokenize", [tok, hist, adler], hopper_deflate.tokenize_plain(streams, lengths), what)
        n_tok = int(hist[:, :286].sum(dim=1).max())
        for bound in (n_tok, n_tok // 2):
            got = hopper_deflate.tokenize_compact(streams, lengths, bound)
            check("tokenize_compact", got,
                  hopper_deflate.tokenize_compact_plain(streams, lengths, bound),
                  f"{what}, bound {bound}")
            expect(bool(got[4].any()) == (bound < n_tok), f"tokenize_compact overflow at {bound}")
        comp = hopper_deflate.tokenize_compact(streams, lengths, n_tok)[0]
        tables = host_tables(hist, device)
        out_bound = 2 * streams.shape[1] + 256
        for kind, t in (("u16", tok), ("i32 compacted", comp)):
            check("assemble", hopper_deflate.assemble(t, *tables, out_bound),
                  hopper_deflate.assemble_plain(t, *tables, out_bound), f"{what}, {kind} tokens")

        lens = lengths.cpu().numpy()
        host = streams.cpu().numpy()
        hint = {}
        for _ in range(2):  # the first call seeds the density hint the second one reads
            outs = dyndeflate.deflate_batch_device(streams, lens, hint_state=hint)
            for i, out in enumerate(outs):
                expect(out == native.deflate_sparse(host[i, :lens[i]].tobytes()),
                       f"deflate_batch_device differs from native.deflate_sparse: {what}, stream {i}")
        print(f"  deflate      {what}: {len(outs)} streams equal native.deflate_sparse, "
              f"without and with a density hint ({hint['density']:.4f})")

        if what != "edge battery":
            asm_tok = assemble_tokens(tok, comp, n_tok, lens)
            # no PyTorch call computes a deflate token stream or bit assembly
            timed[what] = {
                "tokenize": (lambda s=streams, n=lengths: hopper_deflate.tokenize(s, n),
                             lambda s=streams, n=lengths: hopper_deflate.tokenize_plain(s, n),
                             io_bytes(streams, lengths, tok, hist, adler), None),
                "tokenize_compact": (
                    lambda s=streams, n=lengths, b=n_tok: hopper_deflate.tokenize_compact(s, n, b),
                    lambda s=streams, n=lengths, b=n_tok:
                        hopper_deflate.tokenize_compact_plain(s, n, b),
                    io_bytes(streams, lengths, hopper_deflate.tokenize_compact(streams, lengths,
                                                                               n_tok)), None),
                "assemble": (
                    lambda t=asm_tok, a=tables, o=out_bound: hopper_deflate.assemble(t, *a, o),
                    lambda t=asm_tok, a=tables, o=out_bound:
                        hopper_deflate.assemble_plain(t, *a, o),
                    io_bytes(asm_tok, tables, hopper_deflate.assemble(asm_tok, *tables, out_bound)),
                    None),
            }
    # a generator of its own, so that the later phases' data stay as they were
    for what, tok, lut, phase, partial in assemble_battery(np.random.default_rng(SEED + 2)):
        args = [torch.from_numpy(a).to(device) for a in (lut, phase, partial)]
        total = int(hopper_deflate.assemble_plain(torch.from_numpy(tok), *map(torch.from_numpy, (
            lut, phase, partial)), 0)[1].max())
        exact = (total + 7) // 8
        for kind, t in (("i32", torch.from_numpy(tok).to(device)),
                        ("u16", _launch.i32_to_u16(torch.from_numpy(tok).to(device)))):
            for out_bound in (exact, -(-exact // 128) * 128 - 128):
                got = hopper_deflate.assemble(t, *args, out_bound)
                want = hopper_deflate.assemble_plain(t, *args, out_bound)
                check("assemble", got, want, f"{what}, {kind}, out_bound {out_bound}")
                check("assemble_split", hopper_deflate.assemble_split(t, *args, out_bound), want,
                      f"{what}, {kind}, out_bound {out_bound}")
                expect(bool(got[2].any()) == (out_bound < exact),
                       f"assemble overflow on {what} at out_bound {out_bound}")
    return timed


def rans_tables(hist):
    """Each stream's quantized frequencies (B, 4096) int32 and their prefix,
    from a histogram, as the scheme-12 coders build them on the host."""
    freq, cum = rans.freq_tables(hist.cpu().numpy(), hopper_rans.ALPHABET)
    return freq.astype(np.int32), cum.astype(np.int32)


def reversed_bodies(body, counts):
    """(B, max count) uint8 of each stream's body reversed, as the decoder
    reads it, and the body lengths."""
    n = counts.cpu().numpy()
    rev = np.zeros((body.shape[0], max(int(n.max()), 1)), np.uint8)
    host = body.cpu().numpy()
    for b in range(body.shape[0]):
        rev[b, :n[b]] = host[b, :n[b]][::-1]
    return torch.from_numpy(rev).to(body.device), counts


def coder_args(device, syms, m, groups: int):
    """The rANS encode's and decode's arguments for symbol streams (B, NPAD)
    int32 with counts m, coded as check_rans_stream codes them (histogram ->
    host tables -> encode at ``groups``), and the row count of the longest
    stream: the length of each lane's chain of rows."""
    freq, cum = rans_tables(hopper_rans.rans_hist(syms, m))
    tables = torch.from_numpy(np.stack([hopper_rans.decode_tables(f) for f in freq])).to(device)
    enc_args = (syms, torch.from_numpy(freq).to(device), torch.from_numpy(cum).to(device), m,
                2 * int(m.max()) + 16, groups)
    body, states, counts = hopper_rans.rans_encode(*enc_args)
    rows = -(-int(m.max()) // (hopper_rans.W_LANES * groups))
    return enc_args, (*reversed_bodies(body, counts), states, m, tables, max(int(m.max()), 1),
                      groups), rows


def check_rans_stream(device, check, what, syms, m, groups_list=(1,)):
    """Histogram, encode and decode of symbol streams (B, NPAD) int32 with
    counts m (B,) int32 against their twins; the decode must give the
    symbols back.  Returns the encode's and decode's arguments at the last
    groups for timing."""
    hist = hopper_rans.rans_hist(syms, m)
    check("rans_hist", [hist], [hopper_rans.rans_hist_plain(syms, m)], what)
    freq, cum = rans_tables(hist)
    freq_t, cum_t = torch.from_numpy(freq).to(device), torch.from_numpy(cum).to(device)
    tables = torch.from_numpy(np.stack([hopper_rans.decode_tables(f) for f in freq])).to(device)
    out_bound = 2 * int(m.max()) + 16
    npad = max(int(m.max()), 1)
    for groups in groups_list:
        enc_args = (syms, freq_t, cum_t, m, out_bound, groups)
        body, states, counts = hopper_rans.rans_encode(*enc_args)
        check("rans_encode", [body, states, counts], hopper_rans.rans_encode_plain(*enc_args),
              f"{what}, groups {groups}")
        expect(bool((counts <= out_bound).all()), "rANS body over its bound")
        dec_args = (*reversed_bodies(body, counts), states, m, tables, npad, groups)
        got = hopper_rans.rans_decode(*dec_args)
        check("rans_decode", got, hopper_rans.rans_decode_plain(*dec_args),
              f"{what}, groups {groups}")
        live = torch.arange(npad, device=device)[None, :] < m[:, None].to(torch.int64)
        expect(not bool(got[1].any()) and torch.equal(got[0], torch.where(live, syms[:, :npad], 0)),
               f"rANS decode of encode differs from the symbols: {what}, groups {groups}")
    return enc_args, dec_args, freq


def check_rans(device, rng, check, frames, thr, out_size, packed):
    """Phase 3, scheme 12: the encode with positions, the rANS histogram,
    encode and decode, and the positions decode against their twins on the
    slice batch's gap and value symbols and on an edge battery (m = 0, m not
    a multiple of 1024, a one-symbol alphabet, all 4096 symbols, a stream of
    more than 2^21 symbols at groups 8, ~20% foreground frames whose bitmaps
    take the 8-bit symbol mode).  Returns, for the gap and the value
    symbols, timing entries of each new kernel at the main path's inputs."""
    B, H, W = frames.shape
    got = hopper_encode.encode_l1(frames, thr, out_size, True, True, 12)
    check("encode_l1", got, hopper_encode.encode_l1_plain(frames, thr, out_size, True, True, 12),
          "slice, with positions")
    _, comp, counts, _, pos = got
    valid = torch.arange(pos.shape[1], device=device)[None, :] < counts[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=device), pos[:, :-1]], 1)
    gaps = torch.where(valid, pos - prev - 1, 0).clamp(max=rans.GAP_ESCAPE - 1).contiguous()
    values = hopper_bitpack.bitunpack12(packed)
    slice_streams = {"slice gaps": (gaps, counts), "slice values": (values, counts)}
    timed = {}
    for what, (syms, m) in slice_streams.items():
        enc_args, dec_args, _ = check_rans_stream(device, check, what, syms, m)
        flat = (torch.arange(B, device=device)[:, None] * 4096 + syms)[
            torch.arange(syms.shape[1], device=device)[None, :] < m[:, None]]
        n_sym = int(m.sum())
        body_bytes = int(hopper_rans.rans_encode(*enc_args)[2].sum())
        timed[what] = {
            "rans_hist": (lambda s=syms, k=m: hopper_rans.rans_hist(s, k),
                          lambda s=syms, k=m: hopper_rans.rans_hist_plain(s, k),
                          4 * n_sym + 4 * B * 4096,
                          lambda f=flat: torch.bincount(f, minlength=B * 4096)),
            "rans_encode": (lambda a=enc_args: hopper_rans.rans_encode(*a),
                            lambda a=enc_args: hopper_rans.rans_encode_plain(*a),
                            4 * n_sym + io_bytes(*enc_args[1:4]) + body_bytes
                            + io_bytes(*hopper_rans.rans_encode(*enc_args)[1:]), None),
            "rans_decode": (lambda a=dec_args: hopper_rans.rans_decode(*a),
                            lambda a=dec_args: hopper_rans.rans_decode_plain(*a),
                            body_bytes + io_bytes(*dec_args[1:5])
                            + io_bytes(hopper_rans.rans_decode(*dec_args)), None),
        }

    # the edge battery of symbol streams
    long = (1 << 21) + 1000
    edge = np.minimum(rng.exponential(8.0, (5, long)).astype(np.int64), 4095).astype(np.int32)
    edge[2] = 9
    edge[3] = rng.integers(0, 4096, long)
    m_edge = np.array([0, 70001, 5000, 65537, long], np.int32)
    check_rans_stream(device, check, "edge battery", torch.from_numpy(edge).to(device),
                      torch.from_numpy(m_edge).to(device), groups_list=(1, 8))
    for what, vals, m in hist_battery(np.random.default_rng(SEED + 3)):
        v, k = torch.from_numpy(vals).to(device), torch.from_numpy(m).to(device)
        check("rans_hist", [hopper_rans.rans_hist(v, k)], [hopper_rans.rans_hist_plain(v, k)],
              what)
    # the encode step's reciprocal against the division, every f in 1..4096
    for arrays in state_battery(rng):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        check("rans_encode", [hopper_rans.rans_encode_state(*args)],
              [hopper_rans.rans_encode_state_plain(*args)], "state update, every f")

    # positions decode of the slice, and of corrupt positions
    dense, overflow = hopper_decode.posdecode(pos, comp, counts, H, W)
    check("posdecode", [dense, overflow], hopper_decode.posdecode_plain(pos, comp, counts, H, W),
          "slice")
    expect(not bool(overflow.any()) and torch.equal(
        dense.view(torch.int16), hopper_decode.decode_l1(got[0], comp, H, W)[0].view(torch.int16)),
        "posdecode differs from the bitmap decode")
    bad = pos[:1].repeat(4, 1)          # frame 0 clean, then three corrupt copies
    bad_vals = comp[:1].repeat(4, 1)
    bad[1, 5] = H * W
    bad[2, 7] = bad[2, 6]
    over = counts[:1].repeat(4)
    over[3] = pos.shape[1] + 1
    flags = hopper_decode.posdecode(bad, bad_vals, over, H, W)[1]
    check("posdecode", [flags], [hopper_decode.posdecode_plain(bad, bad_vals, over, H, W)[1]],
          "corrupt positions")
    expect(flags.tolist() == [False, True, True, True],
           f"posdecode overflow flags {flags.tolist()}")
    for what, *arrays, h, w, flagged in posdecode_span_battery(rng):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        got_dense, got_flags = hopper_decode.posdecode(*args, h, w)
        want_dense, want_flags = hopper_decode.posdecode_plain(*args, h, w)
        clean = ~want_flags     # a flagged frame's dense output is unspecified
        check("posdecode", [got_dense.view(torch.int16)[clean], got_flags],
              [want_dense.view(torch.int16)[clean], want_flags], f"span battery: {what}")
        expect(got_flags.tolist() == flagged,
               f"posdecode flags {got_flags.tolist()} on {what}, expected {flagged}")
    n_pos = int(counts.sum())
    idx = torch.where(valid, pos, H * W).to(torch.int64)
    src = comp.to(torch.int16)
    timed["slice gaps"]["posdecode"] = (
        lambda: hopper_decode.posdecode(pos, comp, counts, H, W),
        lambda: hopper_decode.posdecode_plain(pos, comp, counts, H, W),
        8 * n_pos + io_bytes(counts, dense, overflow),
        lambda: torch.zeros((B, H * W + 1), dtype=torch.int16, device=device).scatter_(1, idx, src))

    # ~20% foreground: the bitmaps take the 8-bit symbol mode (2^21 symbols
    # a stream at 4096^2, so 8 lane groups) and read through the symbol chain
    if H * W // 8 < 1 << 21:
        print("  20% frames: skipped, frames too small for device-coded 8-bit bitmaps")
        return timed
    dense_np, dark20 = make_frames(rng, B, H, W, occupancy=0.2)
    thr20_np = dark20 + EPSILON
    thr20 = torch.from_numpy(thr20_np).to(device)
    dframes = torch.from_numpy(dense_np).to(device)
    dcounts = hopper_encode.encode_l1_plain(dframes, thr20, 0, with_values=False)[2]
    bm20, comp20, c20, _, _ = hopper_encode.encode_l1(
        dframes, thr20, _bucket_for(int(dcounts.max()), H * W), True, True, 12)
    full = torch.full((B,), bm20.shape[1], dtype=torch.int32, device=device)
    check_rans_stream(device, check, "20% bitmaps as 8-bit symbols", bm20.to(torch.int32), full,
                      groups_list=(8,))
    # the writer's own route: one node writes the frames with the card's
    # default device entropy, and the reader takes the symbol chain
    with tempfile.TemporaryDirectory(prefix="tmp_chip_smoke_", dir=REPO) as tmp:
        writer = port.ReCoDeWriter("dense", dark_data=dark20, output_directory=tmp,
                                   input_params=slice_params(B, H, W, 1, scheme=12),
                                   device=device, buffer_size_in_frames=B)
        expect(writer._device_entropy, "scheme-12 device entropy is not the default on the card")
        writer.start()
        writer.run(dense_np)
        writer.close()
        reader = port.ReCoDeReader(port.merge_parts(tmp, "dense.rc1", 1), device=device)
        reader.open()
        records = [reader.get_next_frame_raw()[z]["data"] for z in range(B)]
        read = reader.read_frames_dense(0, B)
        reader.close()
    p20 = hopper_bitpack.bitpack12(comp20).cpu().numpy()
    for i, rec in enumerate(records):
        h = rans._parse_header(rec["binary_map"])
        expect(h.get("sym_bits") == 8 and not h["gap"] and h["nways"] == 8192,
               f"20% frame {i}: the writer did not code its bitmap as 8-bit symbols at 8192 lanes")
        expect(rans.decompress(rec["binary_map"]) == bm20[i].cpu().numpy().tobytes(),
               f"20% frame {i}: the bitmap stream does not decode to the bitmap")
        plen = (int(c20[i]) * 12 + 7) // 8
        expect(rans.decompress(rec["pixvals"]) == p20[i, :plen].tobytes(),
               f"20% frame {i}: the value stream does not decode to the packed values")
    expect(np.array_equal(read, np.where(dense_np > thr20_np, dense_np - thr20_np, 0)),
           "the symbol read chain of 20% frames differs from the residuals")
    print("  20% frames: the writer coded the bitmaps as 8-bit symbols at 8192 lanes; host "
          "decode and the symbol read chain exact")
    return timed


def token_tables(tok, m):
    """Quantized byte-mode frequencies (B, 4096) int32 of each stream's first
    m inverted tokens (286-symbol alphabet in front) and their prefix."""
    sym = np.asarray(hopper_rans.TOKEN_SYMBOL)
    hist = []
    for row, k in zip(tok, m):
        idx = hopper_rans.NO_TOKEN - row[:k].astype(np.int64)
        hist.append(np.bincount(sym[idx[(idx >= 0) & (idx < 512)]], minlength=rans.N_SYM))
    freq, cum = rans.freq_tables(hist, rans.N_SYM)
    return freq.astype(np.int32), cum.astype(np.int32)


def token_battery(rng):
    """Inverted token streams at #9t's edges: empty, one token, literals only
    (m = 3000), every match index and so every length code, a one-symbol
    alphabet (f = 4096), pad and out-of-range tokens among the counted
    ones; m = 3 * 1024 + 1 where not stated."""
    n = 3 * 1024 + 1
    i = np.arange(n)
    lit = rng.integers(0, 256, n)
    mixed = np.where(i % 2, 256 + (i // 2) % 256, lit)
    idx = np.stack([lit, np.full(n, 77), lit, mixed, np.full(n, 7), mixed])
    tok = hopper_rans.NO_TOKEN - idx
    tok[5, ::5] = 0
    tok[5, 1::7] = 600
    m = np.array([0, 1, 3000, n, 2500, n], np.int32)
    return tok.astype(np.int32), m


def token_args(device, streams):
    """The token rANS encode's arguments for the deflate tokens of byte
    streams (B, N) uint8, as rans_batch_device codes them: the compacted
    int32 tokens at the batch's token capacity, their host tables, the
    token counts and the body bound (2 bytes a token + 16)."""
    full = torch.full((streams.shape[0],), streams.shape[1], dtype=torch.int32, device=device)
    tok, hist, _ = hopper_deflate.tokenize(streams, full)
    m = hist[:, :rans.N_SYM].sum(dim=1, dtype=torch.int32)
    bound = rans.token_capacity(m.cpu().numpy())
    dense = hopper_deflate.compact_tokens(tok, bound)[0]
    freq, cum = token_tables(dense.cpu().numpy(), m.cpu().numpy())
    return (dense, *(torch.from_numpy(a).to(device) for a in (freq, cum)), m, 2 * bound + 16)


def state_battery(rng):
    """(x, f, cum) int32 triples for the encode step's reciprocal against /
    and %: every f in 1..4096 at x = 2^23, 2^31 - 1, (f << 19) - 1 (the
    largest state a step divides), q * f - 1, q * f and q * f + 1 for the
    two smallest q with q * f >= 2^23 and the two largest with q * f < 2^31,
    and random x below 2^31; three arrays each: cum 0, 4096 - f and
    random."""
    f = np.arange(1, 4097, dtype=np.int64)
    q_lo = -(-(1 << 23) // f)
    q_hi = ((1 << 31) - 1) // f
    xs = [np.full_like(f, 1 << 23), np.full_like(f, (1 << 31) - 1),
          np.minimum((f << 19) - 1, (1 << 31) - 1)]
    for q in (q_lo, q_lo + 1, q_hi - 1, q_hi):
        xs += [q * f - 1, q * f, q * f + 1]
    xs += list(rng.integers(0, 1 << 31, (8, f.size)))
    x = np.minimum(np.stack(xs), (1 << 31) - 1)
    ff = np.broadcast_to(f, x.shape)
    return [tuple(np.ascontiguousarray(a, dtype=np.int32).ravel() for a in (x, ff, c))
            for c in (np.zeros_like(x), 4096 - ff, rng.integers(0, 4097, x.shape))]


def check_rans_tokens(device, rng, check, bitmap):
    """Phase 3, byte mode: the token rANS encode (#9t) against its twin on
    the tokens of the slice's bitmap streams (compacted int32, as
    rans_batch_device codes them, and uint16) and on an edge battery; every
    stream of rans_batch_device on those bitmaps against
    native.rans_compress at 1024 lanes.  Returns the timing entry at the
    main path's input."""
    B = bitmap.shape[0]
    args = token_args(device, bitmap)
    dense, *tables, m, out_bound = args
    body, states, counts = hopper_rans.rans_encode_tokens(*args)
    check("rans_encode_tokens", [body, states, counts],
          hopper_rans.rans_encode_tokens_plain(*args), "slice bitmap tokens")
    u16 = _launch.i32_to_u16(dense)
    check("rans_encode_tokens", hopper_rans.rans_encode_tokens(u16, *tables, m, out_bound),
          hopper_rans.rans_encode_tokens_plain(u16, *tables, m, out_bound),
          "slice bitmap tokens, uint16")
    edge, m_edge = token_battery(rng)
    e_tables = [torch.from_numpy(a).to(device) for a in token_tables(edge, m_edge)]
    e_args = (torch.from_numpy(edge).to(device), *e_tables, torch.from_numpy(m_edge).to(device),
              2 * edge.shape[1] + 16)
    got = hopper_rans.rans_encode_tokens(*e_args)
    check("rans_encode_tokens", got, hopper_rans.rans_encode_tokens_plain(*e_args),
          "edge battery")
    expect(int(got[2][4]) == 0, "a one-symbol alphabet must emit no body bytes")
    print("  rans_encode_tokens: a one-symbol alphabet emits no body bytes (the numpy contract)")

    raws = [row.tobytes() for row in bitmap.cpu().numpy()]
    coded = rans.rans_batch_device(bitmap, [len(r) for r in raws])
    for i, (raw, stream) in enumerate(zip(raws, coded)):
        # below 1024 tokens the host coder narrows its lanes: the streams differ
        expect(int(m[i]) < 1024 or stream == native.rans_compress(raw, 1024),
               f"rans_batch_device bitmap {i} differs from native.rans_compress(raw, 1024)")
        expect(rans.decompress(stream) == raw, f"rans_batch_device bitmap {i} does not decode")
    print(f"  rans_batch_device: {B} bitmap streams equal native.rans_compress at 1024 lanes "
          "where they hold 1024 tokens or more "
          f"({int(m.sum())} tokens, body {int(counts.sum())} bytes)")
    # no PyTorch call codes rANS; the bound: tokens read, body written
    return (lambda: hopper_rans.rans_encode_tokens(*args),
            lambda: hopper_rans.rans_encode_tokens_plain(*args),
            4 * int(m.sum()) + int(counts.sum()), None)


def label_batteries(device, rng, height: int, width: int):
    """The label kernel's inputs beyond the puddle batch: (what, frames,
    threshold, out_size) of the edge battery at the slice's shape, a spiral
    and the battery at 256^2 (the twin's rounds stay few there), at the tile
    batteries' shapes (label_tile_shapes) and on one 1 x 2^20 row (tiles
    that cover part of a row); and puddle frames of 37x29, of a width not a
    multiple of 128 and of the tile batteries' shapes."""
    cases = []
    tile_shapes = list(label_tile_shapes().values())
    for h, w in [*{(height, width), (min(height, 256), min(width, 256))}, *tile_shapes,
                 (1, 1 << 20)]:
        edge = label_edge_frames(rng, h, w)
        cases.append((f"edge battery {h}x{w} ({len(edge)} frames)",
                      torch.from_numpy(np.stack(list(edge.values()))).to(device),
                      torch.zeros((h, w), dtype=torch.uint16, device=device), h * w))
    for h, w in ((37, 29), (min(height, 96), 1000), *tile_shapes):
        f, d = make_puddle_frames(rng, 3, h, w, hits=40000 * 16)
        cases.append((f"{h}x{w} puddle frames", torch.from_numpy(f).to(device),
                      torch.from_numpy(d + EPSILON).to(device), h * w))
    return cases


def check_label(device, rng, check, n_frames: int, height: int, width: int):
    """Phase 3, L2/L4: the label kernel in all five modes against its twin
    on a batch of puddle frames (with an out_size that fits and one that
    overflows) and the edge batteries, frame 0 of the batch against
    oracle.reduce_frame; then the bitmap -> positions kernel on the batch's
    bitmaps and L2 statistics streams and on edge streams.  Returns timing
    entries of both kernels at the main path's inputs (L2 sum, and the L3
    bitmaps at the writer's positions capacity)."""
    frames_np, dark = make_puddle_frames(rng, n_frames, height, width)
    thr_np = dark + EPSILON
    frames, thr = torch.from_numpy(frames_np).to(device), torch.from_numpy(thr_np).to(device)
    fg = hopper_encode.encode_l1_plain(frames, thr, 0, with_values=False)[2]
    out_size = _bucket_for(int(fg.max()), height * width)
    print(f"puddle batch: frames {tuple(frames.shape)}, foreground counts {fg.tolist()}, "
          f"puddle buffer {out_size}")
    cases = [("puddle batch", frames, thr, out_size)] + label_batteries(device, rng, height, width)
    outs = {}
    for mode in hopper_label.MODES:
        for what, f, t, size in cases:
            got = hopper_label.encode_l2l4(f, t, mode, size, 4095)
            check("label_l2l4", got, hopper_label.encode_l2l4_plain(f, t, mode, size, 4095),
                  f"{mode}, {what}")
            expect(not bool(got[3].any()), f"label_l2l4 {mode}: unexpected overflow on {what}")
            if what == "puddle batch":
                outs[mode] = got
        small = int(outs[mode][2].min()) // 2
        got = hopper_label.encode_l2l4(frames, thr, mode, small, 4095)
        check("label_l2l4", got, hopper_label.encode_l2l4_plain(frames, thr, mode, small, 4095),
              f"{mode}, out_size < count")
        expect(bool(got[3].all()), "label_l2l4: overflow must be set when out_size < count")
        level, name = hopper_label.CONFIG_BY_MODE[mode]
        enc = oracle.reduce_frame(frames_np[0], thr_np, level, 12, l2_statistic=name,
                                  l4_scheme=name)
        bitmap, stats, counts, _ = outs[mode]
        expect(bitmap[0].cpu().numpy().tobytes() == enc["packed_binary_map"],
               f"label_l2l4 {mode}: frame 0 bitmap differs from oracle.reduce_frame")
        if level == 2:
            n = int(counts[0])
            expect(oracle.bit_pack(stats[0, :n].cpu().numpy(), 12).tobytes()
                   == enc["packed_pixvals"],
                   f"label_l2l4 {mode}: frame 0 statistics differ from oracle.reduce_frame")
    print(f"  label_l2l4       frame 0 of the puddle batch equals oracle.reduce_frame in all "
          f"five modes; puddles {outs['l2sum'][2].tolist()}")

    # bitmap -> positions on the streams the slices code in gap mode
    l2_bitmap, l2_stats, l2_counts, _ = outs["l2sum"]
    packed = bitpack_values(l2_stats, 12)
    streams = [("L2/L3 bitmaps", l2_bitmap), ("L4 bitmaps", outs["l4w"][0]),
               ("L2 sum statistics", packed),
               ("no set bits", torch.zeros((2, 8192), dtype=torch.uint8, device=device)),
               ("all bits set", torch.full((2, 5000), 255, dtype=torch.uint8, device=device)),
               ("NB = 12345", torch.from_numpy(
                   (rng.integers(0, 256, (3, 12345)) * (rng.random((3, 12345)) < 0.3))
                   .astype(np.uint8)).to(device))]
    for what, bm in streams:
        bound = 2 * -(-bm.shape[1] // 16384) * 16384   # the writer's capacity
        for size in (bound, 100):
            got = hopper_gaps.bitmap_positions(bm, size)
            check("bitmap_positions", got, hopper_gaps.bitmap_positions_plain(bm, size),
                  f"{what}, out_size {size}")
        n_set = int(unpack_bits(bm).sum(dim=1).max())
        expect(bool(hopper_gaps.bitmap_positions(bm, bound)[2].any()) == (n_set > bound),
               f"bitmap_positions overflow flag on {what}")
    print("  bitmap_positions overflow flags follow the set-bit counts")

    # no PyTorch call labels puddles or lists a bitmap's set bits
    got = outs["l2sum"]
    pos_bound = 2 * -(-l2_bitmap.shape[1] // 16384) * 16384
    positions = hopper_gaps.bitmap_positions(l2_bitmap, pos_bound)
    timed = {
        "label_l2l4": (lambda: hopper_label.encode_l2l4(frames, thr, "l2sum", out_size, 4095),
                       lambda: hopper_label.encode_l2l4_plain(frames, thr, "l2sum", out_size, 4095),
                       io_bytes(frames, thr, got), None),
        "bitmap_positions": (lambda: hopper_gaps.bitmap_positions(l2_bitmap, pos_bound),
                             lambda: hopper_gaps.bitmap_positions_plain(l2_bitmap, pos_bound),
                             io_bytes(l2_bitmap, positions), None),
    }
    modes = {mode: (lambda m=mode: hopper_label.encode_l2l4(frames, thr, m, out_size, 4095))
             for mode in hopper_label.MODES}
    return timed, modes


def pairs_token_bound(pair_counts, n: int) -> int:
    """A token capacity no frame of n bitmap bytes with these pair counts
    can exceed: an element (a pair, or the tail sentinel) emits at most 4
    tokens beside one match per 258 bytes of its gap."""
    return quantize_bound(4 * (int(pair_counts.max()) + 1) + n // 258, hopper_deflate.TILE)


def check_alternates(device, rng, check, frames, thr, out_size, enc_cases, bitmap, comp, packed,
                     plens):
    """Phase 3, the alternates: encode_l1(pairs_out=), tokens_from_pairs,
    assemble_split and bitpack12_words against their twins on the slice
    batch and edge batteries; tokens_from_pairs also against tokenize_compact
    on the slice's bitmaps, and assemble_split against assemble.  Returns
    timing entries of the four at the main path's inputs."""
    for what, f, t, size, with_values in enc_cases:
        # pairs_out that fits, and one below the slice's pair counts
        for po in (size, size // 2) if with_values else (out_size,):
            got = hopper_encode.encode_l1(f, t, size, with_values, pairs_out=po)
            check("encode_l1_pairs", got,
                  hopper_encode.encode_l1_plain(f, t, size, with_values, pairs_out=po),
                  f"{what}, pairs_out {po}")
            values_over = got[2] > size if with_values else torch.zeros_like(got[3])
            expect(torch.equal(got[3], (got[5] > po) | values_over),
                   f"encode_l1_pairs overflow flags on {what}, pairs_out {po}")
    enc = hopper_encode.encode_l1(frames, thr, out_size, pairs_out=out_size)
    expect(not bool(enc[3].any()), "encode_l1_pairs: unexpected overflow on the slice")
    expect(torch.equal(enc[0], bitmap) and torch.equal(enc[1], comp),
           "encode_l1 with pairs differs from encode_l1 without")
    pairs, pcounts = enc[4], enc[5]
    B, n = bitmap.shape
    bound = pairs_token_bound(pcounts, n)
    tfp = hopper_tokens.tokens_from_pairs(pairs, pcounts, n, bound)
    check("tokens_from_pairs", tfp, hopper_tokens.tokens_from_pairs_plain(pairs, pcounts, n, bound),
          "slice bitmaps' pairs")
    full = torch.full((B,), n, dtype=torch.int32, device=device)
    ref = hopper_deflate.tokenize_compact(bitmap, full, bound)
    expect(not bool(tfp[3].any()), "tokens_from_pairs flagged a slice frame")
    expect(torch.equal(tfp[0], ref[0]) and torch.equal(tfp[2], ref[3])
           and torch.equal(tfp[1][:, :286], ref[1][:, :286]) and torch.equal(tfp[4], ref[2]),
           "tokens_from_pairs differs from tokenize_compact on the slice bitmaps")
    print(f"  tokens_from_pairs equals tokenize_compact on the slice bitmaps "
          f"({int(tfp[2].sum())} tokens from {int(pcounts.sum())} pairs)")
    # an all-zero row (the sentinel alone), a gap over 1549 bytes, a nonzero
    # run of 4 (flagged), then a bound below the counts
    m = 60000
    rows = (rng.integers(1, 256, (5, m)) * (rng.random((5, m)) < 0.02)).astype(np.uint8)
    rows[1] = 0
    rows[2, 100:40000] = 0
    rows[3, 500:504] = 9
    e_pairs, e_counts = hopper_encode.bitmap_pairs(torch.from_numpy(rows).to(device), m)
    e_full = hopper_tokens.tokens_from_pairs_plain(e_pairs, e_counts, m, 4 * m)[2]
    for b in (int(e_full.max()), int(e_full.min()) // 2):
        got = hopper_tokens.tokens_from_pairs(e_pairs, e_counts, m, b)
        check("tokens_from_pairs", got,
              hopper_tokens.tokens_from_pairs_plain(e_pairs, e_counts, m, b),
              f"edge battery, tok_bound {b}")
        expect(got[3].tolist() == [False, False, False, True, False],
               f"tokens_from_pairs flags {got[3].tolist()}")
        expect(torch.equal(got[2], e_full), "tokens_from_pairs counts are not exact")

    timed = {}
    for what, streams, lengths in (("slice bitmaps", bitmap, full), ("slice values", packed, plens)):
        tok, hist, _ = hopper_deflate.tokenize(streams, lengths)
        n_tok = int(hist[:, :286].sum(dim=1).max())
        comp_tok = hopper_deflate.tokenize_compact(streams, lengths, n_tok)[0]
        tables = host_tables(hist, device)
        out_bound = 2 * streams.shape[1] + 256
        for kind, t in (("u16", tok), ("i32 compacted", comp_tok)):
            for ob in (out_bound, 300):
                got = hopper_deflate.assemble_split(t, *tables, ob)
                check("assemble_split", got, hopper_deflate.assemble_plain(t, *tables, ob),
                      f"{what}, {kind} tokens, out_bound {ob}")
                expect(max_abs_err(got, hopper_deflate.assemble(t, *tables, ob)) == 0,
                       f"assemble_split differs from assemble on {what}, {kind} tokens")
        if what == "slice bitmaps":
            timed["assemble_split"] = (
                lambda t=comp_tok, a=tables, o=out_bound: hopper_deflate.assemble_split(t, *a, o),
                lambda t=comp_tok, a=tables, o=out_bound: hopper_deflate.assemble_plain(t, *a, o),
                io_bytes(comp_tok, tables, hopper_deflate.assemble_split(comp_tok, *tables,
                                                                         out_bound)), None)

    words = hopper_bitpack.bitpack12_words(comp)
    check("bitpack12_words", [words], [hopper_bitpack.bitpack12_words_plain(comp)], "slice values")
    expect(torch.equal(words.view(torch.uint8), packed), "bitpack12_words bytes differ from bitpack12's")
    wide = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 1000008)).astype(np.int32)).to(device)
    check("bitpack12_words", [hopper_bitpack.bitpack12_words(wide)],
          [hopper_bitpack.bitpack12_words_plain(wide)], "random int32, n = 1000008")

    # no PyTorch call computes these functions; the pairs tokenizer reads the
    # valid pairs and writes its outputs
    timed.update({
        "encode_l1_pairs": (
            lambda: hopper_encode.encode_l1(frames, thr, out_size, pairs_out=out_size),
            lambda: hopper_encode.encode_l1_plain(frames, thr, out_size, pairs_out=out_size),
            io_bytes(frames, thr, enc), None),
        "tokens_from_pairs": (
            lambda: hopper_tokens.tokens_from_pairs(pairs, pcounts, n, bound),
            lambda: hopper_tokens.tokens_from_pairs_plain(pairs, pcounts, n, bound),
            4 * int(pcounts.sum()) + io_bytes(pcounts, tfp), None),
        "bitpack12_words": (lambda: hopper_bitpack.bitpack12_words(comp),
                            lambda: hopper_bitpack.bitpack12_words_plain(comp),
                            io_bytes(comp, words), None),
    })
    return timed


def _pass_name(event) -> str:
    """A device interval's short name: a kernel's own name without its
    namespace, template arguments and parameters; else its category."""
    if event["cat"] != "kernel":
        return event["cat"]
    name = event["name"].replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip() or "kernel"


def device_passes(fn) -> dict:
    """Device ms of each kernel, memset and memcpy of one call of ``fn``
    after a warm-up call, in launch order, from one profiling.trace; a name
    met again in the call gets " #2", " #3", ..."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):   # a trace can come back without its device intervals
        with tempfile.TemporaryDirectory(prefix="tmp_chip_smoke_", dir=REPO) as tmp:
            with trace(tmp):
                torch.cuda._sleep(1000)   # a kernel of its own ahead of the call's first
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
            events = json.loads(next(Path(tmp).glob("*.pt.trace.json")).read_text())[
                "traceEvents"]
        device = sorted((e for e in events if e.get("ph") == "X"
                         and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
                         and "spin_kernel" not in e.get("name", "")),
                        key=lambda e: float(e["ts"]))
        if device:
            break
    expect(device, "three traces of the call hold no device interval")
    passes, seen = {}, Counter()
    for e in device:
        name = _pass_name(e)
        seen[name] += 1
        passes[name if seen[name] == 1 else f"{name} #{seen[name]}"] = float(e["dur"]) / 1e3
    return passes


def check_kernels(device, rng, n_frames=4, height=4096, width=4096, reps=20, plain_reps=3):
    """Phase 3: every kernel against its twin (exactly) on edge cases and at
    the slice's shapes; returns {name: {max_abs_err, ms, plain_ms}}."""
    frames_np, dark = make_frames(rng, n_frames, height, width)
    thr_np = dark + EPSILON
    frames = torch.from_numpy(frames_np).to(device)
    thr = torch.from_numpy(thr_np).to(device)
    counts = hopper_encode.encode_l1_plain(frames, thr, 0, with_values=False)[2]
    out_size = _bucket_for(int(counts.max()), height * width)
    print(f"slice shapes: frames {tuple(frames.shape)}, foreground counts {counts.tolist()}, "
          f"value buffer {out_size}")
    err = dict.fromkeys(KERNELS, 0)

    def check(name, got, want, what):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        e = max_abs_err(got, want)
        print(f"  {name:16s} {what:44s} max_abs_err {e}")
        if e:
            raise AssertionError(f"{name} disagrees with its twin on {what}")
        err[name] = max(err[name], e)

    # edge frames: ~20% foreground, all zero, odd count
    edge_np, _ = make_frames(rng, 3, height, width, occupancy=0.2)
    edge_np[1] = 0
    odd = rng.random((height, width)) < 0.001
    if odd.sum() % 2 == 0:
        odd[0, 0] = not odd[0, 0]
    edge_np[2] = np.where(odd, thr_np + 7, thr_np).astype(np.uint16)
    edge = torch.from_numpy(edge_np).to(device)
    edge_counts = hopper_encode.encode_l1_plain(edge, thr, 0, with_values=False)[2]
    expect(edge_counts[1] == 0 and int(edge_counts[2]) % 2 == 1, edge_counts)
    ragged_np, ragged_dark = make_frames(rng, 3, 37, 29, occupancy=0.3)
    ragged = torch.from_numpy(ragged_np).to(device)
    ragged_thr = torch.from_numpy(ragged_dark + EPSILON).to(device)

    enc_cases = [
        ("slice", frames, thr, out_size, True),
        ("slice L3", frames, thr, 0, False),
        ("20%/zero/odd frames", edge, thr, _bucket_for(int(edge_counts.max()), height * width),
         True),
        ("out_size < count", frames, thr, int(counts.min()) // 2, True),
        ("37x29 frames", ragged, ragged_thr, 1024, True),
    ]
    for what, f, t, size, with_values in enc_cases:
        got = hopper_encode.encode_l1(f, t, size, with_values)
        want = hopper_encode.encode_l1_plain(f, t, size, with_values)
        check("encode_l1", got, want, what)
        if what == "out_size < count":
            expect(bool(got[3].all()), "overflow must be set when out_size < count")
        else:
            expect(not bool(got[3].any()), "unexpected overflow")

    bitmap, comp, counts_dev, _ = hopper_encode.encode_l1(frames, thr, out_size)
    packed = hopper_bitpack.bitpack12(comp)
    check("bitpack12", [packed], [hopper_bitpack.bitpack12_plain(comp)], "slice values")
    wide = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 1000002)).astype(np.int32)).to(device)
    check("bitpack12", [hopper_bitpack.bitpack12(wide)], [hopper_bitpack.bitpack12_plain(wide)],
          "random int32 (n % 262144 != 0)")

    # one frame against the host oracle
    enc = oracle.reduce_frame(frames_np[0], thr_np, 1, 12)
    plen = (int(counts_dev[0]) * 12 + 7) // 8
    expect(bitmap[0].cpu().numpy().tobytes() == enc["packed_binary_map"], "bitmap vs oracle")
    expect(packed[0, :plen].cpu().numpy().tobytes() == enc["packed_pixvals"], "values vs oracle")
    print("  frame 0 bitmap and packed values equal oracle.reduce_frame")

    values = hopper_bitpack.bitunpack12(packed)
    check("bitunpack12", [values], [hopper_bitpack.bitunpack12_plain(packed)], "slice stream")
    noise = torch.from_numpy(rng.integers(0, 256, (3, 300003), dtype=np.uint8)).to(device)
    check("bitunpack12", [hopper_bitpack.bitunpack12(noise)],
          [hopper_bitpack.bitunpack12_plain(noise)], "random bytes")

    dec_cases = [
        ("slice", bitmap, values, height, width),
        ("values < count", bitmap, values[:, : int(counts.min()) // 2].contiguous(), height,
         width),
    ]
    edge_bm, edge_comp = hopper_encode.encode_l1(edge, thr, enc_cases[2][3])[:2]
    dec_cases.append(("20%/zero/odd frames", edge_bm, edge_comp, height, width))
    rbm, rcomp = hopper_encode.encode_l1(ragged, ragged_thr, 1024)[:2]
    dec_cases.append(("37x29 frames", rbm, rcomp, 37, 29))
    for what, bm, vals, h, w in dec_cases:
        got = hopper_decode.decode_l1(bm, vals, h, w)
        check("decode_l1", got, hopper_decode.decode_l1_plain(bm, vals, h, w), what)
        if what == "values < count":
            expect(bool(got[1].all()), "overflow must be set when values < count")
        else:
            expect(not bool(got[1].any()), f"unexpected overflow on {what}")
    # a generator of its own, so that the later phases' data stay as they were
    battery_rng = np.random.default_rng(SEED + 3)
    for shape in DECODE_SHAPES:
        for case in ("30%", "edges"):
            bm_np, values_list = decode_battery(battery_rng, shape, case)
            bm = torch.from_numpy(bm_np).to(device)
            for vals in (torch.from_numpy(v).to(device) for v in values_list):
                check("decode_l1", hopper_decode.decode_l1(bm, vals, *shape),
                      hopper_decode.decode_l1_plain(bm, vals, *shape),
                      f"{shape[0]}x{shape[1]} {case}, V {vals.shape[1]}")
    dense = hopper_decode.decode_l1(bitmap, values, height, width)[0]
    expected = np.where(frames_np > thr_np, frames_np - thr_np, 0)
    expect(np.array_equal(dense.cpu().numpy(), expected), "decode of encode != residuals")

    plens = (counts_dev * 12 + 7) // 8
    deflate_timed = check_deflate(device, rng, check, bitmap, packed, plens)
    rans_timed = check_rans(device, rng, check, frames, thr, out_size, packed)
    tokens_timed = check_rans_tokens(device, rng, check, bitmap)
    label_timed, label_modes = check_label(device, rng, check, n_frames, height, width)
    alt_timed = check_alternates(device, rng, check, frames, thr, out_size, enc_cases, bitmap,
                                 comp, packed, plens)

    if device.type != "cuda":
        return {name: {"max_abs_err": e} for name, e in err.items()}
    # no PyTorch call encodes, packs or decodes these formats
    timed = {
        "encode_l1": (lambda: hopper_encode.encode_l1(frames, thr, out_size),
                      lambda: hopper_encode.encode_l1_plain(frames, thr, out_size),
                      io_bytes(frames, thr, hopper_encode.encode_l1(frames, thr, out_size)), None),
        "bitpack12": (lambda: hopper_bitpack.bitpack12(comp),
                      lambda: hopper_bitpack.bitpack12_plain(comp), io_bytes(comp, packed), None),
        "bitunpack12": (lambda: hopper_bitpack.bitunpack12(packed),
                        lambda: hopper_bitpack.bitunpack12_plain(packed),
                        io_bytes(packed, values), None),
        "decode_l1": (lambda: hopper_decode.decode_l1(bitmap, values, height, width),
                      lambda: hopper_decode.decode_l1_plain(bitmap, values, height, width),
                      io_bytes(bitmap, values, hopper_decode.decode_l1(bitmap, values, height,
                                                                       width)), None),
    }
    out = {}

    def report(name, what):
        r = out[name]
        lib = "" if r["library_ms"] is None else f", library call {r['library_ms']:.4f} ms"
        print(f"  {name:16s} kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms{lib} (CUDA events, {what} of the {tuple(frames.shape)} "
              "batch)")

    for name, entry in timed.items():
        out[name] = measure(entry, err[name], reps, plain_reps)
        report(name, "frames")
    # kernel #1a: the same launch storing the values' positions (scheme 12)
    pos_entry = (lambda: hopper_encode.encode_l1(frames, thr, out_size, True, True, 12),
                 lambda: hopper_encode.encode_l1_plain(frames, thr, out_size, True, True, 12),
                 io_bytes(frames, thr, hopper_encode.encode_l1(frames, thr, out_size, True, True,
                                                               12)), None)
    pos_stats = measure(pos_entry, err["encode_l1"], reps, plain_reps)
    out["encode_l1"].update({f"positions_{k}": pos_stats[k] for k in ("ms", "plain_ms", "bound_ms")})
    print(f"  encode_l1        with positions: kernel {pos_stats['ms']:.4f} ms, bound "
          f"{pos_stats['bound_ms']:.4f} ms, plain twin {pos_stats['plain_ms']:.4f} ms")
    # the kernels line carries the bitmap streams' times (8 MiB a batch)
    for what in ("slice values", "slice bitmaps"):
        for name, entry in deflate_timed[what].items():
            out[name] = measure(entry, err[name], reps, plain_reps)
            report(name, what)
    # ... and the gap streams' (the bitmaps of scheme 12)
    for what in ("slice values", "slice gaps"):
        for name, entry in rans_timed[what].items():
            out[name] = measure(entry, err[name], reps, plain_reps)
            report(name, what)
    out["rans_encode_tokens"] = measure(tokens_timed, err["rans_encode_tokens"], reps, plain_reps)
    report("rans_encode_tokens", "slice bitmap tokens")
    # L2 sum and the L2/L3 bitmaps of the puddle batch; the other modes' times beside
    for name, entry in label_timed.items():
        out[name] = measure(entry, err[name], reps, plain_reps)
        report(name, "puddle frames" if name == "label_l2l4" else "bitmaps")
    out["label_l2l4"]["mode_ms"] = {m: cuda_event_time(fn, reps, 1)
                                    for m, fn in label_modes.items()}
    print(f"  label_l2l4       kernel ms by mode: {out['label_l2l4']['mode_ms']}")
    for name, entry in alt_timed.items():
        out[name] = measure(entry, err[name], reps, plain_reps)
        report(name, "slice bitmaps" if name in ("tokens_from_pairs", "assemble_split") else
               "frames" if name == "encode_l1_pairs" else "slice values")
    # each pass (and each memset) of one call, from one profiler trace
    for name, fn in (("encode_l1", timed["encode_l1"][0]),
                     ("label_l2l4", label_modes["l2sum"]),
                     ("posdecode", rans_timed["slice gaps"]["posdecode"][0]),
                     ("tokenize", deflate_timed["slice bitmaps"]["tokenize"][0]),
                     ("assemble", deflate_timed["slice bitmaps"]["assemble"][0]),
                     ("assemble_split", alt_timed["assemble_split"][0]),
                     ("decode_l1", timed["decode_l1"][0]),
                     ("rans_hist", rans_timed["slice gaps"]["rans_hist"][0]),
                     ("tokenize_compact", deflate_timed["slice bitmaps"]["tokenize_compact"][0]),
                     ("tokens_from_pairs", alt_timed["tokens_from_pairs"][0]),
                     ("rans_decode", rans_timed["slice gaps"]["rans_decode"][0]),
                     ("rans_encode", rans_timed["slice gaps"]["rans_encode"][0]),
                     ("rans_encode_tokens", tokens_timed[0]),
                     ("bitmap_positions", label_timed["bitmap_positions"][0])):
        out[name]["pass_ms"] = device_passes(fn)
        print(f"  {name:16s} device operations of one call (torch.profiler, ms): "
              f"{out[name]['pass_ms']}")
    # adler32 comes out of the pairs tokenizer's own kernels, no torch op; the
    # encodes, the decode and the positions run no torch op either
    for name, passes in (("encode_l1", ENCODE_L1_PASSES),
                         ("assemble", ASSEMBLE_PASSES),
                         ("assemble_split", ASSEMBLE_SPLIT_PASSES),
                         ("decode_l1", DECODE_L1_PASSES),
                         ("rans_hist", RANS_HIST_PASSES),
                         ("tokens_from_pairs", TOKENS_FROM_PAIRS_PASSES),
                         ("rans_decode", RANS_DECODE_PASSES),
                         ("rans_encode", RANS_ENCODE_PASSES),
                         ("rans_encode_tokens", RANS_ENCODE_PASSES),
                         ("bitmap_positions", BITMAP_POSITIONS_PASSES)):
        expect(set(out[name]["pass_ms"]) == set(passes),
               f"{name} ran {sorted(out[name]['pass_ms'])}")
    return out


L2_STATISTICS = {"max": 1, "sum": 2}
L4_CENTROIDING = {"weighted_average": 1, "max": 2, "unweighted": 3}


def slice_params(n_frames: int, height: int, width: int, num_threads: int, scheme: int = 0,
                 level: int = 1, statistic=None, bit_depth: int = 12, data_type: int = 0):
    """Mode 1 parameters of a slice at compression scheme 0 or 12 and
    reduction ``level`` (L1 by default), with ``statistic`` the L2 summary
    statistic or the L4 centroiding scheme, ``bit_depth``-bit (12 by
    default), unsigned sources (``data_type`` 0) or signed ones (1)."""
    params = port.InputParams(dict(
        reduction_level=level, rc_operation_mode=1, calibration_threshold_epsilon=EPSILON,
        target_bit_depth=bit_depth, source_bit_depth=bit_depth, num_cols=width, num_rows=height,
        num_frames=n_frames, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=num_threads,
        l2_statistics=L2_STATISTICS.get(statistic, 0) if level == 2 else 0,
        l4_centroiding=L4_CENTROIDING.get(statistic, 0) if level == 4 else 0,
        compression_scheme=scheme, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=data_type, target_data_type=data_type))
    if not params.validate():
        raise ValueError("invalid input params")
    return params


def run_slice(device, data, dark, work_dir: Path, num_threads=2, scheme=0):
    """Phases 4 and 6: server -> part files -> merge -> reader on frames
    ``data`` (n, h, w) u16 (or int16, as signed sources) at compression
    scheme 0 or 12; returns (launch counts of the run, write s, read s,
    merged file).  Scheme 12 reads through the gap chain, then again with
    verify=True (the byte path)."""
    n_frames, height, width = data.shape
    thr = dark + EPSILON
    expected = np.where(data > thr, data.astype(np.int64) - thr, 0)
    init_params = port.InitParams("batch", str(work_dir), image_filename="smoke",
                                  log_filename=str(work_dir / "recode.log"),
                                  run_name="chip_smoke", verbosity=0)
    input_params = slice_params(n_frames, height, width, num_threads, scheme,
                                data_type=int(np.issubdtype(data.dtype, np.signedinteger)))

    server = port.ReCoDeServer("batch", device=device)
    port.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    metrics = server.run(init_params, input_params, dark_data=dark, data=data)
    merged = port.merge_parts(str(work_dir), "smoke.rc1", num_threads)
    write_s = time.perf_counter() - t0
    statuses = [node.status for node in server._nodes]
    frames_done = sum(m.get("run_frames", 0) for m in metrics.values())
    if statuses != [rc.STATUS_CODE_IS_CLOSED] * num_threads or frames_done != n_frames:
        print((work_dir / "recode.log").read_text())
        raise RuntimeError(f"server run failed: statuses {statuses}, {frames_done} frames")

    stages = {}
    for m in metrics.values():
        for key, value in m.items():
            if key.endswith("_time") and key != "run_data_read_time":
                stages[key] = stages.get(key, 0.0) + value.total_seconds()
    print(f"scheme {scheme} writer stage seconds, summed over nodes: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    reader = port.ReCoDeReader(merged, device=device)
    reader.open()
    t0 = time.perf_counter()
    dense = reader.read_frames_dense(0, n_frames)
    read_s = time.perf_counter() - t0
    if not np.array_equal(dense, expected):
        raise AssertionError(f"scheme {scheme}: read_frames_dense differs from the residuals")
    if scheme == 12:
        t0 = time.perf_counter()
        verified = reader.read_frames_dense(0, n_frames, verify=True)
        print(f"scheme 12 read with verify=True (byte path, adler-checked): "
              f"{time.perf_counter() - t0:.3f} s")
        if not np.array_equal(verified, expected):
            raise AssertionError("scheme 12: read_frames_dense(verify=True) differs")
    launches = port.kernel_launch_counts()
    for z in range(n_frames):
        host = reader.get_frame(z)[z]["data"].toarray()
        if not np.array_equal(host, expected[z]):
            raise AssertionError(f"scheme {scheme}: host sparse decode of frame {z} differs")
    reader.close()
    print(f"slice, scheme {scheme}: {n_frames} frames {height}x{width}, {num_threads} nodes, "
          f"merged {Path(merged).stat().st_size} bytes; read_frames_dense and get_frame bit-exact")
    return launches, write_s, read_s, merged


def signed_frames(data, dark, rng):
    """The frames and dark frame as an int16 source: 16 below their uint16
    values (negative darks), and 1% of the background at -2000, which only a
    signed comparison keeps out of the foreground."""
    frames = data.astype(np.int16) - 16
    low = (rng.random(data.shape) < 0.01) & (data <= dark + EPSILON)
    frames[low] = -2000
    return frames, dark.astype(np.int16) - 16


def run_signed_slices(device, data, dark, work_dir: Path) -> dict:
    """Phase 6b: an int16 source (signed_frames of ``data``) through the
    server -> merge -> reader at schemes 0 and 12: the L1 encode kernel and
    the value pack on the sign-flipped frames (with positions at scheme 12),
    the entropy and decode kernels, all on the card, each of the path's
    kernels launched; the reads exact against the residuals.  Returns each
    scheme's launch counts."""
    launches = {}
    for scheme, kernels in ((0, SIGNED_SCHEME0_KERNELS), (12, SCHEME12_KERNELS)):
        (work_dir / f"signed{scheme}").mkdir()
        counts, write_s, read_s, _ = run_slice(device, data, dark, work_dir / f"signed{scheme}",
                                               num_threads=1, scheme=scheme)
        print(f"int16 source, scheme {scheme}: write {write_s:.3f} s, read {read_s:.3f} s; "
              f"launches {counts}")
        missing = [name for name in kernels if counts[name] == 0]
        expect(not missing, f"kernels not launched by the int16 scheme-{scheme} path: {missing}")
        launches[scheme] = counts
    return launches


def check_scheme12_streams(device, data, dark, merged, batch=4):
    """Phase 6: every stream of the scheme-12 merged file decodes through the
    host rans.decompress to the raw bitmap and packed values the encode
    kernel makes; for the first batch the device coders on CUDA tensors give
    the bytes they give on CPU tensors (the twins)."""
    n, height, width = data.shape
    thr = torch.from_numpy((dark + EPSILON).astype(np.uint16)).to(device)
    reader = port.ReCoDeReader(merged, device=device)
    reader.open()
    records = [reader.get_next_frame_raw()[z]["data"] for z in range(n)]
    reader.close()
    kinds = {}
    for start in range(0, n, batch):
        frames = torch.from_numpy(data[start:start + batch]).to(device)
        fg = hopper_encode.encode_l1_plain(frames, thr, 0, with_values=False)[2]
        bitmap, comp, counts, _ = hopper_encode.encode_l1(
            frames, thr, 2 * ((int(fg.max()) + 1) // 2))
        packed = hopper_bitpack.bitpack12(comp)
        for i in range(frames.shape[0]):
            rec = records[start + i]
            plen = (int(counts[i]) * 12 + 7) // 8
            for stream, raw in ((rec["binary_map"], bitmap[i].cpu().numpy().tobytes()),
                                (rec["pixvals"], packed[i, :plen].cpu().numpy().tobytes())):
                h = rans._parse_header(stream)
                kind = "stored" if "stored" in h else \
                    f"{'gap' if h.get('gap') else 'symbol'}/{h['nways']} lanes"
                kinds[kind] = kinds.get(kind, 0) + 1
                expect(rans.decompress(stream) == raw,
                       f"frame {start + i}: a stream does not decode to its raw bytes")
    print(f"host rans.decompress: all {2 * n} streams of the merged file decode to the raw "
          f"streams ({kinds})")

    frames = torch.from_numpy(data[:batch]).to(device)
    fg = hopper_encode.encode_l1_plain(frames, thr, 0, with_values=False)[2]
    res = encode_frames_auto(frames, thr, 1, 12,
                             max_values=_bucket_for(int(fg.max()), height * width),
                             with_positions=True)
    lens = np.full(batch, res.bitmap.shape[1], np.int32)
    plens = res.packed_len.cpu().numpy()
    def coded(where):
        return (rans.rans_gaps_batch_device(res.bitmap.to(where), lens,
                                            positions=res.positions.to(where),
                                            pos_counts=res.counts.to(where)),
                rans.rans_symbols_batch_device(res.packed.to(where), plens, 12))

    expect(coded(device) == coded(torch.device("cpu")),
           "scheme-12 coders on CUDA and CPU tensors differ")
    print(f"scheme-12 coders: gap and symbol streams of {batch} frames equal on CUDA and CPU "
          "tensors")


def run_8bit_scheme12(device, data, dark, work_dir: Path) -> dict:
    """Phase 6, 8-bit values: one writer with the card's default entropy
    (device_entropy=None) writes 8-bit frames at L1, scheme 12; both streams
    must be coded on the device (the rANS histogram and encode launched, the
    values as 8-bit symbols at kernel lane counts), every stream must decode
    through the host rans.decompress to its raw stream, and the merged file
    must read back exactly.  ``data`` (n, h, w) and ``dark`` (h, w) uint8.
    Returns the writer's launch counts."""
    n, height, width = data.shape
    thr = (dark.astype(np.int64) + EPSILON).astype(np.uint8)
    writer = port.ReCoDeWriter("eight", dark_data=dark, output_directory=str(work_dir),
                               input_params=slice_params(n, height, width, 1, 12, bit_depth=8),
                               device=device)
    expect(writer._device_entropy, "8-bit scheme-12 device entropy is not the default on the card")
    port.reset_kernel_launch_counts()
    writer.start()
    writer.run(data)
    writer.close()
    launches = port.kernel_launch_counts()
    expect(launches["rans_hist"] > 0 and launches["rans_encode"] > 0,
           f"8-bit scheme 12: the rANS kernels were not launched ({launches})")
    reader = port.ReCoDeReader(port.merge_parts(str(work_dir), "eight.rc1", 1), device=device)
    reader.open()
    records = [reader.get_next_frame_raw()[z]["data"] for z in range(n)]
    read = reader.read_frames_dense(0, n)
    reader.close()
    kinds = Counter()
    for z, rec in enumerate(records):
        enc = oracle.reduce_frame(data[z], thr, 1, 8)
        hp = rans._parse_header(rec["pixvals"])
        expect(hp.get("sym_bits") == 8 and hp["nways"] in rans.KERNEL_NWAYS,
               f"8-bit frame {z}: the values were not coded on the device as 8-bit symbols")
        expect(rans.decompress(rec["pixvals"]) == bytes(enc["packed_pixvals"]),
               f"8-bit frame {z}: the value stream does not decode to the values")
        expect(rans.decompress(rec["binary_map"]) == bytes(enc["packed_binary_map"]),
               f"8-bit frame {z}: the bitmap stream does not decode to the bitmap")
        hb = rans._parse_header(rec["binary_map"])
        kinds[f"bitmap {'gap' if hb.get('gap') else 'symbol'}/{hb['nways']}, "
              f"values symbol/{hp['nways']}"] += 1
    expect(np.array_equal(read, np.where(data > thr, data - thr, 0)),
           "8-bit scheme 12: read_frames_dense differs from the residuals")
    print(f"8-bit scheme 12: {n} frames {height}x{width}, one writer, device entropy by default; "
          f"streams {dict(kinds)}; every stream decodes through rans.decompress; read exact; "
          f"rans_hist {launches['rans_hist']}, rans_encode {launches['rans_encode']} launches")
    return launches


def compare_entropy_paths(device, data, dark, work_dir: Path, level: int = 1, statistic=None):
    """Phase 5 (and phase 7 at L4): one node writes all of ``data`` into a
    part file with device entropy and with host entropy, in the order
    device, host, host, device; every part file must equal the first byte
    for byte.  Returns the write seconds (writer start to close) of each
    path."""
    params = slice_params(*data.shape, num_threads=1, level=level, statistic=statistic)
    first = None
    seconds = {True: [], False: []}
    for k, device_entropy in enumerate((True, False, False, True)):
        out = work_dir / f"entropy_L{level}_{k}"
        out.mkdir()
        t0 = time.perf_counter()
        writer = port.ReCoDeWriter("smoke", dark_data=dark, output_directory=str(out),
                                   input_params=params, device=device,
                                   device_entropy=device_entropy)
        expect(writer._device_entropy is device_entropy, "device_entropy was not taken")
        writer.start()
        writer.run(data)
        writer.close()
        seconds[device_entropy].append(time.perf_counter() - t0)
        part = (out / f"smoke.rc{level}_part000").read_bytes()
        first = part if first is None else first
        expect(part == first, f"part file {k} (device_entropy={device_entropy}) differs from "
                              "the device-entropy one")
    print(f"entropy paths, L{level}: {data.shape[0]} frames {data.shape[1]}x{data.shape[2]}, "
          f"one node; device- and host-entropy part files byte-equal ({len(first)} bytes)")
    return seconds


def plain_level_streams(device, data, dark, level: int, statistic, batch: int = 4):
    """The plain versions' bitmaps (n, ceil(h*w/8)) and, at L2, the packed
    statistics stream of each frame, batch by batch as the writer sizes it."""
    n, height, width = data.shape
    thr = torch.from_numpy((dark + EPSILON).astype(np.uint16)).to(device)
    bitmaps, stats = [], []
    for start in range(0, n, batch):
        frames = torch.from_numpy(data[start:start + batch]).to(device)
        if level == 3:
            bitmaps.append(hopper_encode.encode_l1_plain(frames, thr, 0, with_values=False)[0])
            continue
        fg = hopper_encode.encode_l1_plain(frames, thr, 0, with_values=False)[2]
        mode = hopper_label.MODE_BY_CONFIG[(level, statistic)]
        bm, st, counts, _ = hopper_label.encode_l2l4_plain(
            frames, thr, mode, _bucket_for(int(fg.max()), height * width), 4095)
        bitmaps.append(bm)
        if st is not None:
            packed = bitpack_values(st, 12).cpu().numpy()
            for i, c in enumerate(counts.tolist()):
                stats.append(packed[i, :(c * 12 + 7) // 8].tobytes())
    return torch.cat(bitmaps).cpu().numpy(), stats


def run_level_slice(device, data, dark, work_dir: Path, level: int, statistic, scheme: int,
                    num_threads: int = 2):
    """Phase 7: server -> part files -> merge -> reader at reduction ``level``
    2, 3 or 4; read_frames_dense bit-exact against the plain version's
    bitmaps on every frame and against oracle.reduce_frame on two; at L2 the
    summary_stats of get_frame equal the oracle's on those two; at scheme 12
    every stream of the merged file decodes through the host
    rans.decompress to its raw stream.  Returns (launch counts of the
    server run and the dense read, write s, read s)."""
    n_frames, height, width = data.shape
    tag = f"L{level} {statistic or ''} scheme {scheme}".replace("  ", " ")
    init_params = port.InitParams("batch", str(work_dir), image_filename="smoke",
                                  log_filename=str(work_dir / "recode.log"),
                                  run_name="chip_smoke", verbosity=0)
    server = port.ReCoDeServer("batch", device=device)
    port.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    metrics = server.run(init_params, slice_params(n_frames, height, width, num_threads, scheme,
                                                   level, statistic),
                         dark_data=dark, data=data)
    merged = port.merge_parts(str(work_dir), f"smoke.rc{level}", num_threads)
    write_s = time.perf_counter() - t0
    statuses = [node.status for node in server._nodes]
    if statuses != [rc.STATUS_CODE_IS_CLOSED] * num_threads or \
            sum(m.get("run_frames", 0) for m in metrics.values()) != n_frames:
        print((work_dir / "recode.log").read_text())
        raise RuntimeError(f"{tag}: server run failed: statuses {statuses}")
    reader = port.ReCoDeReader(merged, device=device)
    reader.open()
    t0 = time.perf_counter()
    dense = reader.read_frames_dense(0, n_frames)
    read_s = time.perf_counter() - t0
    launches = port.kernel_launch_counts()

    bitmaps, stats = plain_level_streams(device, data, dark, level, statistic)
    expected = unpack_bits(torch.from_numpy(bitmaps))[:, :height * width].numpy()
    expect(np.array_equal(dense, expected.reshape(n_frames, height, width)),
           f"{tag}: read_frames_dense differs from the plain version's bitmaps")
    thr_np = dark + EPSILON
    for z in (0, n_frames - 1):
        enc = oracle.reduce_frame(data[z], thr_np, level, 12, l2_statistic=statistic or "max",
                                  l4_scheme=statistic or "weighted_average")
        expect(bitmaps[z].tobytes() == enc["packed_binary_map"],
               f"{tag}: frame {z} bitmap differs from oracle.reduce_frame")
        if level == 2:
            labels, num = oracle.label_components(data[z] > thr_np)
            want = np.minimum(oracle.l2_summary_stats(labels, data[z], num, statistic), 4095)
            got = reader.get_frame(z)[z]["summary_stats"]
            expect(np.array_equal(got, want),
                   f"{tag}: frame {z} summary_stats differ from the oracle")
            expect(stats[z] == enc["packed_pixvals"], f"{tag}: frame {z} statistics stream differs")
    reader.close()
    kinds = {}
    if scheme == 12:
        reader = port.ReCoDeReader(merged, device=device)
        reader.open()
        for z in range(n_frames):
            rec = reader.get_next_frame_raw()[z]["data"]
            raws = [(rec["binary_map"], bitmaps[z].tobytes())]
            if level == 2:
                raws.append((rec["pixvals"], stats[z]))
            for stream, raw in raws:
                h = rans._parse_header(stream)
                kind = "stored" if "stored" in h else \
                    f"{'gap' if h.get('gap') else 'byte' if 'sym_bits' not in h else 'symbol'}" \
                    f"/{h['nways']} lanes"
                kinds[kind] = kinds.get(kind, 0) + 1
                expect(rans.decompress(stream) == raw,
                       f"{tag}: frame {z}: a stream does not decode to its raw bytes")
        reader.close()
    print(f"slice, {tag}: {n_frames} frames {height}x{width}, {num_threads} nodes, merged "
          f"{Path(merged).stat().st_size} bytes; read_frames_dense bit-exact against the plain "
          f"version, frames 0 and {n_frames - 1} against the oracle"
          + (f"; host rans.decompress of every stream exact ({kinds})" if kinds else ""))
    return launches, write_s, read_s


def multidevice_rank(rank: int, world: int, port_no: int, device: str, frames_path: str,
                     threshold_path: str, out_size: int, out_path: str) -> None:
    """Phase 8 (b), one rank of a gloo process group: encode this rank's
    contiguous half of the frames on a one-device mesh and gather the blocks
    to rank 0, which writes them to ``out_path``."""
    import pickle

    import torch.distributed as dist

    from pyrecode_tpu_torch.parallel import make_codec_mesh
    from pyrecode_tpu_torch.parallel.multihost import (gather_ordered_blocks, make_encode_step,
                                                       replicate_threshold)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port_no}", world_size=world,
                            rank=rank)
    frames = np.load(frames_path, mmap_mode="r")
    share = frames.shape[0] // world
    local = np.array(frames[rank * share:(rank + 1) * share])
    mesh = make_codec_mesh(1, 1, [device])
    step = make_encode_step(mesh, out_size, bit_depth=12)
    bitmap, packed, counts, overflow = step(local, replicate_threshold(np.load(threshold_path),
                                                                       mesh))
    expect(not overflow.numpy().any(), f"rank {rank}: encode overflow")
    blocks = gather_ordered_blocks(bitmap, packed, counts, bit_depth=12)
    expect((blocks is not None) == (rank == 0), f"rank {rank}: gathered blocks on the wrong rank")
    if rank == 0:
        with open(out_path, "wb") as fp:
            pickle.dump(blocks, fp)
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_multidevice(device, data, thr, puddles, pthr, work_dir: Path):
    """Phase 8: (a) dryrun_multidevice on a 2 x 1 mesh and a 2 x 2 mesh
    (shard_rows) of ``device`` repeated, (b) MD_WORLD processes of a gloo
    group, each encoding its contiguous share of the frames on ``device``,
    whose gathered blocks must equal (a)'s.  Returns (the launches of (a)'s
    own steps, as the dryruns count them, without those of the references
    they are checked against; walls by step and mesh; (b)'s wall)."""
    import multiprocessing
    import pickle

    from pyrecode_tpu_torch.parallel import dryrun_multidevice

    port.reset_kernel_launch_counts()
    reports, dryrun_s = {}, {}
    for n_data, n_space in ((2, 1), (2, 2)):
        n = n_data * n_space
        t0 = time.perf_counter()
        reports[n_data, n_space] = dryrun_multidevice(n, [device] * n, n_space=n_space,
                                                      data=(data, thr), puddles=(puddles, pthr))
        dryrun_s[f"{n_data}x{n_space}"] = time.perf_counter() - t0
    launches = Counter()
    for rep in reports.values():
        launches.update(rep["launches"])
    blocks = reports[2, 1]["blocks"]
    expect(reports[2, 2]["blocks"] == blocks, "the 2 x 2 mesh gathered other blocks than 2 x 1")
    for (n_data, n_space), rep in reports.items():
        print(f"  dryrun_multidevice {n_data} x {n_space}: {len(rep['blocks'])} frames "
              f"{data.shape[1]}x{data.shape[2]}, every check passed; rans_batch_device streams "
              f"{rep['rans_batch_device']}")

    frames_path, thr_path = work_dir / "md_frames.npy", work_dir / "md_threshold.npy"
    np.save(frames_path, data)
    np.save(thr_path, thr)
    out_path = work_dir / "md_blocks.pkl"
    out_size = int(count_foreground(torch.from_numpy(data).to(device),
                                    torch.from_numpy(thr).to(device)).max())
    ctx = multiprocessing.get_context("spawn")
    port_no = free_port()
    t0 = time.perf_counter()
    ranks = [ctx.Process(target=multidevice_rank,
                         args=(r, MD_WORLD, port_no, str(device), str(frames_path), str(thr_path),
                               out_size, str(out_path))) for r in range(MD_WORLD)]
    for proc in ranks:
        proc.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for proc in ranks:
        proc.join(max(deadline - time.monotonic(), 0))
    alive = [proc for proc in ranks if proc.is_alive()]
    for proc in alive:
        proc.kill()
        proc.join()
    expect(not alive, f"{len(alive)} rank(s) did not finish within {RANK_TIMEOUT_S} s")
    codes = [proc.exitcode for proc in ranks]
    expect(codes == [0] * MD_WORLD, f"rank exit codes {codes}")
    ranks_s = time.perf_counter() - t0
    with open(out_path, "rb") as fp:
        expect(pickle.load(fp) == blocks, "the ranks' gathered blocks differ from one process's")
    print(f"  {MD_WORLD} gloo ranks on {device}: rank 0 gathered the {len(blocks)} blocks of one "
          f"process ({ranks_s:.3f} s, spawn to exit)")
    walls = {f"{n_data}x{n_space}": {**rep["walls"], "whole dryrun with its checks":
                                     dryrun_s[f"{n_data}x{n_space}"]}
             for (n_data, n_space), rep in reports.items()}
    return dict(launches), walls, ranks_s


def run_alternates(device, data, dark, puddles, pdark) -> dict:
    """Phase 9: the alternates path on ``data`` and ``puddles`` (L1, threshold
    dark + EPSILON), ALT_BATCH frames at a time: encode_l1(pairs_out=), the
    values packed by bitpack12_words, the bitmaps tokenized from their pairs
    (flagged frames by tokenize_compact) and assembled by assemble_split
    (``_tables_assemble_finish(split_assemble=True)``), the values deflated
    by ``deflate_batch_device(split_assemble=True)``.  Then the default path
    (encode_l1, bitpack12, deflate_batch_device) on the same frames; every
    stream of both equal to native.deflate_sparse of its raw stream.
    Returns the launches of the alternates path alone, the flagged frames,
    the streams compared and both walls."""
    sets = [(data, dark), (puddles, pdark)]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def batches():
        for frames_np, dark_np in sets:
            thr = torch.from_numpy((dark_np + EPSILON).astype(np.uint16)).to(device)
            for start in range(0, frames_np.shape[0], ALT_BATCH):
                frames = torch.from_numpy(frames_np[start:start + ALT_BATCH]).to(device)
                size = _bucket_for(int(count_foreground(frames, thr).max()),
                                   frames.shape[1] * frames.shape[2])
                yield frames, thr, -(-size // 8) * 8       # whole 8-value word groups

    port.reset_kernel_launch_counts()
    sync()
    t0 = time.perf_counter()
    alt, raws, flagged = [], [], 0
    for frames, thr, size in batches():
        bitmap, comp, counts, overflow, pairs, pcounts = hopper_encode.encode_l1(
            frames, thr, size, pairs_out=size)
        expect(not bool(overflow.any()), "phase 9: encode overflow")
        words = hopper_bitpack.bitpack12_words(comp)
        B, n = bitmap.shape
        bound = pairs_token_bound(pcounts, n)
        tok, hist, tcounts, flag, adler = hopper_tokens.tokens_from_pairs(pairs, pcounts, n, bound)
        expect(bool((tcounts <= bound).all()), "phase 9: tokens over their bound")
        lengths = np.full(B, n, np.int32)
        if bool(flag.any()):
            rows = torch.nonzero(flag).flatten()
            comp_b, hist_b, adler_b, _, over_b = hopper_deflate.tokenize_compact(
                bitmap[rows].contiguous(), torch.from_numpy(lengths[:len(rows)]).to(device), bound)
            expect(not bool(over_b.any()), "phase 9: byte tokens over the pairs' bound")
            tok[rows], hist[rows], adler[rows] = comp_b, hist_b, adler_b
            flagged += len(rows)
        plens = ((counts.to(torch.int64) * 12 + 7) // 8).cpu().numpy()
        out_bound = min(2 * n, (bound * hopper_deflate.MAX_TOKEN_BITS + 7) // 8) + 256
        streams = dyndeflate._tables_assemble_finish(
            tok, out_bound, hist.cpu().numpy(), adler.cpu().numpy(), lengths, None, bitmap,
            split_assemble=True)
        streams += dyndeflate.deflate_batch_device(words.view(torch.uint8), plens,
                                                   split_assemble=True)
        alt.append(streams)
        raws.append((bitmap, words.view(torch.uint8), plens, comp))
    sync()
    alt_s = time.perf_counter() - t0
    launches = port.kernel_launch_counts()

    sync()
    t0 = time.perf_counter()
    default = []
    for frames, thr, size in batches():
        bitmap, comp, counts, _ = hopper_encode.encode_l1(frames, thr, size)
        packed = hopper_bitpack.bitpack12(comp)
        plens = ((counts.to(torch.int64) * 12 + 7) // 8).cpu().numpy()
        default.append(dyndeflate.deflate_batch_device(bitmap, np.full(bitmap.shape[0], bitmap.shape[1]))
                       + dyndeflate.deflate_batch_device(packed, plens))
    sync()
    default_s = time.perf_counter() - t0

    n_streams = 0
    for streams, ref, (bitmap, wbytes, plens, comp) in zip(alt, default, raws):
        expect(streams == ref, "phase 9: the alternates path's streams differ from the default's")
        expect(torch.equal(wbytes, hopper_bitpack.bitpack12(comp)),
               "phase 9: bitpack12_words bytes differ from bitpack12's")
        host_bm, host_w = bitmap.cpu().numpy(), wbytes.cpu().numpy()
        raw = [row.tobytes() for row in host_bm] + \
            [row[:k].tobytes() for row, k in zip(host_w, plens)]
        for i, (stream, r) in enumerate(zip(streams, raw)):
            expect(stream == native.deflate_sparse(r),
                   f"phase 9: stream {i} differs from native.deflate_sparse")
        n_streams += len(streams)
    n_frames = sum(f.shape[0] for f, _ in sets)
    expect(flagged < n_frames, f"phase 9: tokens_from_pairs flagged {flagged} of {n_frames} frames")
    print(f"alternates path: {n_frames} frames, {n_streams} streams equal native.deflate_sparse "
          f"and the default path's; bitpack12_words bytes equal bitpack12's; {flagged} of "
          f"{n_frames} frames flagged by tokens_from_pairs (taken by tokenize_compact)")
    return {"launches": launches, "flagged": flagged, "streams": n_streams, "alt_s": alt_s,
            "default_s": default_s}


def run_tools(device, gpu: str, size: int = 4096) -> dict:
    """Phase 10, the developer tools: each probe of pyrecode_tpu_torch.tools
    at the JAX probe's default sizes (the phase probes at 4 x 4096^2, 1%),
    each holding its kernel against its twin (the phase probes also hold
    "full" against encode_l1 / decode_l1) and the probe's own oracle; every
    probe line printed with the card.  Returns {"launches": the probes'
    launches, "stats": the kernels line's entries of the five kernels}."""
    port.reset_kernel_launch_counts()
    enc = probe_phases.run(device, size=size)
    dec = probe_decode_phases.run(device, size=size)
    mos = probe_mosaic.run(device)
    dot = probe_f32dot.run(device)
    fly = probe_butterfly.run(device)
    launches = port.kernel_launch_counts()
    for result in (enc, dec, mos, dot, fly):
        for line in result["lines"]:
            print(f"  {line} [{gpu}]")
    expect(all(v == "OK" for v in mos["status"].values()), f"lowering probes: {mos['status']}")
    expect(all(v == "OK" for v in fly["status"].values()), f"butterfly: {fly['status']}")
    modes = dot["modes"]
    expect(all(r["twin_equal"] for r in modes.values()), "f32dot differs from its twin")
    expect(modes["3xtf32"]["exact"] and modes["fp32"]["exact"], "3xtf32 / fp32 not exact")
    # each kernel's largest difference from its twin, over every call the probe checked
    errs = {"encode_l1_phases": max(r["max_abs_err"] for r in enc["rows"]),
            "decode_l1_phases": max(r["max_abs_err"] for r in dec["rows"]),
            "probe_mosaic": mos["max_abs_err"],
            "probe_f32dot": max(r["twin_err"] for r in modes.values()),
            "probe_butterfly": fly["max_abs_err"]}
    if device.type != "cuda":
        return {"launches": launches, "stats": {name: {"max_abs_err": errs[name]}
                                                for name in TOOL_KERNELS}}

    # the kernels line: each kernel's own work against its bound and twin
    def phase_entry(result, name, phase, plain):
        row = next(r for r in result["rows"] if r["phase"] == phase)
        return {"max_abs_err": errs[name], "ms": row["ms"],
                "plain_ms": cuda_event_time(plain, 3, 1),
                "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": None,
                "phase_ms": {r["phase"]: r["ms"] for r in result["rows"]},
                "phase_bound_ms": {r["phase"]: r["bound_ms"] for r in result["rows"]}}

    n = size
    frames_np, thr_np = sparse_batch(4, n, OCCUPANCY)
    frames, thr = torch.from_numpy(frames_np).to(device), torch.from_numpy(thr_np).to(device)
    bitmap, values = hopper_encode.encode_l1(frames, thr, enc["out_size"])[:2]
    lut_np, oh_np, _ = probe_f32dot.make_inputs()
    lut, oh = torch.from_numpy(lut_np).to(device), torch.from_numpy(oh_np).to(device)
    # 3xtf32: three m16n8k8 passes over 48 x 2048 x 32 multiply-adds, on the tensor cores
    dot_s = {"bytes": (io_bytes(lut, oh) + 48 * 2048 * 4) / HBM_BYTES_PER_S,
             "operations": 3 * 2 * 48 * 2048 * 32 / TF32_OPS_PER_S}
    dot_by = max(dot_s, key=dot_s.get)
    m, v = fly["timed"][2048]
    mos_inputs = {k: [torch.from_numpy(x).to(device) for x in ins]
                  for k, (ins, _) in probe_mosaic.cases().items()}
    stats = {
        "encode_l1_phases": phase_entry(
            enc, "encode_l1_phases", "load",
            lambda: hopper_encode.encode_l1_phases_plain(frames, thr, enc["out_size"], True,
                                                         "load")),
        "decode_l1_phases": phase_entry(
            dec, "decode_l1_phases", "store",
            lambda: hopper_decode.decode_l1_phases_plain(bitmap, values, n, n, "store")),
        # the eight in one mosaic_all call; no one library call computes all
        # eight (probe_library_ms: the probes one call computes)
        "probe_mosaic": {"max_abs_err": errs["probe_mosaic"], "ms": mos["all_ms"],
                         "plain_ms": cuda_event_time(
                             lambda: hopper_probes.mosaic_all_plain(mos_inputs), 3, 1),
                         "bound_ms": mos["bytes"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                         "library_ms": None, "probe_ms": mos["ms"],
                         "probe_library_ms": mos["library_ms"]},
        "probe_f32dot": {"max_abs_err": errs["probe_f32dot"], "ms": modes["3xtf32"]["ms"],
                         "mode": "3xtf32",
                         "plain_ms": cuda_event_time(
                             lambda: hopper_probes.f32dot_plain(lut, oh, "3xtf32"), 3, 1),
                         "bound_ms": dot_s[dot_by] * 1e3, "bound_by": dot_by,
                         "library_ms": dot["library_ms"],
                         "mode_ms": {k: r["ms"] for k, r in modes.items()}},
        # device_ms: queued_ms (the profiler's traces of this phase can come
        # back without their device intervals; probe_passes traces P5 alone)
        "probe_butterfly": {"max_abs_err": errs["probe_butterfly"],
                            "ms": fly["ms"][2048, "two_array"],
                            "variant": "two_array, SUB 2048, density 0.95",
                            "device_ms": queued_ms(
                                lambda: hopper_probes.butterfly(m, v, "two_array")),
                            "all_device_ms": queued_ms(lambda: hopper_probes.butterfly_all(m, v)),
                            "plain_ms": cuda_event_time(lambda: hopper_probes.butterfly_plain(
                                m, v, "two_array"), 3, 1),
                            "bound_ms": io_bytes(m, v, v) / HBM_BYTES_PER_S * 1e3,
                            "bound_by": "bytes", "library_ms": None,
                            "variant_ms": {f"{name} SUB {sub}": t
                                           for (sub, name), t in fly["ms"].items()},
                            "all_ms": {f"SUB {sub}": t for sub, t in fly["all_ms"].items()}},
    }
    return {"launches": launches, "stats": stats}


def trace_writer(device, data, dark, work_dir: Path) -> dict:
    """Phase 10, the profiler: one L1 scheme-0 writer on ``data`` without and
    with ``run(profile_dir=)`` (after one empty trace, which sets the
    profiler up); the part files must be equal and a Chrome trace must be
    written.  The device busy share is the union of the trace's kernel,
    memcpy and memset intervals over the traced run's wall (host clock
    around ``run``, which holds the profiler's own start, stop and export)
    and over the span of the trace's own events."""
    params = slice_params(*data.shape, num_threads=1)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    # the profiler's first start in a process sets up its tracer (seconds):
    # do that outside the measured run
    with trace(str(work_dir / "warm_up_trace")):
        sync()
    parts, walls = [], []
    for k, profile_dir in enumerate((None, work_dir / "trace")):
        out = work_dir / f"traced_{k}"
        out.mkdir()
        writer = port.ReCoDeWriter("smoke", dark_data=dark, output_directory=str(out),
                                   input_params=params, device=device)
        writer.start()
        sync()
        t0 = time.perf_counter()
        writer.run(data, profile_dir=None if profile_dir is None else str(profile_dir))
        sync()
        walls.append(time.perf_counter() - t0)
        writer.close()
        parts.append((out / "smoke.rc1_part000").read_bytes())
    expect(parts[0] == parts[1], "the traced writer's part file differs from the untraced one")
    traces = sorted((work_dir / "trace").glob("*.pt.trace.json"))
    expect(len(traces) == 1, f"profile_dir holds {len(traces)} trace files")
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    expect(spans, "the trace holds no device interval")
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    timed = [float(e["ts"]) for e in events if e.get("ph") == "X" and "ts" in e]
    span_us = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events
                  if e.get("ph") == "X" and "ts" in e) - min(timed)
    kinds = Counter(e["cat"] for e in events if e.get("ph") == "X"
                    and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    result = {"untraced_s": walls[0], "traced_s": walls[1], "busy_ms": busy / 1e3,
              "busy_share_wall": busy / 1e6 / walls[1], "busy_share_span": busy / span_us,
              "span_ms": span_us / 1e3, "intervals": dict(kinds), "trace_bytes":
              traces[0].stat().st_size}
    print(f"profiler: one L1 scheme-0 writer, {data.shape[0]} frames; part files with and "
          f"without profile_dir equal; trace {traces[0].name} ({result['trace_bytes']} bytes, "
          f"device intervals {dict(kinds)})")
    return result


def make_detector_frames(device, n_flat: int, n_acq: int, height: int, width: int):
    """Flat-field and acquisition frames of one detector, made on ``device``
    from SEED: a per-pixel dark level in 100..131, Gaussian read noise (sigma
    3, rounded) and single-pixel electron hits of 20..79 counts, at 0.08 a
    pixel and frame in the flat field (the accurate thresholds need more than
    one event a pixel over the stack) and 0.01 in the acquisition.  Returns
    (flat (n_flat, h, w), acquisition (n_acq, h, w)) uint16 numpy arrays."""
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    level = 100 + torch.randint(0, 32, (height, width), generator=gen, device=device)

    def frames(n, dose):
        out = np.empty((n, height, width), np.uint16)
        for i in range(n):
            noise = torch.randn((height, width), generator=gen, device=device) * 3
            hits = torch.rand((height, width), generator=gen, device=device) < dose
            counts = torch.randint(20, 80, (height, width), generator=gen, device=device)
            frame = level + noise.round().to(torch.int64) + hits * counts
            out[i] = frame.clamp(0, 4095).to(torch.int32).cpu().numpy()
        return out

    return frames(n_flat, 0.08), frames(n_acq, 0.01)


def _modules_params(path: Path, n_frames: int, height: int, width: int) -> dict:
    """Phase 11's L1 scheme-0 parameters (a SEQ source, epsilon 0: the
    threshold is the calibration file), written to ``path``; returns them."""
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=width, num_rows=height,
        num_frames=n_frames, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=2, l2_statistics=0,
        l4_centroiding=0, compression_scheme=0, compression_level=1,
        source_file_type=rc.FILE_TYPE_SEQ, source_header_length=1024, keep_calibration_data=1,
        calibration_file_type=rc.FILE_TYPE_BINARY, source_data_type=0, target_data_type=0)
    path.write_text("".join(f"{k} = {v}\n" for k, v in values.items()))
    return values


def run_modules(device, gpu: str, work_dir: Path, size: int = 4096) -> dict:
    """Phase 11: calibrate -> server -> merge -> read through the CLI, process
    isolation and the viewer and validation frames (see the module
    docstring).  Returns the launch counts of (b), the times and the walls."""
    flat, acq = make_detector_frames(device, CAL_FRAMES, ACQ_FRAMES, size, size)
    dev = device.type
    result = {"walls": {}}

    # (a) calibration: the CLI in a subprocess, held against the host path
    cal_dir = work_dir / "calibration"
    cal_dir.mkdir()
    write_seq(cal_dir / "flat.seq", flat)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pyrecode_tpu_torch", "calibrate",
                          "--flatfield_filepath", str(cal_dir / "flat.seq"),
                          "--n_frames", str(CAL_FRAMES), "--savepath", str(cal_dir),
                          "--save_prefix", "cal", "--use_acc", "--device", dev],
                         capture_output=True, text=True, timeout=900, cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    result["walls"]["calibrate_cli_s"] = time.perf_counter() - t0
    expect(out.returncode == 0, f"phase 11: calibrate failed:\n{out.stderr[-4000:]}")
    print("calibrate: " + " | ".join(out.stdout.strip().splitlines()))
    t0 = time.perf_counter()
    ref = calibration.make_calibration_frames(None, np.uint16, CAL_FRAMES, 10, 4, frames=flat,
                                              use_acc=True, sigma_acc=3, verbose=False,
                                              device="cpu")
    result["walls"]["calibrate_host_s"] = time.perf_counter() - t0
    expect(set(ref["thresholds"]) == {0, 1, 2, 3, "3A"},
           f"phase 11: thresholds {sorted(map(str, ref['thresholds']))}, no accurate ones")
    for key, want in ref["thresholds"].items():
        got = np.fromfile(cal_dir / f"cal__dark_ref_{key}.bin", np.uint16).reshape(size, size)
        expect(np.array_equal(got, want.astype(np.uint16)),
               f"phase 11: threshold file {key} differs from the host calibration")
    k = int(np.ceil(CAL_FRAMES * ref["statistics"][3]["avg_dose_rate"]))
    stack = torch.from_numpy(flat).to(device)
    med, std = calibration.pixel_median_std(stack, device)
    expect(np.array_equal(med, ref["median"]), "phase 11: the card's median differs")
    expect(np.allclose(std, ref["std"], rtol=1e-5, atol=0), "phase 11: the card's std differs")
    base = torch.from_numpy(ref["median"]).to(device)
    acc = calibration.accurate_pixel_thresholds(stack, base, k, device)
    expect(np.array_equal(acc, ref["thresholds"]["3A"]),
           "phase 11: the card's accurate thresholds differ")
    print(f"calibration: {CAL_FRAMES} x {size}^2 flat field, sigma {ref['sigma']!r}, accurate "
          f"thresholds at k = {k}; every threshold file of the CLI equal to the host path's")
    if dev == "cuda":
        stack_bytes = stack.numel() * stack.element_size()
        plane = size * size * 4
        for name, fn, nbytes in (
                ("pixel_median_std", lambda: calibration.pixel_median_std(stack, device),
                 stack_bytes + 2 * plane),
                ("accurate_pixel_thresholds",
                 lambda: calibration.accurate_pixel_thresholds(stack, base, k, device),
                 stack_bytes + 2 * plane)):
            ms = cuda_event_time(fn, 5, 3)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            result[name] = {"ms": ms, "bound_ms": bound, "bytes": nbytes}
            print(f"{name} ({CAL_FRAMES} x {size}^2 u16 on the card, results to the host): "
                  f"{ms:.3f} ms, byte bound {bound:.4f} ms ({nbytes} bytes over "
                  f"{HBM_BYTES_PER_S / 1e12} TB/s) [{gpu}]")
    del stack, base

    # (b) acquisition: server -> merge -> read through the CLI, then a dense read
    acq_dir = work_dir / "acquisition"
    acq_dir.mkdir()
    src = acq_dir / "acq.seq"
    write_seq(src, acq)
    thr_file = cal_dir / "cal__dark_ref_3A.bin"
    thr = np.fromfile(thr_file, np.uint16).reshape(size, size)
    values = _modules_params(acq_dir / "params.txt", ACQ_FRAMES, size, size)
    port.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    expect(cli.main(["server", "--image_filename", str(src), "--calibration_file", str(thr_file),
                     "--out_dir", str(acq_dir), "--params_file", str(acq_dir / "params.txt"),
                     "--log_file", str(acq_dir / "recode.log"), "--run_name", "chip_smoke",
                     "--validation_frame_gap", str(VALIDATION_GAP), "--device", dev]) == 0,
           "phase 11: the CLI's server failed")
    expect(cli.main(["merge", "--folder", str(acq_dir), "--base", "acq.rc1",
                     "--num_parts", "2"]) == 0, "phase 11: the CLI's merge failed")
    result["walls"]["server_merge_s"] = time.perf_counter() - t0
    merged = acq_dir / "acq.rc1"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):   # the header's fields, then the frame's line
        expect(cli.main(["read", "--file", str(merged), "--frame", "5", "--device", dev]) == 0,
               "phase 11: the CLI's read failed")
    print(f"read: {printed.getvalue().strip().splitlines()[-1]}")
    reader = port.ReCoDeReader(str(merged), device=device)
    reader.open()
    t0 = time.perf_counter()
    dense = reader.read_frames_dense(0, ACQ_FRAMES)
    result["walls"]["read_dense_s"] = time.perf_counter() - t0
    reader.close()
    result["launches"] = port.kernel_launch_counts()
    expected = np.zeros_like(acq)
    for z in range(ACQ_FRAMES):
        enc = oracle.reduce_frame(acq[z], thr, 1, 12)
        rows, cols, vals = oracle.decode_frame_sparse(enc["packed_binary_map"],
                                                      enc["packed_pixvals"], size, size, 12, 1)
        expected[z][rows.astype(np.int64), cols.astype(np.int64)] = vals
        expect(np.array_equal(dense[z], expected[z]),
               f"phase 11: frame {z} differs from oracle.reduce_frame")
    print(f"acquisition: {ACQ_FRAMES} x {size}^2 through the CLI's server, merge and read; "
          f"merged {merged.stat().st_size} bytes, read_frames_dense bit-exact against "
          f"oracle.reduce_frame ({int((expected > 0).sum())} foreground pixels)")

    # (c) process isolation against the thread mode on the card
    iso_values = dict(values, num_frames=PROC_FRAMES)
    merged_by_mode = {}
    for isolation in ("process", "thread"):
        out_dir = work_dir / f"isolation_{isolation}"
        out_dir.mkdir()
        server = port.ReCoDeServer("batch", isolation=isolation, device=device)
        t0 = time.perf_counter()
        metrics = server.run(port.InitParams("batch", str(out_dir), image_filename=str(src),
                                             calibration_filename=str(thr_file),
                                             log_filename=str(out_dir / "recode.log"),
                                             run_name="chip_smoke"),
                             input_params=port.InputParams(iso_values))
        path = port.merge_parts(str(out_dir), "acq.rc1", 2)
        result["walls"][f"{isolation}_isolation_s"] = time.perf_counter() - t0
        statuses = [node.status for node in server._nodes]
        expect(statuses == [rc.STATUS_CODE_IS_CLOSED] * 2,
               f"phase 11: {isolation} nodes ended as {statuses}")
        if isolation == "process":
            pids = [node.pid for node in server._nodes]
            initialised = [m.get("cuda_initialized") for m in metrics.values()]
            expect(initialised == [False, False],
                   f"phase 11: worker processes report CUDA initialised {initialised}")
            print(f"process isolation: worker pids {pids}, CUDA initialised in none")
        merged_by_mode[isolation] = Path(path).read_bytes()
    expect(merged_by_mode["process"] == merged_by_mode["thread"],
           "phase 11: the process-isolated container differs from the thread mode's")
    print(f"process isolation: {PROC_FRAMES} frames, merged container byte-equal to the "
          f"thread mode's on {dev} ({len(merged_by_mode['thread'])} bytes)")

    # (d) the live viewer over (b)'s part files and its validation frames
    viewer = ReCoDeViewer(str(acq_dir), "acq.rc1", 2, fractionation=4, device=device)
    for start in range(0, ACQ_FRAMES, 4):
        view = viewer.get_next_view()
        expect(view["start"] == start and view["n_frames"] == 4,
               f"phase 11: viewer window {view['start']}+{view['n_frames']}")
        expect(np.array_equal(view["view"], expected[start:start + 4].sum(axis=0)),
               f"phase 11: viewer window at {start} differs")
    viewer.close()
    for node, offset in ((0, 0), (1, ACQ_FRAMES // 2)):
        report = verify_against_validation_frames(
            str(merged), str(acq_dir / f"acq_part{node:03d}_validation_frames.bin"),
            VALIDATION_GAP, dark=thr, frame_offset=offset, device=device)
        want = set(range(offset, offset + ACQ_FRAMES // 2, VALIDATION_GAP))
        expect(report["all_match"] and set(report["frames"]) == want,
               f"phase 11: validation frames of node {node}: {report}")
    print(f"viewer: {ACQ_FRAMES // 4} views of 4 frames equal to the residual sums; "
          f"validation frames of both nodes match")
    return result


def queued_ms(fn, reps: int = 20, outer: int = 3) -> float:
    """Device milliseconds a call of ``fn`` takes when the device never
    waits for the host, without the profiler: ``reps`` calls queued behind
    a spin kernel that outlasts their launches, between two CUDA events
    (the gaps between kernels included); the median of ``outer`` runs."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 20, []
    while len(times) < outer:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()   # the spin still ran when the last call was queued
        end.synchronize()
        if queued:
            times.append(start.elapsed_time(end) / reps)
        else:
            cycles *= 2
    return sorted(times)[outer // 2]


def host_ms(fn, reps: int = 20) -> float:
    """Host milliseconds of one call of ``fn``: ``reps`` calls queued back to
    back after a synchronize, timed without waiting for the device (too few
    launches to fill the queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def sort_gather(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """P5's yardstick, a composition of library calls (the port never calls
    it): each row's foreground values packed to its front in lane order by
    a stable sort of the background flag and a gather, the tail zeroed."""
    order = torch.sort((mask <= 0).to(torch.int8), dim=1, stable=True).indices
    front = torch.arange(mask.shape[1], device=mask.device) < (mask > 0).sum(dim=1, keepdim=True)
    return torch.where(front, torch.gather(vals, 1, order), 0)


def butterfly_calls(device) -> dict:
    """P5's calls on the probe's density-0.95 inputs at SUB 512 and 2048
    (probe_butterfly.run's "timed", drawn as it draws them): butterfly in
    each variant, the four in one butterfly_all call (a tree older than
    butterfly_all: its four butterfly calls), and sort_gather, which must
    equal the kernel there."""
    four = getattr(hopper_probes, "butterfly_all", None) or (
        lambda m, v: [hopper_probes.butterfly(m, v, name)
                      for name in hopper_probes.BUTTERFLY_VARIANTS])
    rng = np.random.default_rng(1)
    calls = {}
    for sub in probe_butterfly.SUBS:
        _, m_np, v_np = probe_butterfly.make_cases(rng, sub)[-1]
        m, v = torch.from_numpy(m_np).to(device), torch.from_numpy(v_np).to(device)
        for name in hopper_probes.BUTTERFLY_VARIANTS:
            calls[f"probe_butterfly_{sub}_{name.split()[0]}"] = (
                lambda m=m, v=v, name=name: hopper_probes.butterfly(m, v, name))
        calls[f"probe_butterfly_all_{sub}"] = lambda m=m, v=v: four(m, v)
        expect(torch.equal(sort_gather(m, v), hopper_probes.butterfly(m, v, "two_array")),
               f"sort_gather differs from the butterfly at SUB {sub}")
        calls[f"butterfly_sort_gather_{sub}"] = lambda m=m, v=v: sort_gather(m, v)
    return calls


def probe_passes(device, reps: int = 20) -> dict:
    """P5, P4 and P3 on their probes' inputs: the butterfly calls
    (butterfly_calls), f32dot in each mode beside the torch.matmul yardstick
    (``lut @ oh.T``, float32 with TF32 off), the eight lowering probes
    together and each alone, and each P3 library call
    (probe_mosaic.library_calls).  For each: {"ms": CUDA-event ms, "host_ms":
    host_ms, "passes": the device ms of each operation of one call
    (device_passes), "device_ms": their sum}.  A tree older than mosaic_all
    runs the eight as the eight mosaic calls its probe timed together, so
    this also times an older tree put first on sys.path (PERF.md)."""
    lut_np, oh_np, _ = probe_f32dot.make_inputs()
    lut, oh = torch.from_numpy(lut_np).to(device), torch.from_numpy(oh_np).to(device)
    mos = {k: [torch.from_numpy(x).to(device) for x in ins]
           for k, (ins, _) in probe_mosaic.cases().items()}
    if hasattr(hopper_probes, "mosaic_all"):
        calls = {"probe_mosaic_all": lambda: hopper_probes.mosaic_all(mos),
                 **{f"mosaic_library_{k}": fn
                    for k, fn in probe_mosaic.library_calls(mos).items() if fn is not None}}
    else:
        calls = {"probe_mosaic_all": lambda: [hopper_probes.mosaic(k, *t) for k, t in mos.items()]}
    calls.update({f"probe_mosaic_{k}": (lambda k=k, t=t: hopper_probes.mosaic(k, *t))
                  for k, t in mos.items()})
    calls.update({f"probe_f32dot_{mode}": (lambda mode=mode: hopper_probes.f32dot(lut, oh, mode))
                  for mode in hopper_probes.F32DOT_MODES})
    calls["f32dot_matmul"] = lambda: lut @ oh.T
    calls.update(butterfly_calls(device))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        result = {}
        for name, fn in calls.items():
            passes = device_passes(fn)
            result[name] = {"ms": cuda_event_time(fn, reps, 3), "host_ms": host_ms(fn),
                            "passes": passes, "device_ms": sum(passes.values())}
        return result
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def kernel_passes(device, reps: int = 20) -> dict:
    """The redesigned kernels' times on batches like phase 3's, made from
    SEED: CUDA-event ms, host ms (host_ms) and the device ms of each
    operation of one call (device_passes) of encode_l1 on phase 3's slice
    batch (4 x 4096^2 at ~1%) in its three modes (plain, with positions,
    with pairs at out_size), at L3 and cut after each phase
    (encode_l1_phases), each with its byte bound, beside the writer's
    pre-count count_foreground on the same batch; CUDA-event ms of
    encode_l2l4 in each mode on 4 x 4096^2 puddle frames, of posdecode on
    the slice beside the scatter_ call; the same three figures for
    tokenize, tokenize_compact (at the token bound the writer's density
    hint gives) and tokens_from_pairs on the slice's bitmaps, for
    rans_decode and rans_encode on the slice's gap and value streams at
    groups 1 and on ~20% bitmaps as 8-bit symbols at groups 8, and for
    rans_encode_tokens on the slice's bitmap tokens (each with its rows, ms
    a row and, where the call has one, its chain pass's ms a row), and for
    bitmap_positions on the L2/L3 puddle bitmaps at the
    writer's capacity; for rans_hist on the gap, value and 8-bit bitmap
    streams, for assemble and assemble_split on the slice bitmaps' and
    values' tokens as phase 3 assembles them, and for bitpack12,
    bitunpack12, decode_l1 (and its P2 cuts decode_l1_store, _count and
    _scan) and bitpack12_words on phase 3's inputs, each with its byte
    bound; and the probes P3, P4 and P5 (probe_passes, under "probes").  It
    times whichever pyrecode_tpu_torch is imported, so it also measures an
    older tree put first on sys.path (PERF.md)."""
    rng = np.random.default_rng(SEED)
    frames_np, dark = make_frames(rng, 4, 4096, 4096)
    frames = torch.from_numpy(frames_np).to(device)
    thr = torch.from_numpy(dark + EPSILON).to(device)
    n = 4096 * 4096
    size = _bucket_for(int(hopper_encode.encode_l1_plain(frames, thr, 0, with_values=False)[2]
                           .max()), n)
    _, comp, counts, _, pos = hopper_encode.encode_l1(frames, thr, size, True, True, 12)
    idx = torch.where(torch.arange(pos.shape[1], device=device)[None, :] < counts[:, None],
                      pos, n).to(torch.int64)
    src = comp.to(torch.int16)
    decode = (lambda: hopper_decode.posdecode(pos, comp, counts, 4096, 4096))
    puddles_np, pdark = make_puddle_frames(rng, 4, 4096, 4096)
    puddles = torch.from_numpy(puddles_np).to(device)
    pthr = torch.from_numpy(pdark + EPSILON).to(device)
    psize = _bucket_for(int(hopper_encode.encode_l1_plain(puddles, pthr, 0, with_values=False)[2]
                            .max()), n)
    bitmap, _, _, _, pairs, pcounts = hopper_encode.encode_l1(frames, thr, size, pairs_out=size)
    nb = bitmap.shape[1]
    full = torch.full((4,), nb, dtype=torch.int32, device=device)
    # deflate_batch_device's hint route: 1.6 x the densest stream's tokens a byte
    density = int(hopper_deflate.tokenize(bitmap, full)[1][:, :286].sum(dim=1).max()) / nb
    bound = quantize_bound(max(int(nb * density * 1.6), 1), hopper_deflate.TILE)
    pbound = pairs_token_bound(pcounts, nb)
    tokenizers = {
        "tokenize": lambda: hopper_deflate.tokenize(bitmap, full),
        "tokenize_compact": lambda: hopper_deflate.tokenize_compact(bitmap, full, bound),
        "tokens_from_pairs": lambda: hopper_tokens.tokens_from_pairs(pairs, pcounts, nb, pbound),
    }
    # rans_decode: the slice's gap and value symbols at groups 1 (phase 3's
    # streams), ~20% bitmaps as 8-bit symbols at groups 8
    values = hopper_bitpack.bitunpack12(hopper_bitpack.bitpack12(comp))
    valid = torch.arange(pos.shape[1], device=device)[None, :] < counts[:, None]
    prev = torch.cat([torch.full((4, 1), -1, dtype=torch.int32, device=device), pos[:, :-1]], 1)
    gaps = torch.where(valid, pos - prev - 1, 0).clamp(max=rans.GAP_ESCAPE - 1).contiguous()
    dense_np, dark20 = make_frames(rng, 4, 4096, 4096, occupancy=0.2)
    dense = torch.from_numpy(dense_np).to(device)
    thr20 = torch.from_numpy(dark20 + EPSILON).to(device)
    c20 = hopper_encode.encode_l1_plain(dense, thr20, 0, with_values=False)[2]
    bm20 = hopper_encode.encode_l1(dense, thr20, _bucket_for(int(c20.max()), n))[0]
    # ... and rans_encode on the same streams and tables, rans_encode_tokens
    # on the slice's bitmap tokens as phase 3 codes them
    chains = {}
    for what, syms, m, groups in (
            ("gaps", gaps, counts, 1), ("values", values, counts, 1),
            ("bitmaps8", bm20.to(torch.int32).contiguous(),
             torch.full((4,), bm20.shape[1], dtype=torch.int32, device=device), 8)):
        enc_args, dec_args, rows = coder_args(device, syms, m, groups)
        chains[f"rans_decode_{what}"] = (lambda a=dec_args: hopper_rans.rans_decode(*a)), rows
        chains[f"rans_encode_{what}"] = (lambda a=enc_args: hopper_rans.rans_encode(*a)), rows
    tok_args = token_args(device, bitmap)
    chains["rans_encode_tokens"] = (lambda: hopper_rans.rans_encode_tokens(*tok_args),
                                    -(-int(tok_args[3].max()) // hopper_rans.W_LANES))
    # rans_hist on the same symbol streams; assemble and assemble_split on the
    # slice bitmaps' and values' tokens as phase 3 assembles them
    packed = hopper_bitpack.bitpack12(comp)
    full8 = torch.full((4,), bm20.shape[1], dtype=torch.int32, device=device)
    hists = {"gaps": (gaps, counts), "values": (values, counts),
             "bitmaps8": (bm20.to(torch.int32).contiguous(), full8)}
    assembles = {}
    for what, streams, lengths in (("bitmaps", bitmap, full),
                                   ("values", packed, (counts * 12 + 7) // 8)):
        tok, hist, _ = hopper_deflate.tokenize(streams, lengths)
        n_tok = int(hist[:, :286].sum(dim=1).max())
        comp_tok = hopper_deflate.tokenize_compact(streams, lengths, n_tok)[0]
        assembles[what] = (assemble_tokens(tok, comp_tok, n_tok, lengths.cpu().numpy()),
                           *host_tables(hist, device), 2 * streams.shape[1] + 256)
    others = {   # rows phase 3 traces no call of, and #7, #8, #11 on the main path's inputs
        "bitpack12": lambda: hopper_bitpack.bitpack12(comp),
        "bitunpack12": lambda: hopper_bitpack.bitunpack12(packed),
        "decode_l1": lambda: hopper_decode.decode_l1(bitmap, values, 4096, 4096),
        **{f"decode_l1_{p}": (lambda p=p: hopper_decode.decode_l1_phases(bitmap, values, 4096,
                                                                         4096, p))
           for p in hopper_decode.PHASES[:-1]},
        "bitpack12_words": lambda: hopper_bitpack.bitpack12_words(comp),
        **{f"rans_hist_{what}": (lambda a=args: hopper_rans.rans_hist(*a))
           for what, args in hists.items()},
        **{f"{fn}_{what}": (lambda f=getattr(hopper_deflate, fn), a=args: f(*a))
           for what, args in assembles.items() for fn in ("assemble", "assemble_split")},
    }
    # bitmap_positions: the L2/L3 puddle bitmaps at the writer's capacity
    l2_bitmap = hopper_label.encode_l2l4(puddles, pthr, "l2sum", psize, 4095)[0]
    pos_bound = 2 * -(-l2_bitmap.shape[1] // 16384) * 16384
    encodes = {
        "encode_l1": lambda: hopper_encode.encode_l1(frames, thr, size),
        "encode_l1_positions": lambda: hopper_encode.encode_l1(frames, thr, size, True, True, 12),
        "encode_l1_pairs": lambda: hopper_encode.encode_l1(frames, thr, size, pairs_out=size),
        "encode_l1_l3": lambda: hopper_encode.encode_l1(frames, thr, 0, with_values=False),
        **{f"encode_l1_{p}": (lambda p=p: hopper_encode.encode_l1_phases(frames, thr, size,
                                                                          True, p))
           for p in hopper_encode.PHASES},
    }
    calls = {**encodes, "count_foreground": lambda: count_foreground(frames, thr),
             **tokenizers, **{name: fn for name, (fn, _) in chains.items()},
             "bitmap_positions": lambda: hopper_gaps.bitmap_positions(l2_bitmap, pos_bound),
             **others}
    times = {name: cuda_event_time(fn, reps, 3) for name, fn in calls.items()}
    passes = {name: device_passes(fn) for name, fn in calls.items()}
    inputs = {"bitpack12": (comp,), "bitunpack12": (packed,), "decode_l1": (bitmap, values),
              **{f"decode_l1_{p}": (bitmap,) for p in hopper_decode.PHASES[:-1]},
              "bitpack12_words": (comp,),
              **{f"{fn}_{what}": args[:4] for what, args in assembles.items()
                 for fn in ("assemble", "assemble_split")}}
    return {
        "encode_l1_out_size": size,
        **{f"{name}_bound_ms": io_bytes(frames, thr, fn()) / HBM_BYTES_PER_S * 1e3
           for name, fn in encodes.items()},
        **{f"{name}_bound_ms": io_bytes(arrays, others[name]()) / HBM_BYTES_PER_S * 1e3
           for name, arrays in inputs.items()},
        # the histogram reads each live symbol once and writes 4096 bins a stream
        **{f"rans_hist_{what}_bound_ms": (4 * int(m.sum()) + 4 * 4096 * m.shape[0])
           / HBM_BYTES_PER_S * 1e3 for what, (_, m) in hists.items()},
        "rans_hist_symbols": {what: int(m.sum()) for what, (_, m) in hists.items()},
        "assemble_columns": {what: list(args[0].shape) for what, args in assembles.items()},
        "tokenize_compact_bound": bound,
        **{f"{name}_ms": times[name] for name in calls},
        **{f"{name}_host_ms": host_ms(fn) for name, fn in calls.items()},
        **{f"{name}_passes": passes[name] for name in calls},
        **{f"{name}_rows": rows for name, (_, rows) in chains.items()},
        **{f"{name}_ms_per_row": times[name] / rows for name, (_, rows) in chains.items()},
        # the chain pass alone over the rows: the measured step of one lane
        **{f"{name}_chain_ms_per_row": passes[name]["rans_chain_kernel"] / rows
           for name, (_, rows) in chains.items() if "rans_chain_kernel" in passes[name]},
        "posdecode_ms": cuda_event_time(decode, reps, 3),
        "scatter_ms": cuda_event_time(
            lambda: torch.zeros((4, n + 1), dtype=torch.int16, device=device).scatter_(1, idx, src),
            reps, 3),
        "posdecode_passes": device_passes(decode),
        "label_mode_ms": {m: cuda_event_time(
            lambda m=m: hopper_label.encode_l2l4(puddles, pthr, m, psize, 4095), reps, 3)
            for m in hopper_label.MODES},
        "label_passes": device_passes(
            lambda: hopper_label.encode_l2l4(puddles, pthr, "l2sum", psize, 4095)),
        "probes": probe_passes(device, reps),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    gpu = card()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"host library (deflate_sparse) available: {native.available()}, "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    print("kernels vs twins:")
    kernel_stats = check_kernels(device, rng)

    data, dark = make_frames(rng, 16, 4096, 4096)
    work_dir = Path(tempfile.mkdtemp(prefix="tmp_chip_smoke_", dir=REPO))
    paths = {0: SCHEME0_KERNELS, 12: SCHEME12_KERNELS}
    launches, walls = {}, {}
    try:
        for scheme in (0, 12):
            (work_dir / f"slice{scheme}").mkdir()
            counts, write_s, read_s, merged = run_slice(device, data, dark,
                                                        work_dir / f"slice{scheme}", scheme=scheme)
            launches[scheme], walls[scheme] = counts, (write_s, read_s)
            print(f"launches in the scheme-{scheme} slice: {counts}")
            missing = [name for name in paths[scheme] if counts[name] == 0]
            if missing:
                raise AssertionError(f"kernels not launched by the scheme-{scheme} path: {missing}")
            if scheme == 0:
                entropy_s = compare_entropy_paths(device, data, dark, work_dir)
            else:
                check_scheme12_streams(device, data, dark, merged)
                (work_dir / "eight").mkdir()
                launches["scheme12_8bit"] = run_8bit_scheme12(
                    device, np.minimum(data[:8], 255).astype(np.uint8), dark.astype(np.uint8),
                    work_dir / "eight")
        signed = run_signed_slices(
            device, *signed_frames(data[:4], dark, np.random.default_rng(SEED + 1)), work_dir)
        launches.update({f"int16_scheme{k}": v for k, v in signed.items()})

        puddles, pdark = make_puddle_frames(rng, 16, 4096, 4096)
        for (level, statistic, scheme), kernels in LEVEL_SLICES.items():
            path = f"L{level}{'_' + statistic if statistic else ''}_s{scheme}"
            (work_dir / path).mkdir()
            counts, write_s, read_s = run_level_slice(device, puddles, pdark, work_dir / path,
                                                      level, statistic, scheme)
            launches[path], walls[path] = counts, (write_s, read_s)
            print(f"launches in the {path} slice: {counts}")
            missing = [name for name in kernels if counts[name] == 0]
            if missing:
                raise AssertionError(f"kernels not launched by the {path} path: {missing}")
            if level == 4:
                entropy_l4 = compare_entropy_paths(device, puddles, pdark, work_dir, level,
                                                   statistic)

        print("multi-device path:")
        counts, md_walls, ranks_s = run_multidevice(device, data[:8], dark + EPSILON,
                                                    puddles[:8], pdark + EPSILON, work_dir)
        launches["multidevice"] = counts
        print(f"launches in the multi-device path's own steps: {counts}")
        missing = [name for name in MULTIDEVICE_KERNELS if counts[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the multi-device path: {missing}")

        alternates = run_alternates(device, data, dark, puddles, pdark)
        launches["alternates"] = alternates["launches"]
        print(f"launches in the alternates path: {alternates['launches']}")
        missing = [name for name in ALTERNATES_KERNELS if alternates["launches"][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the alternates path: {missing}")

        print("tools:")
        tools = run_tools(device, gpu)
        launches["tools"] = tools["launches"]
        print(f"launches in the tools' probes: {tools['launches']}")
        missing = [name for name in TOOL_KERNELS if tools["launches"][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the tools: {missing}")
        kernel_stats.update(tools["stats"])
        traced = trace_writer(device, data, dark, work_dir)

        print("modules:")
        modules = run_modules(device, gpu, work_dir)
        launches["modules"] = modules["launches"]
        print(f"launches in the modules' path (CLI server and read): {modules['launches']}")
        missing = [name for name in MODULES_KERNELS if modules["launches"][name] == 0]
        if not (modules["launches"]["tokenize"] or modules["launches"]["tokenize_compact"]):
            missing.append("tokenize or tokenize_compact")
        if missing:
            raise AssertionError(f"kernels not launched by the modules' path: {missing}")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    raw = data.nbytes
    for path, (write_s, read_s) in walls.items():
        what = f"scheme {path}" if path in (0, 12) else path
        print(f"{what} write (server + merge, device entropy): {write_s:.3f} s, "
              f"{raw / write_s / 1e9:.3f} GB/s of raw frames [{gpu}]")
        print(f"{what} read (read_frames_dense): {read_s:.3f} s, "
              f"{raw / read_s / 1e9:.3f} GB/s of raw frames [{gpu}]")
    for mesh_shape, steps in md_walls.items():
        print(f"multi-device {mesh_shape} mesh of {device} (8 frames): "
              + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()) + f" [{gpu}]")
    print(f"multi-device, {MD_WORLD} gloo ranks, spawn to exit: {ranks_s:.3f} s [{gpu}]")
    print(f"alternates path (phase 9, 32 frames, encode to zlib streams): "
          f"{alternates['alt_s']:.3f} s; default path on the same frames: "
          f"{alternates['default_s']:.3f} s [{gpu}]")
    print(f"device busy share of one L1 scheme-0 writer on 16 frames (torch.profiler): "
          f"{traced['busy_share_wall']:.4f} of the traced run's wall {traced['traced_s']:.3f} s "
          f"(which holds the profiler's own start, stop and trace export; the same run "
          f"untraced: {traced['untraced_s']:.3f} s), {traced['busy_share_span']:.4f} of the "
          f"trace's own span {traced['span_ms']:.3f} ms; device intervals "
          f"{traced['busy_ms']:.3f} ms [{gpu}]")
    print("modules (phase 11): " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                             modules["walls"].items()) + f" [{gpu}]")
    for what, seconds in (("L1 scheme 0", entropy_s), ("L4 weighted_average scheme 0",
                                                       entropy_l4)):
        for device_entropy, name in ((True, "device"), (False, "host")):
            runs = ", ".join(f"{t:.3f}" for t in seconds[device_entropy])
            print(f"write (one writer, {what}, {name} entropy): {runs} s [{gpu}]")

    kernels = []
    for name in KERNELS:
        by_path = {(f"scheme{p}" if p in (0, 12) else p): launches[p][name] for p in launches}
        row = {"name": name, "route": "cuda", "source": KERNELS[name][0],
               "replaces": KERNELS[name][1], "launches": sum(by_path.values()),
               "launches_by_path": by_path, **kernel_stats[name]}
        if name == "encode_l1":
            row["positions_launches"] = sum(c["encode_l1_positions"] for c in launches.values())
            row["pairs_launches"] = sum(c["encode_l1_pairs"] for c in launches.values())
        kernels.append(row)
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["passes"]:   # the redesigned kernels' times alone
        print(card())
        print(json.dumps(kernel_passes(torch.device("cuda", 0))))
    else:
        main()
