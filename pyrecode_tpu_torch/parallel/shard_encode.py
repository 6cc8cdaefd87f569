"""Sharded encode: one encode step over a device mesh.

Port of pyrecode_tpu/parallel/shard_encode.py.  Where the JAX step is one
jitted program with input and output shardings (GSPMD derives the
collectives), the port launches per shard, each on its device's current
stream, through the port's own encode (:func:`ops.encode.encode_frames_auto`
and the kernels under it):

* frames split contiguously over ``data``; the threshold copied once to
  every device;
* outputs per data shard, on the first device of its ``space`` group, as an
  :class:`~pyrecode_tpu_torch.ops.encode.EncodeResult` whose tensors are
  :class:`~.mesh.Sharded` over ``data``;
* ``shard_rows`` at L1/L3: every (B / n_data, H / n_space, W) row block is
  encoded on its own device; the blocks' bitmaps (bit by bit, so a block
  need not be a whole number of bytes) and their values are merged in row
  order on the group's first device and then packed, so the result is the
  unsharded encode's, bit for bit, for any W;
* ``shard_rows`` at L2/L4: puddles cross row boundaries, so the row blocks
  of a frame are gathered on the first device of their group and labelled
  there.
"""

from __future__ import annotations

import torch

from ..ops.bitpack import bitpack_values_device, pack_bits, packed_group_shape, unpack_bits
from ..ops.compact import stream_compact
from ..ops.encode import EncodeResult, encode_frames_auto
from ..ops.hopper_encode import encode_l1
from .mesh import CodecMesh, Sharded, replicate, shard_frames


def _merge_bitmaps(bitmaps, n_bits: int) -> torch.Tensor:
    """Row blocks' bitmaps (each of ``n_bits`` bits, LSB-first) -> the
    bitmap of the whole frame."""
    if n_bits % 8 == 0:
        return torch.cat(bitmaps, dim=1)
    bits = torch.cat([unpack_bits(bm)[:, :n_bits] for bm in bitmaps], dim=1)
    return pack_bits(torch.nn.functional.pad(bits, (0, -bits.shape[1] % 8)))


def _encode_row_blocks(blocks, thresholds, devices, out_size: int, with_values: bool):
    """L1/L3 of a data shard whose frames are cut into row blocks, one per
    device of its space group; merged on the first one.  Returns (bitmap,
    comp or None, counts, overflow)."""
    home = devices[0]
    outs = [encode_l1(blk, thr, out_size, with_values) for blk, thr in zip(blocks, thresholds)]
    n_bits = blocks[0].shape[1] * blocks[0].shape[2]
    bitmap = _merge_bitmaps([o[0].to(home) for o in outs], n_bits)
    counts = torch.stack([o[2].to(home) for o in outs]).sum(dim=0, dtype=torch.int32)
    if not with_values:
        return bitmap, None, counts, torch.zeros_like(counts, dtype=torch.bool)
    comps = torch.cat([o[1].to(home) for o in outs], dim=1)
    rank = torch.arange(out_size, device=home)
    live = torch.cat([rank[None, :] < o[2].to(home)[:, None] for o in outs], dim=1)
    comp = stream_compact(comps, live, out_size)[0]
    return bitmap, comp, counts, counts > out_size


def make_sharded_encode_step(mesh: CodecMesh, reduction_level: int, bit_depth: int,
                             max_values: int, l2_statistic: str = "max",
                             l4_scheme: str = "weighted_average", shard_rows: bool = False):
    """Build ``step(frames, threshold) -> EncodeResult`` over ``mesh``.

    ``frames`` (B, H, W) uint16 (numpy or a tensor anywhere), B divisible
    by n_data and, with ``shard_rows``, H by n_space (else ValueError);
    ``threshold`` (H, W) uint16, or :func:`~.mesh.replicate`'s copies.  The
    result's tensors are :class:`~.mesh.Sharded` over ``data``.
    """
    if reduction_level not in (1, 2, 3, 4):
        raise ValueError(f"Unknown reduction level: {reduction_level}")
    g_vals, _ = packed_group_shape(bit_depth)
    out_size = -(-max_values // g_vals) * g_vals

    def _local(frames, threshold):
        return encode_frames_auto(frames, threshold, reduction_level, bit_depth, max_values,
                                  l2_statistic=l2_statistic, l4_scheme=l4_scheme)

    def step(frames, threshold) -> EncodeResult:
        placed = shard_frames(frames, mesh, shard_rows)
        thr = replicate(threshold, mesh)
        results = []
        for row, devices in zip(placed, mesh.grid):
            home = devices[0]
            if len(row) == 1:
                results.append(_local(row[0], thr[home]))
                continue
            if reduction_level in (2, 4):
                results.append(_local(torch.cat([blk.to(home) for blk in row], dim=1),
                                      thr[home]))
                continue
            h = row[0].shape[1]
            thresholds = [thr[dev][s * h:(s + 1) * h].contiguous()
                          for s, dev in enumerate(devices)]
            with_values = reduction_level == 1
            bitmap, comp, counts, overflow = _encode_row_blocks(
                row, thresholds, devices, out_size if with_values else 0, with_values)
            if comp is None:
                results.append(EncodeResult(bitmap, None, counts, None, overflow))
            else:
                results.append(EncodeResult(bitmap, bitpack_values_device(comp, bit_depth),
                                            counts, (counts * bit_depth + 7) // 8, overflow))

        def gathered(name):
            shards = [getattr(r, name) for r in results]
            return None if shards[0] is None else Sharded(shards)

        return EncodeResult(*(gathered(name) for name in
                              ("bitmap", "packed", "counts", "packed_len", "overflow")))

    return step


def encode_frames_sharded(frames, threshold, mesh: CodecMesh, reduction_level: int,
                          bit_depth: int, max_values: int, l2_statistic: str = "max",
                          l4_scheme: str = "weighted_average",
                          shard_rows: bool = False) -> EncodeResult:
    """One-shot sharded encode (the step factory, then one step)."""
    step = make_sharded_encode_step(mesh, reduction_level, bit_depth, max_values,
                                    l2_statistic=l2_statistic, l4_scheme=l4_scheme,
                                    shard_rows=shard_rows)
    return step(frames, threshold)
