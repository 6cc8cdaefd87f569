"""Multi-device and multi-process encode: per-shard kernels and the ordered gather.

Port of pyrecode_tpu/parallel/multihost.py.  ``jax.shard_map`` of a Pallas
kernel over the ``data`` axis becomes one launch per data shard, each on its
device's current stream; ``jax.distributed`` and
``multihost_utils.process_allgather`` become ``torch.distributed``:

* :func:`make_encode_step` -- the fused L1 encode and the 12-bit pack per
  shard (the counterpart of ``make_pallas_encode_step``);
* :func:`gather_ordered_blocks` -- each frame's (bitmap, packed) bytes in
  acquisition order.  Frames are sharded contiguously over ``data`` (shard
  d owns frames [d*B/D, (d+1)*B/D)), exactly the reference's per-node
  slicing (recode_writer.py:320-322), so data-axis order, then rank order
  across processes, is acquisition order and the assembled container is
  the single-device one.  Across processes only the compressed blocks move,
  gathered as host bytes to one rank over the default process group (gloo
  carries them; the caller initialises the group with its address, world
  size and rank);
* :func:`make_entropy_steps` -- the deflate tokenizer and assembler per
  shard, the host building each stream's Huffman tables between them;
* :func:`make_rans_steps` -- the byte-mode rANS encode of token streams
  and the rANS decode per shard.  They take the port's table formats
  (freq / cum, and the (3, 4096) slot tables of
  :func:`~..ops.hopper_rans.decode_tables`), not the TPU's radix LUTs.

Every step takes numpy arrays or tensors (split over ``data`` here) or
:class:`~.mesh.Sharded` batches of its mesh, and returns Sharded outputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import hopper_deflate, hopper_rans
from ..ops.bitpack import bitpack_values_device, packed_group_shape
from ..ops.hopper_encode import encode_l1
from .mesh import CodecMesh, Sharded, replicate, shard_batch


def _per_shard(mesh: CodecMesh, fn, *batches):
    """fn on each data shard of ``batches`` -> one Sharded per output."""
    shards = [shard_batch(b, mesh) for b in batches]
    outs = [fn(*parts) for parts in zip(*shards)]
    return tuple(Sharded(list(col)) for col in zip(*outs))


def replicate_threshold(threshold, mesh: CodecMesh) -> dict:
    """The dark/calibration threshold as uint16, one copy on every distinct
    device."""
    return replicate(np.asarray(threshold, np.uint16), mesh)


def make_encode_step(mesh: CodecMesh, out_size: int, bit_depth: int = 12,
                     with_values: bool = True):
    """The per-shard fused encode over the ``data`` axis: the counterpart of
    pyrecode_tpu/parallel/multihost.py:make_pallas_encode_step.

    Returns ``step(frames, threshold) -> (bitmap, packed, counts,
    overflow)``, Sharded over ``data``: the L1 encode kernel and, with
    values, the 12-bit pack on every shard (packed is one zero byte a frame
    without values).  ``out_size`` is rounded up to the pack group;
    ``frames.shape[0]`` must divide evenly over ``data``.
    """
    g_vals, _ = packed_group_shape(bit_depth)
    size = -(-out_size // g_vals) * g_vals if with_values else 0

    def step(frames, threshold):
        thr = replicate(threshold, mesh)

        def local(x):
            bitmap, comp, counts, overflow = encode_l1(x, thr[x.device], size, with_values)
            packed = bitpack_values_device(comp, bit_depth) if with_values else \
                torch.zeros((x.shape[0], 1), dtype=torch.uint8, device=x.device)
            return bitmap, packed, counts, overflow

        return _per_shard(mesh, local, frames)

    return step


def _host(x) -> np.ndarray:
    if isinstance(x, Sharded):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def gather_ordered_blocks(bitmap, packed, counts, bit_depth: int,
                          process_index: Optional[int] = None):
    """Per-frame (bitmap_bytes, packed_bytes) in acquisition order.

    Takes :func:`make_encode_step`'s outputs (or tensors / arrays).  When
    ``torch.distributed`` is initialised with a world size above 1, every
    rank's blocks are gathered as host bytes to rank ``process_index``
    (default 0), which returns all of them in rank order; the other ranks
    return None.
    """
    bitmap, packed, counts = _host(bitmap), _host(packed), _host(counts)
    blocks = [(bitmap[i].tobytes(), packed[i][:(int(counts[i]) * bit_depth + 7) // 8].tobytes())
              for i in range(bitmap.shape[0])]
    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return blocks
    dst = 0 if process_index is None else process_index
    parts = [None] * dist.get_world_size() if dist.get_rank() == dst else None
    dist.gather_object(blocks, parts, dst=dst)
    if dist.get_rank() != dst:
        return None
    return [block for part in parts for block in part]


def make_entropy_steps(mesh: CodecMesh, out_bound: int):
    """The scheme-0 device entropy kernels per shard over ``data``.

    Returns ``(tokenize, assemble)``; the O(alphabet) Huffman tables
    between them are per-stream host work (``codecs.dyndeflate.host_tables``
    or ``native.entropy_host_tables``), as in the reference's per-process
    entropy stage (recode_writer.py:497-550).

    ``tokenize(streams (B, NPAD) uint8, lengths (B,) int32)`` -> (tok (B,
    NPAD) uint16, hist (B, 512) int32, adler (B,) int64).
    ``assemble(tok, luts (B, 48, 32) float32, phases (B,) int32, partials
    (B,) int32)`` -> (body (B, out_bound rounded up to 128) uint8, total
    bits (B,) int32, overflow (B,) bool).
    """
    def tokenize(streams, lengths):
        return _per_shard(mesh, hopper_deflate.tokenize, streams, lengths)

    def assemble(tok, luts, phases, partials):
        return _per_shard(mesh, lambda t, lut, ph, pa: hopper_deflate.assemble(
            t, lut, ph, pa, out_bound), tok, luts, phases, partials)

    return tokenize, assemble


def make_rans_steps(mesh: CodecMesh, out_bound: int, npad_tok: int):
    """The scheme-12 rANS kernels per shard over ``data``: byte-mode encode
    of dense token streams (#9t) and the symbol decode (#10), the codec
    whose decode also runs on the device.

    Returns ``(encode, decode)``.
    ``encode(dense (B, N) uint16/int32 inverted tokens, freq (B, 4096) int32,
    cum (B, 4096) int32, m (B,) int32)`` -> (body (B, out_bound) uint8,
    states (B, 1024) int32, counts (B,) int32).
    ``decode(body_rev (B, BW) uint8, blen (B,) int32, states (B, 1024) int32,
    m (B,) int32, tables (B, 3, 4096) int32)`` -> (syms (B, npad_tok) int32,
    underflow (B,) bool).
    """
    def encode(dense, freq, cum, m):
        return _per_shard(mesh, lambda t, f, c, k: hopper_rans.rans_encode_tokens(
            t, f, c, k, out_bound), dense, freq, cum, m)

    def decode(body_rev, blen, states, m, tables):
        return _per_shard(mesh, lambda b, n, s, k, t: hopper_rans.rans_decode(
            b, n, s, k, t, npad_tok, 1), body_rev, blen, states, m, tables)

    return encode, decode
