"""The port's L1 decode (pyrecode_tpu_torch.ops.hopper_decode, ops.decode)
against the Pallas kernel in interpret mode and the JAX package's XLA
decode, exactly.

On the CPU the wrapper runs its plain twin; tests/test_torch_kernels.py
compares the kernel with the twin on the card.
"""

import numpy as np
import pytest
import torch

from pyrecode_tpu.ops import bitpack_values as jax_bitpack_values
from pyrecode_tpu.ops import decode_bitmap_frames as jax_decode_bitmap_frames
from pyrecode_tpu.ops import decode_l1_frames as jax_decode_l1_frames
from pyrecode_tpu.ops import pallas_decode
from pyrecode_tpu_torch import kernel_launch_counts
from pyrecode_tpu_torch.ops import (bitunpack12, decode_bitmap_frames, decode_l1,
                                    decode_l1_frames, encode_l1, hopper_decode)

H, W = 64, 128


def _encoded(density, batch=3, shape=(H, W), seed=0, out_size=None):
    """Frames, threshold, and their L1 bitmap + packed 12-bit values."""
    rng = np.random.default_rng(seed)
    frames = np.where(rng.random((batch, *shape)) < density,
                      rng.integers(1, 4096, (batch, *shape)), 0).astype(np.uint16)
    thr = rng.integers(0, 32, size=shape).astype(np.uint16)
    out_size = out_size or shape[0] * shape[1]
    bitmap, comp, _, _ = encode_l1(torch.from_numpy(frames), torch.from_numpy(thr),
                                   out_size + out_size % 2)
    packed = np.array(jax_bitpack_values(comp.numpy().astype(np.uint32), 12))
    expected = np.where(frames > thr, frames.astype(np.int32) - thr, 0).astype(np.uint16)
    return bitmap.numpy(), packed, expected


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
def test_decode_matches_pallas(density):
    bitmap, packed, expected = _encoded(density, seed=int(density * 100))
    values = bitunpack12(torch.from_numpy(packed))
    dense, ovf = decode_l1(torch.from_numpy(bitmap), values, H, W)
    jdense, jovf = pallas_decode.decode_l1_pallas(bitmap, packed, H, W, 12, bucket=2,
                                                  interpret=True)
    assert dense.dtype == torch.uint16
    assert np.array_equal(dense.numpy(), np.asarray(jdense))
    assert np.array_equal(dense.numpy(), expected)
    assert not ovf.any() and not np.asarray(jovf).any()


@pytest.mark.parametrize("shape", [(40, 40), (37, 29)])
def test_decode_ragged_rows_match_jax(shape):
    """Three frames whose rows are off the kernel's 16-byte boundaries:
    (40, 40) has bitmap rows of 200 bytes, held against the Pallas kernel in
    interpret mode; (37, 29) has n % 8 != 0 as well, held against the JAX
    XLA decode (the Pallas kernel reshapes each bitmap into whole-byte rows
    of W / 8 and does not take W % 8 != 0)."""
    bitmap, packed, expected = _encoded(0.3, shape=shape, seed=7)
    values = bitunpack12(torch.from_numpy(packed))
    dense, ovf = decode_l1(torch.from_numpy(bitmap), values, *shape)
    if shape[1] % 8 == 0:
        want, jovf = pallas_decode.decode_l1_pallas(bitmap, packed, *shape, 12, bucket=2,
                                                    interpret=True)
        assert not np.asarray(jovf).any()
    else:
        want = jax_decode_l1_frames(bitmap, packed, *shape, 12)
    assert np.array_equal(dense.numpy(), np.asarray(want))
    assert np.array_equal(dense.numpy(), expected) and not ovf.any()


def test_plain_decode_matches_jax_xla():
    bitmap, packed, expected = _encoded(0.05, seed=3)
    got = decode_l1_frames(torch.from_numpy(bitmap), torch.from_numpy(packed), H, W, 12)
    want = np.asarray(jax_decode_l1_frames(bitmap, packed, H, W, 12))
    assert np.array_equal(got.numpy(), want) and np.array_equal(got.numpy(), expected)
    ones = decode_bitmap_frames(torch.from_numpy(bitmap), H, W)
    assert np.array_equal(ones.numpy(), np.asarray(jax_decode_bitmap_frames(bitmap, H, W)))


def test_overflow_when_values_fewer_than_count():
    bitmap, packed, expected = _encoded(0.3, seed=5)
    values = bitunpack12(torch.from_numpy(packed))[:, :500].contiguous()
    dense, ovf = decode_l1(torch.from_numpy(bitmap), values, H, W)
    assert ovf.all()
    # ranks past the stored values decode to 0, the rest as usual
    flat = dense.numpy().reshape(3, -1).astype(np.int64)
    for i in range(3):
        fg = np.flatnonzero(expected[i].reshape(-1) > 0)
        assert np.array_equal(flat[i, fg[:500]], expected[i].reshape(-1)[fg[:500]])
        assert not flat[i, fg[500:]].any()


def test_ragged_geometry():
    """H*W % 8 != 0: bits past the frame in the last bitmap byte are ignored."""
    bitmap, packed, expected = _encoded(0.3, shape=(37, 29), seed=6)
    bitmap[:, -1] |= 0xE0            # 37*29 = 1073 pixels: bits 1-7 of the last byte are past it
    values = bitunpack12(torch.from_numpy(packed))
    dense, ovf = decode_l1(torch.from_numpy(bitmap), values, 37, 29)
    assert np.array_equal(dense.numpy(), expected) and not ovf.any()


def test_wrapper_checks_and_counts_no_host_launch():
    bitmap, packed, _ = _encoded(0.01, batch=1)
    values = bitunpack12(torch.from_numpy(packed))
    before = kernel_launch_counts()
    decode_l1(torch.from_numpy(bitmap), values, H, W)
    assert kernel_launch_counts() == before
    with pytest.raises(ValueError):
        decode_l1(torch.from_numpy(bitmap), values, H, W + 8)
    with pytest.raises(TypeError):
        decode_l1(torch.from_numpy(bitmap), values.to(torch.int64), H, W)
