"""The port's bitmap -> positions kernel (``ops.hopper_gaps``, its twin on
the CPU) and the positions-free scheme-12 gap coder
(``codecs.rans.rans_gaps_batch_device`` without ``positions``) against the
JAX package: ``pallas_gaps.bitmap_positions_pallas`` and the JAX gap coder,
both in interpret mode, byte for byte.
"""

import numpy as np
import pytest
import torch

from pyrecode_tpu.codecs import rans as jrans
from pyrecode_tpu.ops.pallas_gaps import bitmap_positions_pallas
from pyrecode_tpu_torch import kernel_launch_counts
from pyrecode_tpu_torch.codecs import rans as trans
from pyrecode_tpu_torch.ops import hopper_gaps


def _bitmaps(densities, n_bytes, seed):
    rng = np.random.default_rng(seed)
    bits = rng.random((len(densities), n_bytes * 8)) < np.array(densities)[:, None]
    return bits, np.packbits(bits, axis=1, bitorder="little")


@pytest.mark.parametrize("densities", [(0.0, 0.01), (0.15, 0.05)])
def test_positions_match_pallas(densities):
    bits, bitmaps = _bitmaps(densities, 16384, seed=int(densities[1] * 100))
    out_size = 32768
    before = kernel_launch_counts()
    pos, counts, overflow = hopper_gaps.bitmap_positions(torch.from_numpy(bitmaps), out_size)
    assert kernel_launch_counts() == before           # the CPU runs the twin
    want = bitmap_positions_pallas(bitmaps, out_size, bucket=2, interpret=True)
    assert not np.asarray(want[2]).any() and not overflow.any()
    assert np.array_equal(pos.numpy(), np.asarray(want[0]))
    assert np.array_equal(counts.numpy(), np.asarray(want[1]))
    for b in range(len(densities)):
        assert np.array_equal(pos[b, :counts[b]].numpy(), np.flatnonzero(bits[b]))


def test_positions_overflow_and_ragged_rows():
    """Any NB (the TPU kernel takes multiples of 8192 only); the count is
    clipped to out_size and the overflow flag set above it."""
    bits, bitmaps = _bitmaps((0.3, 0.001, 1.0), 1001, seed=3)
    pos, counts, overflow = hopper_gaps.bitmap_positions(torch.from_numpy(bitmaps), 100)
    n = bits.sum(axis=1)
    assert counts.tolist() == np.minimum(n, 100).tolist()
    assert overflow.tolist() == (n > 100).tolist()
    for b in range(3):
        assert np.array_equal(pos[b, :counts[b]].numpy(), np.flatnonzero(bits[b])[:100])
        assert not pos[b, counts[b]:].any()
    with pytest.raises(TypeError):
        hopper_gaps.bitmap_positions(torch.from_numpy(bitmaps.astype(np.int32)), 100)
    with pytest.raises(ValueError):
        hopper_gaps.bitmap_positions(torch.zeros((1, 0), dtype=torch.uint8), 100)


def test_gaps_without_positions_match_jax():
    """131072-byte bitmaps: one of ~8% set bits (>= 65536: the device
    coder), one sparse (the host coder), one with a >= 4095-bit clear run
    (escape symbols: the host coder), against the JAX coder's positions
    path, which the JAX writer takes at L2/L3/L4."""
    bits, bitmaps = _bitmaps((0.08, 0.002, 0.07), 131072, seed=5)
    bits[2, 5000:20000] = False
    bitmaps = np.packbits(bits, axis=1, bitorder="little")
    assert bits[0].sum() >= 65536
    blens = np.full(3, bitmaps.shape[1])
    want = jrans.rans_gaps_batch_device(bitmaps, blens, interpret=True)
    got = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps), blens)
    assert got == want
    assert got[0][2] == 10 and got[0][3] == 6          # 1024 lanes, gap mode
    for b in range(3):
        assert trans.decompress(got[b]) == bitmaps[b].tobytes()


def test_gaps_whole_batch_host_fallback():
    """More set bits than the positions capacity in one frame (here over a
    quarter of the bits, the default 2 * NB) sends the whole batch to the
    host coder, as the JAX coder does when its capacity buckets run out:
    the other frame, device-coded on its own, is host-coded too."""
    bits, bitmaps = _bitmaps((0.3, 0.07), 131072, seed=7)
    blens = np.full(2, bitmaps.shape[1])
    alone = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps[1:]), blens[1:])
    assert alone[0][2] == 10 and alone[0][3] == 6      # 1024 lanes, gap mode
    got = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps), blens)
    assert got == [trans.compress_gaps(b.tobytes()) for b in bitmaps]
    assert got[1] != alone[0]
    assert got == jrans.rans_gaps_batch_device(bitmaps, blens, interpret=True)
