"""The port's L1/L3 encode (pyrecode_tpu_torch.ops.hopper_encode, ops.encode)
against the Pallas kernel in interpret mode and the host oracle, exactly.

On the CPU the wrapper runs its plain twin; tests/test_torch_kernels.py
compares the kernel with the twin on the card.
"""

import numpy as np
import pytest
import torch

from pyrecode_tpu import oracle
from pyrecode_tpu.ops import count_foreground as jax_count_foreground
from pyrecode_tpu.ops import encode_frames as jax_encode_frames
from pyrecode_tpu.ops import encode_frames_auto as jax_encode_frames_auto
from pyrecode_tpu.ops import pallas_encode
from pyrecode_tpu_torch import kernel_launch_counts
from pyrecode_tpu_torch.ops import bitpack12, count_foreground, encode_frames_auto, hopper_encode

SHAPE = (64, 128)          # the Pallas kernel needs width % 128 == 0, height % 8 == 0
OUT_SIZE = SHAPE[0] * SHAPE[1]


def _frames(density, batch=3, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.where(rng.random((batch, *shape)) < density,
                      rng.integers(1, 4096, (batch, *shape)), 0).astype(np.uint16)
    thr = rng.integers(0, 32, size=shape).astype(np.uint16)
    return frames, thr


def _odd_count_frames():
    frames, thr = _frames(0.05, seed=7)
    mask = frames[0] > thr
    if mask.sum() % 2 == 0:
        frames[0, 0, 0] = thr[0, 0] if mask[0, 0] else thr[0, 0] + 9
    assert (frames[0] > thr).sum() % 2 == 1
    return frames, thr


def _port(frames, thr, out_size, with_values=True):
    return hopper_encode.encode_l1(torch.from_numpy(frames), torch.from_numpy(thr), out_size,
                                   with_values)


@pytest.mark.parametrize("case", ["zero", "1%", "30%", "100%", "odd count"])
def test_encode_matches_pallas_and_oracle(case):
    if case == "odd count":
        frames, thr = _odd_count_frames()
    else:
        density = {"zero": 0.0, "1%": 0.01, "30%": 0.3, "100%": 1.0}[case]
        frames, thr = _frames(density)
        if density == 1.0:
            frames = np.maximum(frames, 32).astype(np.uint16)
    bitmap, comp, counts, ovf = (t.numpy() for t in _port(frames, thr, OUT_SIZE))
    # bucket 2 holds a whole 128-px sub-row: no JAX overflow at any density
    jb, jc, jn, jo = map(np.asarray, pallas_encode.encode_l1_pallas(
        frames, thr, out_size=OUT_SIZE, bucket=2, interpret=True))
    assert np.array_equal(bitmap, jb)
    assert np.array_equal(counts, jn) and not ovf.any() and not jo.any()
    for i in range(frames.shape[0]):
        n = int(counts[i])
        assert np.array_equal(comp[i, :n], jc[i, :n])
        assert not comp[i, n:].any()          # the zero tail
        enc = oracle.reduce_frame(frames[i], thr, 1, 12)
        assert bitmap[i].tobytes() == enc["packed_binary_map"]
        packed = bitpack12(torch.from_numpy(comp[i:i + 1])).numpy()[0]
        assert packed[: (n * 12 + 7) // 8].tobytes() == enc["packed_pixvals"]
    if case == "odd count":
        assert counts[0] % 2 == 1


def test_l3_bitmap_and_counts():
    frames, thr = _frames(0.05, seed=5)
    bitmap, comp, counts, ovf = _port(frames, thr, 0, with_values=False)
    jb, jc, jn, jo = pallas_encode.encode_l1_pallas(frames, thr, out_size=128, bucket=2,
                                                    with_values=False, interpret=True)
    assert comp is None and jc is None
    assert np.array_equal(bitmap.numpy(), np.asarray(jb))
    assert np.array_equal(counts.numpy(), np.asarray(jn))
    assert not ovf.any()
    for i in range(frames.shape[0]):
        assert bitmap[i].numpy().tobytes() == oracle.reduce_frame(frames[i], thr, 3, 12)[
            "packed_binary_map"]


def test_overflow_when_out_size_below_count():
    frames, thr = _frames(0.3, seed=8)
    out_size = 1000
    bitmap, comp, counts, ovf = _port(frames, thr, out_size)
    _, _, jn, jo = pallas_encode.encode_l1_pallas(frames, thr, out_size=out_size, bucket=2,
                                                  interpret=True)
    assert np.array_equal(counts.numpy(), np.asarray(jn))
    assert (counts > out_size).all()
    assert np.array_equal(ovf.numpy(), np.asarray(jo)) and ovf.all()
    for i in range(frames.shape[0]):   # the first out_size values are kept
        residuals = (frames[i].astype(np.int32) - thr)[frames[i] > thr]
        assert np.array_equal(comp[i].numpy(), residuals[:out_size])


def test_ragged_geometry_matches_oracle():
    """H*W % 8 != 0 (no Pallas counterpart): the bitmap's tail bits are 0."""
    frames, thr = _frames(0.3, shape=(37, 29), seed=4)
    bitmap, comp, counts, _ = _port(frames, thr, 2048)
    assert bitmap.shape == (3, (37 * 29 + 7) // 8)
    for i in range(frames.shape[0]):
        enc = oracle.reduce_frame(frames[i], thr, 1, 12)
        assert bitmap[i].numpy().tobytes() == enc["packed_binary_map"]
        residuals = (frames[i].astype(np.int32) - thr)[frames[i] > thr]
        assert np.array_equal(comp[i, : int(counts[i])].numpy(), residuals)


def test_encode_frames_auto_matches_jax():
    frames, thr = _frames(0.02, seed=2)
    res = encode_frames_auto(torch.from_numpy(frames), torch.from_numpy(thr), 1, 12, 2048)
    jres = jax_encode_frames_auto(frames, thr, reduction_level=1, bit_depth=12, max_values=2048)
    assert np.array_equal(res.bitmap.numpy(), np.asarray(jres.bitmap))
    assert np.array_equal(res.counts.numpy(), np.asarray(jres.counts))
    assert np.array_equal(res.packed_len.numpy(), np.asarray(jres.packed_len))
    packed, jpacked = res.packed.numpy(), np.asarray(jres.packed)
    for i, plen in enumerate(res.packed_len.tolist()):
        assert packed[i, :plen].tobytes() == jpacked[i, :plen].tobytes()
    l3 = encode_frames_auto(torch.from_numpy(frames), torch.from_numpy(thr), 3, 12, 2048)
    assert l3.packed is None and np.array_equal(l3.bitmap.numpy(), res.bitmap.numpy())
    assert np.array_equal(count_foreground(torch.from_numpy(frames), torch.from_numpy(thr)).numpy(),
                          np.asarray(jax_count_foreground(frames, thr)))
    for level in (2, 4):   # the JAX writer's L2/L4 path is ops.encode_frames (XLA)
        got = encode_frames_auto(torch.from_numpy(frames), torch.from_numpy(thr), level, 12, 2048)
        want = jax_encode_frames(frames, thr, reduction_level=level, bit_depth=12,
                                 max_values=2048)
        assert np.array_equal(got.bitmap.numpy(), np.asarray(want.bitmap))
        assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
        if level == 2:
            assert np.array_equal(got.packed.numpy(), np.asarray(want.packed))
            assert np.array_equal(got.packed_len.numpy(), np.asarray(want.packed_len))


def test_wrapper_checks_and_counts_no_host_launch():
    frames, thr = _frames(0.01, batch=1)
    before = kernel_launch_counts()
    _port(frames, thr, 1024)
    assert kernel_launch_counts() == before
    with pytest.raises(TypeError):
        hopper_encode.encode_l1(torch.from_numpy(frames.astype(np.int32)), torch.from_numpy(thr),
                                1024)
    with pytest.raises(ValueError):
        hopper_encode.encode_l1(torch.from_numpy(frames), torch.from_numpy(thr[:, :64].copy()),
                                1024)
    with pytest.raises(ValueError):
        hopper_encode.encode_l1(torch.from_numpy(frames), torch.from_numpy(thr), -1)
