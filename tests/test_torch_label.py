"""The port's L2/L4 encode against the JAX package and the host oracle,
exactly (all integer): the plain twins (``ops.cc_label``, ``ops.segment``,
``ops.compact``), the label kernel's wrapper (``ops.hopper_label``, its twin
on the CPU), ``encode_frames_auto`` at L2/L4 and ``utils.converters``.

The JAX side runs its XLA path (``ops.encode_frames``, ``cc_label``,
``segment``) and, in one L2 and one L4 case, the Pallas kernel in
interpret mode.  tests/test_torch_kernels.py holds the CUDA kernel to the
twin on the card.
"""

import numpy as np
import pytest
import torch

from chip_smoke import label_edge_frames, label_tile_shapes, make_puddle_frames
from pyrecode_tpu import oracle
from pyrecode_tpu.ops import cc_label as jax_cc_label
from pyrecode_tpu.ops import compact as jax_compact
from pyrecode_tpu.ops import encode_frames as jax_encode_frames
from pyrecode_tpu.ops import segment as jax_segment
from pyrecode_tpu.ops.pallas_label import encode_l2l4_pallas
from pyrecode_tpu.utils.converters import l1_to_l4_batch as jax_l1_to_l4_batch
from pyrecode_tpu_torch import kernel_launch_counts
from pyrecode_tpu_torch.ops import cc_label, compact, encode_frames_auto, hopper_label, segment
from pyrecode_tpu_torch.utils.converters import l1_to_l4_batch

SHAPE = (64, 128)
CONFIGS = [(2, "max"), (2, "sum"), (4, "weighted_average"), (4, "unweighted"), (4, "max")]
EDGE = label_edge_frames(np.random.default_rng(3), *SHAPE)
EDGE_WIDE = label_edge_frames(np.random.default_rng(4), 128, 256)
# the edge battery at the shapes of the CUDA kernel's tile batteries, puddles
# across its tile borders included
TILE_SHAPES = label_tile_shapes()
TILES = {name: label_edge_frames(np.random.default_rng(11 + i), *shape)
         for i, (name, shape) in enumerate(TILE_SHAPES.items())}


def _puddles(batch=3, shape=SHAPE, seed=0):
    """Puddle frames at ~8x the slice's hit density, and their threshold."""
    frames, dark = make_puddle_frames(np.random.default_rng(seed), batch, *shape,
                                      hits=320000)
    return frames, (dark + 2).astype(np.uint16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mode(level, name):
    return hopper_label.MODE_BY_CONFIG[(level, name)]


@pytest.mark.parametrize("case", ["puddles", *EDGE])
def test_label_components_matches_jax_and_scipy(case):
    if case == "puddles":
        frames, thr = _puddles()
        mask = frames > thr
    else:
        mask = EDGE[case][None] > 0
    labels, counts = cc_label.label_components(_t(mask))
    jl, jc = jax_cc_label.label_components(mask)
    assert np.array_equal(labels.numpy(), np.asarray(jl))
    assert np.array_equal(counts.numpy(), np.asarray(jc))
    for i in range(mask.shape[0]):
        want, num = oracle.label_components(mask[i])
        assert int(counts[i]) == num and np.array_equal(labels[i].numpy(), want)


@pytest.mark.parametrize("battery", list(TILES))
def test_tile_battery_labels_match_jax_and_scipy(battery):
    """The labelling twin on the tile batteries (frames just over one tile,
    2 x 3 tiles and a ragged edge, ragged in both; puddles across the tile
    borders, joined only at corner diagonals, runs over row ends) against
    the JAX labelling and scipy's; the spiral against scipy's only (the JAX
    labelling takes one round a pixel of its ~20k-pixel path)."""
    names = list(TILES[battery])
    mask = np.stack([TILES[battery][k] for k in names]) > 0
    labels, counts = cc_label.label_components(_t(mask))
    flat = [i for i, k in enumerate(names) if k != "spiral"]
    jl, jc = jax_cc_label.label_components(mask[flat])
    assert np.array_equal(labels.numpy()[flat], np.asarray(jl))
    assert np.array_equal(counts.numpy()[flat], np.asarray(jc))
    for i in range(mask.shape[0]):
        want, num = oracle.label_components(mask[i])
        assert int(counts[i]) == num and np.array_equal(labels[i].numpy(), want), names[i]


@pytest.mark.parametrize("level,name", CONFIGS)
def test_segment_matches_jax_and_oracle(level, name):
    frames, thr = _puddles(seed=1)
    mask = frames > thr
    labels, counts = cc_label.label_components(_t(mask))
    jl = np.asarray(jax_cc_label.label_components(mask)[0])
    P = 256
    if level == 2:
        got = segment.l2_summary_stats(labels, _t(frames), P, name, 4095)
        want = jax_segment.l2_summary_stats(jl, frames, P, statistic=name, bit_depth=12)
    else:
        got = segment.l4_centroid_pixels(labels, _t(frames), P, name)
        want = jax_segment.l4_centroid_pixels(jl, frames, P, scheme=name)
        cmask = segment.centroid_pixels_to_mask(got, counts, *SHAPE)
        jmask = jax_segment.centroid_pixels_to_mask(want, np.asarray(counts), *SHAPE)
        assert np.array_equal(cmask.numpy(), np.asarray(jmask))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for i in range(frames.shape[0]):
        olab, num = oracle.label_components(mask[i])
        n = int(counts[i])
        if level == 2:
            exp = np.minimum(oracle.l2_summary_stats(olab, frames[i], num, name), 4095)
            assert np.array_equal(got[i, :n].numpy(), exp) and not got[i, n:].any()
        else:
            assert np.array_equal(got[i, :n].numpy(),
                                  oracle.l4_centroid_pixels(olab, frames[i], num, name))
            assert np.array_equal(segment.l4_centroids(labels, _t(frames), P, name)[i, :n].numpy(),
                                  oracle.l4_centroids(olab, frames[i], num, name))


def test_stream_compact_matches_jax():
    rng = np.random.default_rng(5)
    values = rng.integers(-1000, 1000, (3, 500)).astype(np.int32)
    mask = rng.random((3, 500)) < np.array([[0.0], [0.1], [0.9]])
    for out_size in (500, 40):
        got, count = compact.stream_compact(_t(values), _t(mask), out_size)
        want, wcount = jax_compact.stream_compact(values, mask, out_size)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(count.numpy(), np.asarray(wcount))


def _oracle_check(frames, thr, level, name, bitmap, stats, counts):
    for i in range(frames.shape[0]):
        enc = oracle.reduce_frame(frames[i], thr, level, 12, l2_statistic=name, l4_scheme=name)
        assert bitmap[i].numpy().tobytes() == enc["packed_binary_map"], i
        if level == 2:
            n = int(counts[i])
            assert oracle.bit_pack(stats[i, :n].numpy(), 12).tobytes() == enc["packed_pixvals"]
            assert not stats[i, n:].any()


@pytest.mark.parametrize("battery", ["puddles", "edge 64x128", "edge 128x256", "37x29",
                                     *TILES, "tile puddles"])
@pytest.mark.parametrize("level,name", CONFIGS)
def test_encode_l2l4_matches_oracle(level, name, battery):
    """The kernel's twin (the CPU path of the wrapper) against
    oracle.reduce_frame, including puddles taller and wider than the TPU
    kernel's halo, ragged geometry, and the CUDA kernel's tile batteries
    (with puddle frames of 2 x 3 tiles and a ragged edge)."""
    if battery == "puddles":
        frames, thr = _puddles(seed=2)
    elif battery == "37x29":
        frames, thr = _puddles(shape=(37, 29), seed=6)
    elif battery == "tile puddles":
        frames, thr = _puddles(shape=TILE_SHAPES["2 x 3 tiles and a ragged edge"], seed=12)
    else:
        edge = {"edge 64x128": EDGE, "edge 128x256": EDGE_WIDE}.get(battery) or TILES[battery]
        frames = np.stack(list(edge.values()))
        thr = np.zeros(frames.shape[1:], np.uint16)
    n = frames.shape[1] * frames.shape[2]
    bitmap, stats, counts, overflow = hopper_label.encode_l2l4(
        _t(frames), _t(thr), _mode(level, name), n, 4095)
    assert not overflow.any() and (stats is None) == (level == 4)
    _oracle_check(frames, thr, level, name, bitmap, stats, counts)


def test_encode_l2l4_overflow_and_checks():
    frames, thr = _puddles(batch=2, seed=7)
    before = kernel_launch_counts()
    bitmap, stats, counts, overflow = hopper_label.encode_l2l4(_t(frames), _t(thr), "l2sum", 4,
                                                               4095)
    assert kernel_launch_counts() == before          # the CPU runs the twin
    assert overflow.all() and stats.shape == (2, 4) and (counts > 4).all()
    full = hopper_label.encode_l2l4(_t(frames), _t(thr), "l2sum", 4096, 4095)[1]
    assert torch.equal(stats, full[:, :4])            # the first puddles, in raster order
    with pytest.raises(ValueError, match="mode"):
        hopper_label.encode_l2l4(_t(frames), _t(thr), "l3", 16, 4095)
    with pytest.raises(TypeError):
        hopper_label.encode_l2l4(_t(frames.astype(np.int32)), _t(thr), "l2sum", 16, 4095)
    with pytest.raises(ValueError, match="threshold"):
        hopper_label.encode_l2l4(_t(frames), _t(thr[:, :64]), "l2sum", 16, 4095)


@pytest.mark.parametrize("level,name", CONFIGS)
def test_encode_frames_auto_matches_jax(level, name):
    """L2/L4 of encode_frames_auto against the JAX XLA path the JAX writer
    runs (ops.encode_frames), bitmap, packed stream and counts."""
    frames, thr = _puddles(seed=8)
    res = encode_frames_auto(_t(frames), _t(thr), level, 12, 2048, l2_statistic=name,
                             l4_scheme=name)
    jres = jax_encode_frames(frames, thr, reduction_level=level, bit_depth=12, max_values=2048,
                             l2_statistic=name, l4_scheme=name)
    assert np.array_equal(res.bitmap.numpy(), np.asarray(jres.bitmap))
    assert np.array_equal(res.counts.numpy(), np.asarray(jres.counts))
    assert np.array_equal(res.overflow.numpy(), np.asarray(jres.overflow))
    if level == 4:
        assert res.packed is None and jres.packed is None
        return
    assert np.array_equal(res.packed_len.numpy(), np.asarray(jres.packed_len))
    assert np.array_equal(res.packed.numpy(), np.asarray(jres.packed))


@pytest.mark.parametrize("level,name", [(2, "sum"), (4, "unweighted")])
def test_encode_l2l4_matches_pallas(level, name):
    """Against the TPU kernel in interpret mode, where its halo holds the
    puddles (one L2 and one L4 case: each interpret build takes seconds)."""
    frames, dark = make_puddle_frames(np.random.default_rng(9), 2, 32, 128, hits=120000)
    thr = (dark + 2).astype(np.uint16)
    got = hopper_label.encode_l2l4(_t(frames), _t(thr), _mode(level, name), 1024, 4095)
    want = encode_l2l4_pallas(frames, thr, level, out_size=1024, bit_depth=12, statistic=name,
                              scheme=name, halo_bucket=1, interpret=True)
    assert not np.asarray(want[3]).any()
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    if level == 2:
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("method", ["weighted_average", "unweighted", "max"])
def test_l1_to_l4_batch_matches_jax(method):
    frames, thr = _puddles(seed=10)
    dense = np.where(frames > thr, frames - thr, 0).astype(np.uint16)
    got = l1_to_l4_batch(dense, method, device="cpu")
    assert got.dtype == bool and got.shape == dense.shape
    assert np.array_equal(got, jax_l1_to_l4_batch(dense, method))
    with pytest.raises(ValueError, match="max_puddles"):
        l1_to_l4_batch(dense, method, max_puddles=1, device="cpu")
