"""The port's probe kernels (P1-P5) on the CPU, where each wrapper runs its
plain twin, against the JAX package's probes and kernels in interpret mode
and against numpy, exactly; and each probe tool end to end with
``--device cpu``.

* P1 / P2, the phase cut-offs of the encode and decode, at 2 x 256^2: "full"
  against the port's encode_l1 / decode_l1 twins and the Pallas kernels,
  "bitmap" against the Pallas bitmap, "load" against an int64 numpy sum,
  "store" against the unpacked bitmap, the tile counts and offsets against
  numpy;
* P5, the butterfly, each formulation alone and the four through
  ``butterfly_all``, against the JAX probe's own formulations inside
  ``pl.pallas_call(..., interpret=True)`` and the stable-compaction oracle;
* P4, the f32 product, against ``lut[:, idx]``, ``jax.lax.dot_general`` at
  HIGHEST, a numpy emulation of TF32 rounding, and the JAX probe's kernel
  body at HIGHEST inside ``pl.pallas_call(..., interpret=True)``;
* P3, the eight lowering probes, alone and through ``mosaic_all``, against
  numpy and against the JAX probe's kernel bodies inside
  ``pl.pallas_call(..., interpret=True)`` (SMEM specs as the probe has them).

tests/test_torch_kernels.py holds each kernel against its twin on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pyrecode_tpu.ops import pallas_decode, pallas_encode
from pyrecode_tpu.ops.bitpack import bitpack_values as jax_bitpack_values
from pyrecode_tpu_torch.ops import hopper_decode, hopper_encode, hopper_probes
from pyrecode_tpu_torch.ops._launch import TILE_PIXELS
from pyrecode_tpu_torch.tools import (probe_butterfly, probe_decode_phases, probe_f32dot,
                                      probe_mosaic, probe_phases)
from tools.probe_butterfly import make_variants

SHAPE = (2, 256, 256)
OUT_SIZE = 4096


@pytest.fixture(scope="module")
def batch():
    """Frames at ~1% foreground, a threshold, and the Pallas encode of them."""
    rng = np.random.default_rng(71)
    frames = np.where(rng.random(SHAPE) < 0.01, rng.integers(1, 4096, SHAPE), 0).astype(np.uint16)
    thr = rng.integers(0, 32, SHAPE[1:]).astype(np.uint16)
    jax_out = [np.array(a) for a in pallas_encode.encode_l1_pallas(
        frames, thr, out_size=OUT_SIZE, bucket=2, interpret=True)]
    return frames, thr, jax_out


def _tiles(x):
    """numpy per-tile sums of (B, n) over TILE_PIXELS pixels, as int64."""
    B, n = x.shape
    pad = np.zeros((B, -n % TILE_PIXELS), x.dtype)
    return np.concatenate([x, pad], axis=1).reshape(B, -1, TILE_PIXELS).sum(axis=2, dtype=np.int64)


@pytest.mark.parametrize("phase", hopper_encode.PHASES)
def test_encode_phases_match_jax_and_numpy(batch, phase):
    frames, thr, (jb, jc, jn, jo) = batch
    got = [t.numpy() if t is not None else None for t in hopper_encode.encode_l1_phases(
        torch.from_numpy(frames), torch.from_numpy(thr), OUT_SIZE, True, phase)]
    f = frames.reshape(2, -1).astype(np.int64)
    t = thr.reshape(1, -1).astype(np.int64)
    mask = (f > t).astype(np.int64)
    if phase == "load":
        assert got[0].dtype == np.int64
        assert np.array_equal(got[0], _tiles(f - t))
        assert np.array_equal(got[0].sum(axis=1), (f - t).sum(axis=1))
        return
    assert np.array_equal(got[0], jb)                       # the bitmap
    if phase == "bitmap":
        assert np.array_equal(got[1], _tiles(mask))
    elif phase == "scan":
        tiles = _tiles(mask)
        assert np.array_equal(got[1], np.cumsum(tiles, axis=1) - tiles)
        assert np.array_equal(got[2], jn) and not got[3].any()
    else:
        twin = hopper_encode.encode_l1(torch.from_numpy(frames), torch.from_numpy(thr), OUT_SIZE)
        for g, w in zip(got, twin):
            assert np.array_equal(g, w.numpy())
        assert np.array_equal(got[2], jn) and not got[3].any() and not jo.any()
        for i in range(2):
            n = int(jn[i])
            assert np.array_equal(got[1][i, :n], jc[i, :n]) and not got[1][i, n:].any()


@pytest.fixture(scope="module")
def decoded(batch):
    frames, thr, (jb, jc, jn, _) = batch
    packed = np.array(jax_bitpack_values(jc.astype(np.uint32), 12))
    jdense, jovf = pallas_decode.decode_l1_pallas(jb, packed, *SHAPE[1:], 12, bucket=2,
                                                  interpret=True)
    return jb, jc, np.asarray(jdense), np.asarray(jovf), np.where(frames > thr, frames - thr, 0)


@pytest.mark.parametrize("phase", hopper_decode.PHASES)
def test_decode_phases_match_jax_and_numpy(decoded, phase):
    bitmap, values, jdense, jovf, want = decoded
    got = [t.numpy() for t in hopper_decode.decode_l1_phases(
        torch.from_numpy(bitmap), torch.from_numpy(values), *SHAPE[1:], stop_after=phase)]
    bits = np.unpackbits(bitmap, axis=1, bitorder="little")[:, :SHAPE[1] * SHAPE[2]]
    tiles = _tiles(bits.astype(np.int64))
    if phase == "store":
        assert got[0].dtype == np.uint16 and np.array_equal(got[0].reshape(2, -1), bits)
    elif phase == "count":
        assert np.array_equal(got[0], tiles)
    elif phase == "scan":
        assert np.array_equal(got[0], np.cumsum(tiles, axis=1) - tiles)
        assert np.array_equal(got[1], tiles.sum(axis=1)) and not got[2].any()
    else:
        assert np.array_equal(got[0], jdense) and np.array_equal(got[0], want)
        assert not got[1].any() and not jovf.any()
        twin = hopper_decode.decode_l1(torch.from_numpy(bitmap), torch.from_numpy(values),
                                       *SHAPE[1:])
        assert np.array_equal(got[0], twin[0].numpy())


def _pallas_butterfly(variant: str, sub: int):
    """The JAX probe's kernel for ``variant`` at S x sub, as its main()
    builds it, run by pl.pallas_call in interpret mode."""
    fn = make_variants()[variant]
    S = probe_butterfly.S

    def kernel(m_ref, v_ref, o_ref):
        o_ref[...] = fn(m_ref[...], v_ref[...], S, sub) & 0xFFFF

    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((S, sub), jnp.int32),
                          interpret=True)
    return lambda m, v: np.asarray(call(jnp.asarray(m), jnp.asarray(v)))


@pytest.mark.parametrize("sub", probe_butterfly.SUBS)
@pytest.mark.parametrize("variant", hopper_probes.BUTTERFLY_VARIANTS)
def test_butterfly_twin_matches_the_pallas_probe(variant, sub):
    """The JAX probe's SUBs and four densities from default_rng(1): the twin
    equals the JAX probe's formulation run by pl.pallas_call in interpret
    mode, and the stable compaction."""
    call = _pallas_butterfly(variant, sub)
    for dens, m, v in probe_butterfly.make_cases(np.random.default_rng(1), sub):
        got = hopper_probes.butterfly(torch.from_numpy(m), torch.from_numpy(v), variant).numpy()
        assert np.array_equal(got, call(m, v)), dens
        assert np.array_equal(got, probe_butterfly.oracle(m, v)), dens


def test_butterfly_all_matches_the_pallas_probe():
    """butterfly_all on CPU tensors (its twin) gives each formulation's
    output as the JAX probe's kernel does, and the stable compaction, at
    SUB 512 on the probe's four densities."""
    sub = 512
    calls = {name: _pallas_butterfly(name, sub) for name in hopper_probes.BUTTERFLY_VARIANTS}
    for dens, m, v in probe_butterfly.make_cases(np.random.default_rng(1), sub):
        got = hopper_probes.butterfly_all(torch.from_numpy(m), torch.from_numpy(v))
        assert list(got) == list(hopper_probes.BUTTERFLY_VARIANTS)
        for name, out in got.items():
            assert np.array_equal(out.numpy(), calls[name](m, v)), (dens, name)
            assert np.array_equal(out.numpy(), probe_butterfly.oracle(m, v)), (dens, name)


def _rna(x: np.ndarray) -> np.ndarray:
    """numpy TF32 rounding, nearest with ties away from zero."""
    bits = x.view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("mode", hopper_probes.F32DOT_MODES)
def test_f32dot_twin(mode):
    lut, oh, want = probe_f32dot.make_inputs()
    got = hopper_probes.f32dot(torch.from_numpy(lut), torch.from_numpy(oh), mode).numpy()
    if mode == "tf32":
        assert np.array_equal(got, _rna(lut) @ _rna(oh).T)
        err = np.abs(got - want).max()
        assert 0 < err <= 512          # 11 significant bits of values below 2**21
    else:
        assert np.array_equal(got, want)
    if mode == "fp32":
        jax_out = jax.lax.dot_general(jnp.asarray(lut), jnp.asarray(oh), (((1,), (1,)), ((), ())),
                                      preferred_element_type=jnp.float32, precision="highest")
        assert np.array_equal(got.view(np.int32), np.asarray(jax_out).view(np.int32))


@pytest.mark.parametrize("shape", [None, (32, 24, 136), (16, 40, 64)],
                         ids=["probe", "32x24x136", "16x40x64"])
@pytest.mark.parametrize("mode", ["3xtf32", "fp32"])
def test_f32dot_twin_matches_the_pallas_probe(mode, shape):
    """The JAX probe's kernel body (tools/probe_f32dot.py:build) at
    precision HIGHEST in interpret mode: bit-equal to the twins that keep 21
    bits, on the probe's one-hot inputs and on two other shapes."""
    lut, oh, want = probe_f32dot.make_inputs(*shape, seed=57) if shape else \
        probe_f32dot.make_inputs()

    def kernel(lut_ref, oh_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(
            lut_ref[...], oh_ref[...], (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision="highest")

    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(want.shape, jnp.float32),
                          interpret=True)
    jax_out = np.asarray(call(jnp.asarray(lut), jnp.asarray(oh)))
    got = hopper_probes.f32dot(torch.from_numpy(lut), torch.from_numpy(oh), mode).numpy()
    assert np.array_equal(got.view(np.int32), jax_out.view(np.int32))
    assert np.array_equal(got, want)


# the JAX probe's kernel bodies, as tools/probe_mosaic.py:main writes them
def _k_nt(a_ref, b_ref, o_ref):
    o_ref[...] = jax.lax.dot_general(a_ref[...], b_ref[...], (((1,), (1,)), ((), ())),
                                     preferred_element_type=jnp.float32)


def _k_tr(a_ref, o_ref):
    o_ref[...] = a_ref[...].T


def _k_mod(a_ref, o_ref, o2_ref):
    o_ref[...] = a_ref[...] % 258
    o2_ref[...] = a_ref[...] // 258


def _k_merge(a_ref, o_ref):
    o_ref[...] = a_ref[...].reshape(1, 2048)


def _k_stride(a_ref, o_ref):
    o_ref[...] = a_ref[0::2, :]


def _k_roll0(a_ref, s_ref, o_ref):
    o_ref[...] = pltpu.roll(a_ref[...], s_ref[0], axis=0)


def _k_smod(a_ref, o_ref):
    s = jnp.sum(a_ref[...].astype(jnp.int32))
    o_ref[0, 0] = s % 65521


def _k_shift(a_ref, s_ref, o_ref):
    o_ref[...] = (a_ref[...] << (s_ref[...] & 7)) | (a_ref[...] >> (8 - (s_ref[...] & 7)))


PALLAS_MOSAIC = {"a": _k_nt, "b": _k_tr, "c": _k_mod, "d": _k_merge, "e": _k_stride,
                 "f": _k_roll0, "g": _k_smod, "h": _k_shift}


def _pallas_mosaic(probe, inputs):
    """The JAX probe's kernel for ``probe`` on numpy ``inputs``, by
    pl.pallas_call in interpret mode, with the probe's SMEM specs for (f)
    and (g) (tools/probe_mosaic.py:96-99, :116)."""
    outs = [jax.ShapeDtypeStruct(shape, jnp.float32 if dtype == torch.float32 else jnp.int32)
            for shape, dtype in hopper_probes.MOSAIC_PROBES[probe][2]]
    specs = {"f": {"in_specs": [pl.BlockSpec(memory_space=pltpu.VMEM),
                                pl.BlockSpec(memory_space=pltpu.SMEM)]},
             "g": {"out_specs": pl.BlockSpec(memory_space=pltpu.SMEM)}}.get(probe, {})
    call = pl.pallas_call(PALLAS_MOSAIC[probe], out_shape=outs if len(outs) > 1 else outs[0],
                          interpret=True, **specs)
    got = call(*map(jnp.asarray, inputs))
    return [np.asarray(g) for g in (got if isinstance(got, (tuple, list)) else [got])]


def _mosaic_inputs(random: bool) -> dict:
    """The probe's inputs, or seeded random ones: small integers as floats
    for (a), negative values for (c), shifts past either end for (f), sums
    that stay inside int32 for (g) (the JAX body sums in int32, the port in
    int64), any bits for (h)."""
    ins = {k: list(v) for k, (v, _) in probe_mosaic.cases().items()}
    if random:
        rng = np.random.default_rng(58)
        big = np.iinfo(np.int32)
        ins["a"] = [rng.integers(-8, 9, s).astype(np.float32) for s in ((8, 128), (32, 128))]
        ins["b"] = [rng.standard_normal((32, 128)).astype(np.float32)]
        for k in "cde":
            ins[k] = [rng.integers(big.min, big.max, ins[k][0].shape, dtype=np.int32)]
        ins["f"] = [rng.integers(big.min, big.max, (32, 128), dtype=np.int32),
                    np.array([-37], np.int32)]
        ins["g"] = [rng.integers(-2**20, 2**20, (8, 128), dtype=np.int32)]
        ins["h"] = [rng.integers(big.min, big.max, (8, 128), dtype=np.int32) for _ in range(2)]
    return ins


@pytest.mark.parametrize("random", [False, True], ids=["probe_inputs", "random"])
@pytest.mark.parametrize("probe", sorted(hopper_probes.MOSAIC_PROBES))
def test_mosaic_twin_matches_the_pallas_probe(probe, random):
    ins = _mosaic_inputs(random)[probe]
    got = hopper_probes.mosaic_plain(probe, *map(torch.from_numpy, ins))
    want = _pallas_mosaic(probe, ins)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("random", [False, True], ids=["probe_inputs", "random"])
def test_mosaic_all_matches_the_pallas_probe(random):
    """mosaic_all_plain, and mosaic_all on CPU tensors (its twin), give every
    probe's outputs as the JAX probe's kernels do."""
    ins = _mosaic_inputs(random)
    tensors = {k: [torch.from_numpy(x) for x in v] for k, v in ins.items()}
    for got in (hopper_probes.mosaic_all_plain(tensors), hopper_probes.mosaic_all(tensors)):
        assert sorted(got) == sorted(hopper_probes.MOSAIC_PROBES)
        for probe, outs in got.items():
            for g, w in zip(outs, _pallas_mosaic(probe, ins[probe]), strict=True):
                assert np.array_equal(g.numpy(), w)


def test_mosaic_all_rejects_bad_arguments():
    good = {k: [torch.from_numpy(x) for x in v] for k, (v, _) in probe_mosaic.cases().items()}
    with pytest.raises(ValueError, match=r"missing \['c'\]"):
        hopper_probes.mosaic_all({k: v for k, v in good.items() if k != "c"})
    with pytest.raises(ValueError, match=r"unknown \['z'\]"):
        hopper_probes.mosaic_all({**good, "z": good["a"]})
    with pytest.raises(ValueError, match=r"probe \(e\) input 0 must be \(16, 128\)"):
        hopper_probes.mosaic_all({**good, "e": [torch.zeros((8, 128), dtype=torch.int32)]})
    with pytest.raises(TypeError, match="input 1 must be torch.int32"):
        hopper_probes.mosaic_all({**good, "h": [good["h"][0], good["h"][1].float()]})
    with pytest.raises(ValueError, match=r"probe \(f\) takes 2 inputs"):
        hopper_probes.mosaic_all({**good, "f": good["f"][:1]})


@pytest.mark.parametrize("probe", sorted(hopper_probes.MOSAIC_PROBES))
def test_mosaic_twins_match_numpy(probe):
    ins, want = probe_mosaic.cases()[probe]
    got = hopper_probes.mosaic(probe, *(torch.from_numpy(x) for x in ins))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("tool, argv", [
    (probe_phases, ["--size", "128", "--batch", "2"]),
    (probe_decode_phases, ["--size", "128", "--batch", "2"]),
    (probe_butterfly, []), (probe_f32dot, []), (probe_mosaic, []),
])
def test_probe_tools_on_the_cpu(capsys, tool, argv):
    """Each tool runs its twins with --device cpu, measures no time, and
    prints its lines: one per phase, variant, precision or probe."""
    assert tool.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    assert any("not measured" in line for line in out)
    n = {probe_phases: 4, probe_decode_phases: 4, probe_butterfly: 8, probe_f32dot: 3,
         probe_mosaic: 8}[tool]
    assert sum(("equal to its twin" in line) or (": OK" in line) or ("compiled" in line)
               for line in out) == n


def test_probe_wrappers_reject_bad_arguments():
    frames = torch.zeros((1, 8, 8), dtype=torch.uint16)
    thr = torch.zeros((8, 8), dtype=torch.uint16)
    with pytest.raises(ValueError, match="stop_after"):
        hopper_encode.encode_l1_phases(frames, thr, 64, True, "cumsum")
    with pytest.raises(ValueError, match="stop_after"):
        hopper_decode.decode_l1_phases(torch.zeros((1, 8), dtype=torch.uint8),
                                       torch.zeros((1, 4), dtype=torch.int32), 8, 8, "bitmap")
    rows = torch.zeros((2, 48), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        hopper_probes.butterfly(rows, rows, "packed_or")
    with pytest.raises(ValueError, match="variant"):
        hopper_probes.butterfly(rows[:, :32].contiguous(), rows[:, :32].contiguous(), "packed")
    with pytest.raises(ValueError, match="power of two"):
        hopper_probes.butterfly_all(rows, rows)
    with pytest.raises(ValueError, match="differ"):
        hopper_probes.butterfly_all(torch.zeros((2, 64), dtype=torch.int32),
                                    torch.zeros((2, 32), dtype=torch.int32))
    with pytest.raises(TypeError, match="vals must be torch.int32"):
        hopper_probes.butterfly_all(torch.zeros((2, 32), dtype=torch.int32),
                                    torch.zeros((2, 32), dtype=torch.int64))
    with pytest.raises(ValueError, match="at least one row"):
        hopper_probes.butterfly_all(torch.zeros((0, 32), dtype=torch.int32),
                                    torch.zeros((0, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="mma"):
        hopper_probes.f32dot(torch.zeros((20, 8)), torch.zeros((8, 8)), "tf32")
    with pytest.raises(ValueError, match="input 0"):
        hopper_probes.mosaic("a", torch.zeros((8, 64)), torch.zeros((32, 128)))
