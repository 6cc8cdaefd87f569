"""The port's bit packing (pyrecode_tpu_torch.ops.bitpack, hopper_bitpack)
against the JAX package's, byte for byte.

On the CPU the 12-bit wrappers run their plain twins; tests/test_torch_kernels.py
compares the kernels with the twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrecode_tpu import oracle
from pyrecode_tpu.ops import bitpack as jbitpack
from pyrecode_tpu.ops.pallas_bitpack import VALS_STEP, bitpack12_pallas, bitunpack12_pallas
from pyrecode_tpu_torch import kernel_launch_counts
from pyrecode_tpu_torch.ops import bitpack, hopper_bitpack


@pytest.mark.parametrize("bit_depth", range(1, 17))
def test_values_match_jax(bit_depth):
    rng = np.random.default_rng(bit_depth)
    g_vals, g_bytes = bitpack.packed_group_shape(bit_depth)
    assert (g_vals, g_bytes) == jbitpack.packed_group_shape(bit_depth)
    assert bitpack.packed_size_bytes(1001, bit_depth) == jbitpack.packed_size_bytes(1001, bit_depth)
    v = rng.integers(0, 1 << bit_depth, (2, g_vals * 37)).astype(np.int32)
    got = bitpack.bitpack_values(torch.from_numpy(v), bit_depth).numpy()
    want = np.asarray(jbitpack.bitpack_values(v.astype(np.uint32), bit_depth))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert oracle.bit_pack(v[0], bit_depth).tobytes() == got[0].tobytes()
    back = bitpack.bitunpack_values(torch.from_numpy(got), bit_depth).numpy()
    jback = np.asarray(jbitpack.bitunpack_values(want, bit_depth))
    assert np.array_equal(back, jback) and np.array_equal(back, v)


def test_values_above_depth_spill_as_in_jax():
    """Out-of-range values give the JAX version's bytes, not an error."""
    v = np.array([[4096, 70000, 0xFFFFFFF, 5]], dtype=np.int64)
    got = bitpack.bitpack_values(torch.from_numpy(v), 12).numpy()
    want = np.asarray(jbitpack.bitpack_values(v.astype(np.uint32), 12))
    assert np.array_equal(got, want)


def test_pack_bits_matches_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, 8 * 41)).astype(np.uint8)
    got = bitpack.pack_bits(torch.from_numpy(bits)).numpy()
    assert np.array_equal(got, np.asarray(jbitpack.pack_bits(bits)))
    assert np.array_equal(bitpack.unpack_bits(torch.from_numpy(got)).numpy(), bits)
    with pytest.raises(ValueError):
        bitpack.pack_bits(torch.zeros(7, dtype=torch.uint8))


def test_bitpack12_twin_matches_pallas():
    """The 12-bit twins against the Pallas kernels (interpret mode) at one
    row of the kernels' step size."""
    rng = np.random.default_rng(5)
    v = rng.integers(0, 4096, (1, VALS_STEP)).astype(np.int32)
    packed = hopper_bitpack.bitpack12(torch.from_numpy(v)).numpy()
    assert np.array_equal(packed, np.asarray(bitpack12_pallas(jnp.asarray(v), interpret=True)))
    values = hopper_bitpack.bitunpack12(torch.from_numpy(packed)).numpy()
    want = np.asarray(bitunpack12_pallas(jnp.asarray(packed), interpret=True))
    assert values.dtype == np.int32 and np.array_equal(values, want)
    assert np.array_equal(values, v)


def test_bitpack12_takes_any_even_length_on_host():
    before = kernel_launch_counts()
    v = torch.arange(10, dtype=torch.int32).reshape(1, 10)
    assert hopper_bitpack.bitpack12(v).shape == (1, 15)
    assert torch.equal(hopper_bitpack.bitunpack12(hopper_bitpack.bitpack12(v)), v)
    assert kernel_launch_counts() == before  # the host path launches nothing
    with pytest.raises(ValueError):
        hopper_bitpack.bitpack12(torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        hopper_bitpack.bitunpack12(torch.zeros((1, 4), dtype=torch.uint8))
    with pytest.raises(TypeError):
        hopper_bitpack.bitpack12(torch.zeros((1, 4), dtype=torch.int64))


def test_device_dispatch_uses_plain_path_for_other_depths():
    rng = np.random.default_rng(9)
    v = rng.integers(0, 1 << 10, (2, 64)).astype(np.int32)
    got = bitpack.bitpack_values_device(torch.from_numpy(v), 10)
    assert np.array_equal(got.numpy(), np.asarray(jbitpack.bitpack_values(v.astype(np.uint32), 10)))
    back = bitpack.bitunpack_values_device(got, 10)
    assert back.dtype == torch.int32 and np.array_equal(back.numpy(), v)
