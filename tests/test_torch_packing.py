"""PyTorch port: bit packing is bit-exact against the JAX package.

Inputs come from numpy seeds and go to both packages; every comparison
is exact (integer words, including words whose bit 31 is set)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.ops import packing as jp
from bitdelta_torch.ops import packing as tp


def _signs(seed, shape):
    signs = np.random.default_rng(seed).integers(0, 2, shape).astype(bool)
    # Every 32nd row (bit 31 of a word) set somewhere, and one all-ones
    # word column, so the arithmetic-shift pitfall would show.
    signs[..., 31::32, 0] = True
    signs[..., :32, 1] = True
    return signs


@pytest.mark.parametrize("shape", [(64, 256), (3, 128, 512), (2, 2, 32, 256)])
def test_pack_unpack_bit_exact(shape):
    signs = _signs(0, shape)
    want = np.array(jp.pack_signs(jnp.asarray(signs)))
    got = tp.pack_signs(torch.from_numpy(signs)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any(), "test must cover words with bit 31 set"
    back = tp.unpack_signs(torch.from_numpy(want)).numpy()
    np.testing.assert_array_equal(back, signs)
    pm1 = tp.unpack_to_pm1(torch.from_numpy(want), torch.float32).numpy()
    np.testing.assert_array_equal(
        pm1, np.array(jp.unpack_to_pm1(jnp.asarray(want), jnp.float32)))


@pytest.mark.parametrize("shape", [(64, 256), (2, 96, 512), (2, 3, 32, 768)])
def test_pair_layout_bit_exact(shape):
    packed = np.array(jp.pack_signs(jnp.asarray(_signs(1, shape))))
    want = np.array(jp.repack_pairs(jnp.asarray(packed)))
    got = tp.repack_pairs(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tp.unpair_packed(torch.from_numpy(want)).numpy(), packed)
    np.testing.assert_array_equal(
        tp.column_popcount(torch.from_numpy(packed)).numpy(),
        np.array(jp.column_popcount(jnp.asarray(packed))))


def test_repack_rejects_ragged_n():
    with pytest.raises(ValueError):
        tp.repack_pairs(torch.zeros((2, 128), dtype=torch.int32))
