"""PyTorch port: the plain versions of the five serving-path kernels
against the JAX Pallas kernels run in interpret mode (as the JAX
package's own tests run them on the CPU). The CUDA kernels themselves
are held against these plain versions on the card by
tests/test_torch_cuda.py.

Tolerances: the pair-delta plain version repeats the TPU kernel's
integer arithmetic exactly, so it differs only in how fp32 rounds the
epilogue ``2*a1*S + (a2*colsum - a1*sxq)``, whose terms (up to
``alpha * (xmax - xmin) * K``) cancel: 4 ulp of that magnitude. On-grid
inputs are exact to 1e-5 as in tests/test_pallas_kernels.py. The float
kernels agree to 2e-5 (fp32 sums taken in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.core.delta import BinaryDelta as JBinaryDelta
from bitdelta_tpu.core.delta import pair_delta as jpair_delta
from bitdelta_tpu.ops import flash_decode as jfd
from bitdelta_tpu.ops import flash_prefill as jfp
from bitdelta_tpu.ops import pallas_binary_gemm as jpb
from bitdelta_tpu.ops.packing import pack_signs as jpack
from bitdelta_torch.ops import binary_gemm as tbg
from bitdelta_torch.ops import flash_decode as tfd
from bitdelta_torch.ops import flash_prefill as tfp

FLOAT_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _epilogue_ulps(x, scales, k, ulps=4):
    term = float(np.max(scales)) * float(np.ptp(x, axis=1).max()) * k
    return ulps * float(np.spacing(np.float32(term)))


def _pair_world(seed, bsz, t, k, n):
    rng = np.random.default_rng(seed)
    signs = rng.integers(0, 2, (t, k, n)).astype(bool)
    packed = jpack(jnp.asarray(signs))
    scales = rng.uniform(0.1, 2.0, (t,)).astype(np.float32)
    ids = rng.integers(0, t, (bsz,)).astype(np.int32)
    pd = jpair_delta(JBinaryDelta(packed=packed, scale=jnp.asarray(scales)))
    return rng, signs, scales, ids, pd


@pytest.mark.parametrize("bsz,t,k,n", [(4, 3, 64, 256), (6, 6, 1024, 512),
                                       (3, 2, 128, 256)])
def test_pair_delta_plain_matches_pallas(bsz, t, k, n):
    rng, _, scales, ids, pd = _pair_world(21, bsz, t, k, n)
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    want = np.array(jpb.tenant_delta_matmul_pair_pallas(
        jnp.asarray(x), pd.packed_pairs, pd.colsum, jnp.asarray(scales),
        jnp.asarray(ids), interpret=True))
    got = tbg.tenant_delta_matmul_pair(
        _t(x), _t(pd.packed_pairs), _t(pd.colsum), _t(scales), _t(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_epilogue_ulps(x, scales, k))


def test_pair_delta_plain_exact_on_grid():
    # x on the 12-bit affine grid: the integer formulation is exact.
    rng, signs, _, _, _ = _pair_world(22, 4, 2, 256, 256)
    bsz, k = 4, 256
    xq = rng.integers(0, tbg.PAIR_Q_LEVELS + 1, (bsz, k)).astype(np.float64)
    xq[:, 0], xq[:, 1] = 0, tbg.PAIR_Q_LEVELS
    x = (xq * 0.003 - 1.7).astype(np.float32)
    scales = np.asarray([0.7, 1.3], np.float32)
    ids = np.asarray([0, 1, 1, 0], np.int32)
    pd = jpair_delta(JBinaryDelta(packed=jpack(jnp.asarray(signs)),
                                  scale=jnp.asarray(scales)))
    got = tbg.tenant_delta_matmul_pair(
        _t(x), _t(pd.packed_pairs), _t(pd.colsum), _t(scales),
        _t(ids)).numpy()
    pm1 = np.where(signs, 1.0, -1.0)
    want = np.stack([float(scales[i]) * (x[b].astype(np.float64) @ pm1[i])
                     for b, i in enumerate(ids)])
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("b,s,h,kv,hd,window",
                         [(3, 64, 8, 2, 16, None), (4, 96, 4, 4, 32, 20),
                          (2, 128, 8, 1, 16, 7)])
def test_flash_decode_plain_matches_pallas(b, s, h, kv, hd, window):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    lengths = rng.integers(1, s + 1, (b,)).astype(np.int32)
    lengths[0] = s
    want = np.array(jfd.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        window=window, block_s=16, interpret=True))
    got = tfd.flash_decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                                     window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_tenant_dense_plain_matches_pallas():
    rng = np.random.default_rng(6)
    bsz, t, k, n = 5, 3, 128, 256
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    w = rng.standard_normal((t, k, n)).astype(np.float32)
    ids = np.asarray([2, 0, 2, 1, 0], np.int32)
    want = np.array(jpb.tenant_dense_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids), interpret=True))
    got = tbg.tenant_dense_matmul(_t(x), _t(w), _t(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)


@pytest.mark.parametrize("window,g", [(None, 1), (24, 4), (9, 2)])
def test_flash_prefill_plain_matches_pallas(window, g):
    rng = np.random.default_rng(7)
    b, sq, sk, kvh, hd = 3, 48, 64, 2, 16
    h = kvh * g
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    lengths = np.asarray([48, 29, 5], np.int32)      # padded query rows
    want = np.array(jfp.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        window=window, block_q=16, block_k=16, interpret=True))
    got = tfp.flash_prefill_attention(_t(q), _t(k), _t(v), _t(lengths),
                                      window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    for row, n in enumerate(lengths):
        assert not got[row, n:].any(), "padding query rows must be zeros"


@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (16, 512, 256)])
def test_binary_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed = np.array(jpack(jnp.asarray(
        rng.integers(0, 2, (k, n)).astype(bool))))
    want = np.array(jpb.binary_matmul_pallas(
        jnp.asarray(x), jnp.asarray(packed), 0.7, interpret=True))
    got = tbg.binary_matmul(_t(x), _t(packed),
                            torch.tensor(0.7)).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_cpu_tensors_take_the_plain_versions():
    # On CPU tensors the wrappers run the plain versions and launch
    # nothing: the counters stay where they were.
    before = [tbg.tenant_delta_matmul_pair.launches,
              tbg.tenant_dense_matmul.launches, tbg.binary_matmul.launches,
              tfd.flash_decode_attention.launches,
              tfp.flash_prefill_attention.launches]
    test_tenant_dense_plain_matches_pallas()
    test_binary_matmul_plain_matches_pallas(8, 64, 128)
    after = [tbg.tenant_delta_matmul_pair.launches,
             tbg.tenant_dense_matmul.launches, tbg.binary_matmul.launches,
             tfd.flash_decode_attention.launches,
             tfp.flash_prefill_attention.launches]
    assert after == before
