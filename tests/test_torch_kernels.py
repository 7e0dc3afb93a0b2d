"""PyTorch port: the plain versions of the eight ported kernels (and the
int8-cache branch of flash decode) against the JAX Pallas kernels run in
interpret mode (as the JAX package's own tests
run them on the CPU), and the gradients of the two autograd Functions of
the training path against ``jax.vjp`` of their JAX counterparts. The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.

Tolerances: the pair-delta plain version repeats the TPU kernel's
integer arithmetic exactly, so it differs only in how fp32 rounds the
epilogue ``2*a1*S + (a2*colsum - a1*sxq)``, whose terms (up to
``alpha * (xmax - xmin) * K``) cancel: 4 ulp of that magnitude. On-grid
inputs are exact to 1e-5 as in tests/test_pallas_kernels.py. The float
kernels agree to 2e-5 (fp32 sums taken in other orders), relative to
the largest value where magnitudes grow with K. bf16 outputs and
gradients agree to one bf16 ulp of the largest value (2^-7 of it): both
sides sum in fp32 and round once."""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.core.delta import BinaryDelta as JBinaryDelta
from bitdelta_tpu.core.delta import pair_delta as jpair_delta
from bitdelta_tpu.ops import flash_decode as jfd
from bitdelta_tpu.ops import flash_prefill as jfp
from bitdelta_tpu.ops import pallas_binary_gemm as jpb
from bitdelta_tpu.ops import kv_quant as jkv
from bitdelta_tpu.ops.packing import pack_signs as jpack
from bitdelta_tpu.ops.pallas_int4 import w4_matmul_pallas
from bitdelta_tpu.research.quantized_base import quantize_int4
from bitdelta_torch.convert import tensor_from_numpy
from bitdelta_torch.ops import binary_gemm as tbg
from bitdelta_torch.ops.binary_matmul import _MatmulF32
from bitdelta_torch.ops import flash_decode as tfd
from bitdelta_torch.ops import flash_prefill as tfp
from bitdelta_torch.ops import int4 as ti

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


@pytest.mark.parametrize("b,s,h,kv,hd,window", [(3, 64, 4, 2, 16, None),
                                                 (2, 128, 8, 2, 32, 48)])
def test_flash_decode_int8_plain_matches_pallas(b, s, h, kv, hd, window):
    # The int8 cache: JAX's kernel folds the scales into scores and
    # probabilities; the plain version dequantizes first. fp32 sums in
    # another order (2e-5, as tests/test_flash_decode.py holds JAX's own
    # kernel against attention over the dequantized cache).
    rng = np.random.default_rng(15)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k8, ks = jkv.quantize_kv(jnp.asarray(rng.standard_normal((b, s, kv, hd)),
                                         jnp.float32))
    v8, vs = jkv.quantize_kv(jnp.asarray(rng.standard_normal((b, s, kv, hd)),
                                         jnp.float32))
    lengths = rng.integers(1, s + 1, (b,)).astype(np.int32)
    want = np.array(jfd.flash_decode_attention(
        jnp.asarray(q), k8, v8, jnp.asarray(lengths), k_scale=ks, v_scale=vs,
        window=window, interpret=True))
    got = tfd.flash_decode_attention(
        _t(q), _t(k8), _t(v8), _t(lengths), k_scale=_t(ks), v_scale=_t(vs),
        window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL)


@pytest.mark.parametrize("m,k,n", [(8, 256, 256), (1, 128, 128),
                                   (6, 512, 384), (8, 384, 128),
                                   (4, 2048, 256)])
def test_w4_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(2)
    w = quantize_int4(jnp.asarray(rng.standard_normal((k, n)) * 0.05,
                                  jnp.float32))
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = np.array(w4_matmul_pallas(jnp.asarray(x), w.packed, w.scale,
                                     interpret=True, out_dtype=jnp.float32))
    got = ti.w4_matmul(_t(x), _t(w.packed), _t(w.scale)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_w4_matmul_bf16_x_plain_matches_pallas():
    # bf16 x: both sides unpack the nibbles to bf16 and sum in fp32.
    rng = np.random.default_rng(3)
    w = quantize_int4(jnp.asarray(rng.standard_normal((512, 256)) * 0.05,
                                  jnp.float32))
    jx, tx = _bf16_or_f32(rng.standard_normal((8, 512)), jnp.bfloat16)
    want = np.array(w4_matmul_pallas(jx, w.packed, w.scale, interpret=True,
                                     out_dtype=jnp.float32))
    got = ti.w4_matmul(tx, _t(w.packed), _t(w.scale),
                       out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        # 64-row groups: the kernel's wrapper takes 128-row groups only.
        ti.w4_matmul(tx, _t(w.packed), _t(np.repeat(np.array(w.scale), 2, 0)))


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


@pytest.mark.parametrize("case", ["fp32", "bf16", "repeated_ids",
                                  "multi_block_k", "zero_x"])
def test_tenant_delta_plain_matches_pallas(case):
    # Row 7: the port's plain version sums the integer bit-plane products
    # over the whole K in int64; JAX sums per K block in fp32, so the two
    # agree to fp32 rounding: 1e-5 of the output's largest |value|.
    # "multi_block_k": K = 3072 is cut into three 1024-row blocks by the
    # TPU kernel (nk = 3). "zero_x": the 1e-30 clamp of xmax.
    rng = np.random.default_rng(11)
    bsz, g, k, n = {"multi_block_k": (3, 2, 3072, 128)}.get(
        case, (6, 4, 256, 128))
    packed = np.array(jpack(jnp.asarray(
        rng.integers(0, 2, (g, k, n)).astype(bool))))
    scales = rng.uniform(0.1, 2.0, (g,)).astype(np.float32)
    ids = (np.asarray([3, 3, 3, 1, 3, 3], np.int32) if case == "repeated_ids"
           else rng.integers(0, g, (bsz,)).astype(np.int32))
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    if case == "zero_x":
        x[:] = 0.0
    dtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    jx, tx = _bf16_or_f32(x, dtype)
    want = np.array(jpb.tenant_delta_matmul_pallas(
        jx, jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(ids),
        interpret=True, out_dtype=jnp.float32))
    got = tbg.tenant_delta_matmul(tx, _t(packed), _t(scales), _t(ids),
                                  out_dtype=torch.float32).numpy()
    if case == "zero_x":
        assert not got.any() and not want.any()
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_tenant_delta_grid_is_global_not_per_row():
    # One xscale for the whole (B, K) input: a row of small values keeps
    # the coarse grid of the largest row (per-row scales would be exact
    # here), and the result is that grid's, not x @ sign exactly.
    x = np.zeros((2, 32), np.float32)
    x[0, 0] = 1.0
    x[1, :2] = [3e-5, 1e-5]          # below half a step of 2^-14: rounds off
    packed = np.array(jpack(jnp.ones((1, 32, 4), bool)))
    got = tbg.tenant_delta_matmul(_t(x), _t(packed), torch.ones(1),
                                  torch.zeros(2, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy()[0], np.ones(4, np.float32))
    np.testing.assert_array_equal(got.numpy()[1], np.zeros(4, np.float32))


# Row 7's card-side x prep (what the kernel reads): int16 xq and an int64
# sum. At K = 131072 with every |x| at the input's max, each xq is +-2^14
# and a row's sum +-2^31, one past int32 for the positive row.
@pytest.mark.parametrize("pattern", ["all_max", "alternating", "random"])
def test_canonical_kernel_input_sums_in_int64(pattern):
    k = 131072
    x = torch.full((3, k), 0.75, dtype=torch.bfloat16)
    x[1] = -0.75
    if pattern == "alternating":
        x[2, ::2] = -0.75
    elif pattern == "random":
        g = torch.Generator().manual_seed(5)
        x[2] = torch.randn((k,), generator=g).clamp(-0.75, 0.75)
    xq16, sxq, xscale = tbg._canonical_kernel_input(x)
    xq, xscale_plain = tbg._canonical_quantize(x)
    assert xq16.dtype == torch.int16 and sxq.dtype == torch.int64
    assert torch.equal(xq16.to(torch.int32), xq)
    assert torch.equal(xscale, xscale_plain)
    assert sxq[:2].tolist() == [2 ** 31, -2 ** 31]
    assert torch.equal(sxq, xq.to(torch.int64).sum(dim=1))
    assert torch.equal(sxq, torch.from_numpy(
        xq.numpy().astype(np.int64).sum(axis=1)))


def test_cpu_tensors_take_the_plain_versions():
    # On CPU tensors the wrappers run the plain versions and launch
    # nothing: the counters stay where they were.
    before = [tbg.tenant_delta_matmul_pair.launches,
              tbg.tenant_delta_matmul.launches,
              tbg.tenant_dense_matmul.launches, tbg.binary_matmul.launches,
              tfd.flash_decode_attention.launches,
              tfp.flash_prefill_attention.launches, ti.w4_matmul.launches]
    test_tenant_dense_plain_matches_pallas()
    test_tenant_delta_grid_is_global_not_per_row()
    test_binary_matmul_plain_matches_pallas(8, 64, 128)
    test_w4_matmul_plain_matches_pallas(8, 256, 256)
    test_flash_decode_int8_plain_matches_pallas(3, 64, 4, 2, 16, None)
    after = [tbg.tenant_delta_matmul_pair.launches,
             tbg.tenant_delta_matmul.launches,
             tbg.tenant_dense_matmul.launches, tbg.binary_matmul.launches,
             tfd.flash_decode_attention.launches,
             tfp.flash_prefill_attention.launches, ti.w4_matmul.launches]
    assert after == before


@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (16, 512, 256), (24, 96, 40)])
def test_binary_matmul_t_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(10)
    g = rng.standard_normal((m, n)).astype(np.float32)
    packed = np.array(jpack(jnp.asarray(
        rng.integers(0, 2, (k, n)).astype(bool))))
    want = np.array(jpb.binary_matmul_t_pallas(
        jnp.asarray(g), jnp.asarray(packed), 0.7, interpret=True))
    got = tbg.binary_matmul_t(_t(g), _t(packed), torch.tensor(0.7)).numpy()
    assert got.shape == (m, k)
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL,
                               atol=FLOAT_TOL * np.abs(want).max())


def test_split_bf16x3_is_exact():
    # Rows 5 and 6 take fp32 input as three bf16 pieces; their fp32 sum
    # must give back x bit for bit, over 60 decades and for signed zeros.
    rng = np.random.default_rng(12)
    mant = rng.uniform(1.0, 10.0, 4096)
    expo = rng.integers(-30, 31, 4096).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], 4096)
    x = (sign * mant * 10.0 ** expo).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, 1e-30, -1e30, 1.0, -1.0])])
    hi, mid, lo = tbg._split_bf16x3(_t(x)).float()
    got = (hi + mid + lo).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), x.view(np.uint32))


def _three_piece(a, packed, scale, trans):
    """What the card's rows 5 and 6 compute for fp32 input, in plain
    torch: the three bf16 pieces' products with the ±1 matrix, summed in
    fp32, scaled once."""
    from bitdelta_torch.ops.packing import unpack_to_pm1

    pieces = tbg._split_bf16x3(_t(a)).float()
    signs = unpack_to_pm1(_t(packed), torch.float32)
    b = signs.T if trans else signs
    return (pieces[0] @ b + pieces[1] @ b + pieces[2] @ b) * scale


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("m,k,n", [(8, 64, 128), (16, 512, 256),
                                   (13, 96, 40)])
def test_three_piece_products_match_pallas(trans, m, k, n):
    # Within 1e-6 of the output scale: the split is exact, so only the
    # order of the fp32 sums differs from the TPU kernels' fp32 dot.
    rng = np.random.default_rng(13)
    a = rng.standard_normal((m, n if trans else k)).astype(np.float32)
    packed = np.array(jpack(jnp.asarray(
        rng.integers(0, 2, (k, n)).astype(bool))))
    kern = jpb.binary_matmul_t_pallas if trans else jpb.binary_matmul_pallas
    want = np.array(kern(jnp.asarray(a), jnp.asarray(packed), 0.7,
                         interpret=True))
    got = _three_piece(a, packed, 0.7, trans).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _tol(want, dtype):
    rel = FLOAT_TOL if dtype == jnp.float32 else 2.0 ** -7
    return rel * float(np.abs(np.asarray(want, np.float32)).max())


def _bf16_or_f32(a, dtype):
    """The same values for both packages: a JAX array of ``dtype`` and
    its torch twin (bf16 bit-exact)."""
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_binary_matmul_trainable_vjp_matches_jax(dtype):
    rng = np.random.default_rng(11)
    m, k, n = 32, 256, 64
    packed = np.array(jpack(jnp.asarray(
        rng.integers(0, 2, (k, n)).astype(bool))))
    jx, tx = _bf16_or_f32(rng.standard_normal((m, k)), dtype)
    jg, tg = _bf16_or_f32(rng.standard_normal((m, n)), dtype)
    y_want, vjp = jax.vjp(
        lambda x, s: jpb.binary_matmul_trainable(x, jnp.asarray(packed), s,
                                                 True),
        jx, jnp.float32(0.7))
    dx_want, ds_want = vjp(jg)
    tx.requires_grad_()
    ts = torch.tensor(0.7, requires_grad=True)
    y = tbg.binary_matmul_trainable(tx, _t(packed), ts)
    assert y.dtype == tx.dtype
    y.backward(tg)
    assert tx.grad.dtype == tx.dtype and ts.grad.shape == ()
    for got, want in ((y, y_want), (tx.grad, dx_want)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0, atol=_tol(want, dtype))
    np.testing.assert_allclose(float(ts.grad), float(ds_want), rtol=1e-5)


@pytest.mark.parametrize("window,g,sq", [(None, 1, 48), (24, 4, 48),
                                         (9, 2, 40)])
def test_flash_prefill_vjp_matches_jax(window, g, sq):
    rng = np.random.default_rng(12)
    b, sk, kvh, hd = 3, 64, 2, 16
    h = kvh * g
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    gout = rng.standard_normal((b, sq, h * hd)).astype(np.float32)
    lengths = np.asarray([sq, 29, 5], np.int32)      # padded query rows
    out_want, vjp = jax.vjp(
        lambda q, k, v: jfp.flash_prefill_attention(
            q, k, v, jnp.asarray(lengths), window=window, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(gout))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tfp.flash_prefill_attention(tq, tk, tv, _t(lengths), window=window)
    out.backward(_t(gout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_want),
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)
    for row, n in enumerate(lengths):
        # Padding queries and keys past a row's length: exact zeros.
        for grad in (tq.grad, tk.grad, tv.grad):
            assert not grad[row, n:].any()


def test_autograd_functions_only_when_a_gradient_is_taken():
    # Serving calls (no gradient to take) run the forward alone; a call
    # with a gradient to take goes through the Function. CPU tensors
    # launch nothing either way.
    rng = np.random.default_rng(13)
    q = _t(rng.standard_normal((1, 16, 4, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    lengths = torch.tensor([16])
    x = _t(rng.standard_normal((16, 64)).astype(np.float32))
    packed = torch.zeros((2, 8), dtype=torch.int32)
    scale = torch.tensor(0.5)
    before = (tfp.flash_prefill_attention.launches, tbg.binary_matmul.launches,
              tbg.binary_matmul_t.launches)
    with torch.no_grad():
        assert tfp.flash_prefill_attention(q, k, k, lengths).grad_fn is None
        assert tbg.binary_matmul_trainable(
            x, packed, scale.requires_grad_()).grad_fn is None
    out = tfp.flash_prefill_attention(q.requires_grad_(), k, k, lengths)
    assert type(out.grad_fn).__name__ == "_FlashPrefillBackward"
    y = tbg.binary_matmul_trainable(x, packed, scale)
    assert type(y.grad_fn).__name__ == "_BinaryMatmulTrainableBackward"
    (out.sum() + y.sum()).backward()
    assert q.grad is not None and scale.grad is not None
    assert before == (tfp.flash_prefill_attention.launches,
                      tbg.binary_matmul.launches,
                      tbg.binary_matmul_t.launches)


@pytest.mark.parametrize("a_shape,b_shape", [((2, 5, 16), (16, 8)),
                                             ((3, 5, 16), (3, 16, 8))])
def test_matmul_f32_function_gradients(a_shape, b_shape):
    # The Function that gives the card's bf16 matmul with an fp32 output a
    # gradient, run here on CPU bf16 tensors: its backward equals autograd
    # of the widened product (bf16 to fp32 is exact; one cast at the end).
    rng = np.random.default_rng(14)
    a = _t(rng.standard_normal(a_shape).astype(np.float32)).to(torch.bfloat16)
    b = _t(rng.standard_normal(b_shape).astype(np.float32)).to(torch.bfloat16)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    y1 = _MatmulF32.apply(a1, b1)
    y2 = torch.matmul(a2.float(), b2.float())
    g = torch.randn(y1.shape, generator=torch.Generator().manual_seed(0))
    y1.backward(g)
    y2.backward(g)
    assert y1.dtype == torch.float32 and torch.equal(y1, y2)
    assert a1.grad.dtype == b1.grad.dtype == torch.bfloat16
    assert torch.equal(a1.grad, a2.grad) and torch.equal(b1.grad, b2.grad)
