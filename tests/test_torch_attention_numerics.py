"""Numerics of the tensor-core flash prefill kernel (row 4,
``bitdelta_torch/csrc/flash_prefill.cu::flash_prefill_tc_kernel``) on the
CPU, before the card: the one change it makes against an fp32 product is
to round P to bf16 for the P·V product.

A plain-torch model of the kernel's arithmetic takes the kernel's order:
bf16 q, k and v; fp32 scores; per query tile of 64 rows a walk over
64-key tiles from ``max(q0 + 1 - window, 0)``; the online softmax with
its running-max rescale; P rounded once per tile to bf16 after that
rescale, its row sums kept in fp32; the output divided by the sum and
rounded to bf16. The JAX kernel, run in interpret mode on the same
(bf16-representable) values in fp32, is the reference. Tolerance: each
(row, head) within 2^-7 of its own largest |value|, as the card holds
the kernel against the plain version; rounding P costs about 2^-9 of a
row's output scale and the bf16 output another 2^-9.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.ops import flash_prefill as jfp
from bitdelta_torch.ops import flash_prefill as tfp

TILE = 64


def _tiled_bf16_p(q, k, v, lengths, window):
    """The tensor-core kernel's arithmetic in plain torch (see the module
    docstring). q ``(B, Sq, H, hd)``, k/v ``(B, Sk, KV, hd)``, fp32
    holding bf16 values; returns ``(B, Sq, H*hd)`` bf16."""
    bsz, sq, nh, hd = q.shape
    n_kv = k.shape[2]
    g = nh // n_kv
    out = torch.zeros((bsz, sq, nh, hd), dtype=torch.float32)
    for b in range(bsz):
        length = int(lengths[b])
        for q0 in range(0, sq, TILE):
            if q0 >= length:
                continue                           # dead tile: zeros
            rows = torch.arange(q0, min(q0 + TILE, sq))
            hi = min(q0 + TILE, length)
            lo = max(q0 + 1 - window, 0) if window else 0
            for h in range(nh):
                qh = q[b, rows, h]                   # (R, hd)
                m = torch.full((len(rows), 1), -1e30)
                l = torch.zeros((len(rows), 1))
                acc = torch.zeros((len(rows), hd))
                for t0 in range(lo, hi, TILE):
                    keys = torch.arange(t0, min(t0 + TILE, hi))
                    kh = k[b, keys, h // g]
                    vh = v[b, keys, h // g]
                    s = (qh @ kh.T) / math.sqrt(hd)
                    vis = ((keys[None] <= rows[:, None])
                           & (rows[:, None] < length))
                    if window:
                        vis &= keys[None] > rows[:, None] - window
                    s = torch.where(vis, s, torch.full_like(s, -1e30))
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(vis, torch.exp(s - m_new),
                                    torch.zeros_like(s))
                    l = l * alpha + p.sum(-1, keepdim=True)
                    p16 = p.to(torch.bfloat16).to(torch.float32)
                    acc = acc * alpha + p16 @ vh
                    m = m_new
                out[b, rows, h] = torch.where(
                    l > 0, acc / torch.where(l > 0, l, 1.0),
                    torch.zeros_like(acc))
    return out.reshape(bsz, sq, nh * hd).to(torch.bfloat16)


def _rowwise_off(got, want, hd):
    """(row, head) pairs further than 2^-7 of their own max |want|."""
    diff = (got.float() - want.float()).reshape(-1, hd).abs().amax(-1)
    tol = 2 ** -7 * want.float().reshape(-1, hd).abs().amax(-1)
    return int((diff > tol).sum())


@pytest.mark.parametrize("window", [None, 100])
def test_prefill_bf16_p_stays_within_a_bf16_ulp_of_jax(window):
    rng = np.random.default_rng(21)
    bsz, s, nh, kvh, hd = 2, 192, 8, 2, 128

    def bf16_values(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).to(torch.float32)

    q = bf16_values((bsz, s, nh, hd))
    k = bf16_values((bsz, s, kvh, hd))
    v = bf16_values((bsz, s, kvh, hd))
    lengths = np.asarray([192, 150], np.int32)
    want = torch.from_numpy(np.array(jfp.flash_prefill_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(lengths), window=window,
        interpret=True)))
    got = _tiled_bf16_p(q, k, v, lengths, window)
    assert _rowwise_off(got, want, hd) == 0
    assert not got[1, 150:].any(), "padding query rows must be zeros"
    # The port's plain version (fp32 P) is the card's reference for the
    # kernel; it agrees with JAX to fp32 rounding.
    plain = tfp.flash_prefill_attention_plain(q, k, v,
                                              torch.from_numpy(lengths),
                                              window=window)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    # The model differs from the plain version by more than fp32 rounding:
    # the bf16 P is what is being held.
    assert (got.float() - plain).abs().max().item() > 1e-4
