"""Flash-prefill attention (port of
``bitdelta_tpu/ops/flash_prefill.py::flash_prefill_attention``).

:func:`flash_prefill_attention` launches ``csrc/flash_prefill.cu`` on a
CUDA tensor and takes :func:`flash_prefill_attention_plain` on a CPU
tensor; launches are counted in ``flash_prefill_attention.launches``.
bf16 input runs ``flash_prefill_tc_kernel`` on the tensor cores (P
rounded to bf16 for the P·V product), fp32 input the CUDA-core
``flash_prefill_fp32_kernel``: a choice by dtype, made before the launch.
When a gradient is to be taken, the call goes through an autograd
Function whose backward is the JAX package's blockwise recompute
(``_blockwise_backward``), in plain torch as JAX runs it in XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._build import F, I, P

_NEG_INF = -1e30
_LIB = "flash_prefill"


def prefill_mask(sq: int, sk: int, lengths: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """``(B, Sq, Sk)`` visibility for fresh sequences (queries at
    positions 0..Sq-1): causal, both positions live, inside the window."""
    qpos = torch.arange(sq, device=lengths.device)[None, :, None]
    kpos = torch.arange(sk, device=lengths.device)[None, None, :]
    length = lengths.to(torch.int64)[:, None, None]
    valid = (kpos <= qpos) & (kpos < length) & (qpos < length)
    if window is not None:
        valid &= kpos > qpos - window
    return valid


def flash_prefill_attention_plain(q, k, v, lengths, *, window=None):
    """Plain version: dense masked attention in fp32 with the kernel's
    masking rules (``-1e30`` scores, probabilities of masked pairs set to
    zero, padding query rows exact zeros). Returns ``(B, Sq, H*hd)``."""
    bsz, sq, nheads, hd = q.shape
    _, sk, n_kv, _ = k.shape
    g = nheads // n_kv
    qf = q.to(torch.float32).reshape(bsz, sq, n_kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32))
    scores = scores * (1.0 / math.sqrt(hd))
    valid = prefill_mask(sq, sk, lengths, window)[:, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.to(torch.float32))
    out = torch.where(denom > 0, out / torch.where(denom > 0, denom, 1.0),
                      torch.zeros_like(out))
    # (B, KV, G, Sq, hd) -> (B, Sq, H*hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(bsz, sq, nheads * hd)
    return out.to(q.dtype)


def _pick(dim: int, candidates) -> int:
    for c in candidates:
        if dim % c == 0:
            return c
    raise ValueError(f"dim {dim} has no tile among {candidates}")


def _forward(q, k, v, lengths, window):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not q.is_cuda:
        return flash_prefill_attention_plain(q, k, v, lengths, window=window)
    bsz, sq, nheads, hd = q.shape
    _, sk, n_kv, _ = k.shape
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError("kernel takes q/k/v of one dtype, bf16 or fp32")
    if q.dtype == torch.bfloat16 and hd not in (64, 128):
        raise ValueError("the bf16 kernel takes head_dim 64 or 128")
    if hd > 128 or hd % 4:
        raise ValueError("kernel takes head_dim <= 128, a multiple of 4")
    qc, kc, vc = (_build.aligned16(t) for t in (q, k, v))
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((bsz, sq, nheads * hd), dtype=q.dtype, device=q.device)
    _build.launch(_LIB, "bd_flash_prefill",
                  [P, P, P, P, P, I, I, I, I, I, I, I, F, I, P],
                  _build.ptr(qc), _build.ptr(kc), _build.ptr(vc),
                  _build.ptr(lens), _build.ptr(out), bsz, sq, sk, nheads,
                  n_kv, hd, window or 0, 1.0 / math.sqrt(hd),
                  int(q.dtype == torch.bfloat16), _build.stream(q.device))
    flash_prefill_attention.launches += 1
    return out


def _blockwise_backward(q, k, v, lengths, g, window, bq):
    """Attention backward by query-block recompute (the JAX package's
    ``_blockwise_backward``, plain torch in fp32).

    Rebuilds each query block's masked softmax rows from (q, k, v) and
    applies ``dv += p^T g; dp = g v^T; ds = p (dp - rowsum(dp p));
    dq = ds k * scale; dk += ds^T q * scale``. The largest temporary is
    one ``(B, KV, G, bq, Sk)`` fp32 tile. Masked pairs have p == 0, so
    padding, causal and window gradients are exact zeros. g: ``(B, Sq,
    H, hd)``. Returns ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    bsz, sq, nh, hd = q.shape
    _, sk, n_kv, _ = k.shape
    gq = nh // n_kv
    sm_scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32).reshape(bsz, sq, n_kv, gq, hd)
    gf = g.to(torch.float32).reshape(bsz, sq, n_kv, gq, hd)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    kpos = torch.arange(sk, device=dev)[None, :]                 # (1, Sk)
    length = lengths.to(torch.int64)
    klive = kpos < length[:, None]                               # (B, Sk)
    dk = torch.zeros((bsz, sk, n_kv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    dq = torch.empty((bsz, sq, n_kv, gq, hd), dtype=torch.float32,
                     device=dev)
    for q0 in range(0, sq, bq):
        xq = qf[:, q0:q0 + bq]                          # (B,bq,KV,G,hd)
        xg = gf[:, q0:q0 + bq]
        qpos = q0 + torch.arange(bq, device=dev)
        valid = ((kpos[:, None, :] <= qpos[None, :, None])
                 & klive[:, None, :]
                 & (qpos[None, :, None] < length[:, None, None]))
        if window is not None:
            valid &= kpos[:, None, :] > qpos[None, :, None] - window
        vmask = valid[:, None, None]                    # (B,1,1,bq,Sk)
        scores = torch.einsum("bqkgd,bskd->bkgqs", xq, kf) * sm_scale
        s = torch.where(vmask, scores, torch.full_like(scores, _NEG_INF))
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF)
        p = torch.where(vmask, torch.exp(s - m), torch.zeros_like(s))
        denom = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(denom > 0, denom, torch.ones_like(denom))
        xg_t = xg.permute(0, 2, 3, 1, 4)                # (B,KV,G,bq,hd)
        dv += torch.einsum("bkgqs,bkgqd->bskd", p, xg_t)
        dp = torch.einsum("bkgqd,bskd->bkgqs", xg_t, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, q0:q0 + bq] = (torch.einsum("bkgqs,bskd->bkgqd", ds, kf)
                             * sm_scale).permute(0, 3, 1, 2, 4)
        dk += torch.einsum("bkgqs,bqkgd->bskd", ds, xq) * sm_scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _FlashPrefill(torch.autograd.Function):
    """The custom VJP of the JAX package's ``_flash_prefill``: saves the
    primals ``(q, k, v, lengths)`` only, and recomputes blockwise with
    ``bq = _pick(Sq, (128, 64, 32, 16, 8, Sq))`` in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, window):
        ctx.save_for_backward(q, k, v, lengths)
        ctx.window = window
        return _forward(q, k, v, lengths, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths = ctx.saved_tensors
        sq = q.shape[1]
        bq = _pick(sq, (128, 64, 32, 16, 8, sq))
        dq, dk, dv = _blockwise_backward(q, k, v, lengths,
                                         g.reshape(q.shape), ctx.window, bq)
        return dq, dk, dv, None, None


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """Causal attention for fresh sequences over a right-padded cache.

    q ``(B, Sq, H, hd)``; k, v ``(B, Sk >= Sq, KV, hd)``; lengths ``(B,)``.
    Returns ``(B, Sq, H*hd)`` in q's dtype; padding query rows are exact
    zeros. Differentiable in q, k, v (blockwise-recompute backward); with
    no gradient to take (serving, under ``torch.no_grad()``) it is the
    forward alone."""
    bsz, sq, nheads, hd = q.shape
    _, sk, n_kv, hdk = k.shape
    if hdk != hd or k.shape != v.shape or sk < sq or nheads % n_kv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashPrefill.apply(q, k, v, lengths, window)
    return _forward(q, k, v, lengths, window)


flash_prefill_attention.launches = 0
