"""Flash-prefill attention, forward (port of the forward of
``bitdelta_tpu/ops/flash_prefill.py::flash_prefill_attention``; the
blockwise-recompute backward waits for the training slice).

:func:`flash_prefill_attention` launches ``csrc/flash_prefill.cu`` on a
CUDA tensor and takes :func:`flash_prefill_attention_plain` on a CPU
tensor; launches are counted in ``flash_prefill_attention.launches``.
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


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """Causal attention for fresh sequences over a right-padded cache.

    q ``(B, Sq, H, hd)``; k, v ``(B, Sk >= Sq, KV, hd)``; lengths ``(B,)``.
    Returns ``(B, Sq, H*hd)`` in q's dtype; padding query rows are exact
    zeros."""
    bsz, sq, nheads, hd = q.shape
    _, sk, n_kv, hdk = k.shape
    if hdk != hd or k.shape != v.shape or sk < sq or nheads % n_kv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not q.is_cuda:
        return flash_prefill_attention_plain(q, k, v, lengths, window=window)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError("kernel takes q/k/v of one dtype, bf16 or fp32")
    if hd > 128 or hd % 4:
        raise ValueError("kernel takes head_dim <= 128, a multiple of 4")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
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


flash_prefill_attention.launches = 0
