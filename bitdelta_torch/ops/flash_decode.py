"""Flash-decode attention: one query per row over its live KV-cache
positions (port of ``bitdelta_tpu/ops/flash_decode.py``, bf16/fp32
cache; the int8-cache branch waits for the int8-KV slice).

:func:`flash_decode_attention` launches ``csrc/flash_decode.cu`` on a
CUDA tensor and takes :func:`flash_decode_attention_plain` on a CPU
tensor; launches are counted in ``flash_decode_attention.launches``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._build import F, I, P

_NEG_INF = -1e30
_LIB = "flash_decode"
_SPLIT_KEYS = 256   # live keys per block; longer rows split over blocks


def _live_range(lengths: torch.Tensor, window: Optional[int], s: int):
    pos = torch.arange(s, device=lengths.device)
    hi = lengths.to(torch.int64)[:, None]
    valid = pos[None, :] < hi
    if window is not None:
        valid &= pos[None, :] >= torch.clamp(hi - window, min=0)
    return valid                                           # (B, S)


def flash_decode_attention_plain(q, k, v, lengths, *, window=None):
    """Plain version: masked softmax attention in fp32 over the same live
    positions; rows with no live position give zeros."""
    bsz, nheads, hd = q.shape
    _, s, n_kv, _ = k.shape
    g = nheads // n_kv
    qf = q.to(torch.float32).reshape(bsz, n_kv, g, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32))
    scores = scores * (1.0 / math.sqrt(hd))
    valid = _live_range(lengths, window, s)[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    out = torch.where(denom > 0, out / torch.where(denom > 0, denom, 1.0),
                      torch.zeros_like(out))
    return out.reshape(bsz, nheads, hd).to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a right-aligned cache.

    q ``(B, H, hd)``; k, v ``(B, S, KV, hd)`` including this step's K/V;
    lengths ``(B,)`` live positions per row (the token just written
    included: the caller passes ``q_positions + 1``); ``window``: keys at
    positions ``>= len - window`` attend. Returns ``(B, H, hd)`` in q's
    dtype."""
    bsz, nheads, hd = q.shape
    _, s, n_kv, hdk = k.shape
    if hdk != hd or k.shape != v.shape or nheads % n_kv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not q.is_cuda:
        return flash_decode_attention_plain(q, k, v, lengths, window=window)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError("kernel takes q/k/v of one dtype, bf16 or fp32")
    if (nheads // n_kv) * hd > 8 * 128:
        raise ValueError("kernel holds at most 1024 (G * hd) outputs a block")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    live = min(s, window) if window else s      # most keys a row can see
    n_split = -(-live // _SPLIT_KEYS)
    part_acc = torch.empty((bsz, nheads, n_split, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((bsz, nheads, n_split, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(qc)
    _build.launch(_LIB, "bd_flash_decode",
                  [P] * 7 + [I] * 6 + [F, I, I, I, P],
                  _build.ptr(qc), _build.ptr(kc), _build.ptr(vc),
                  _build.ptr(lens), _build.ptr(part_acc),
                  _build.ptr(part_ml), _build.ptr(out), bsz, s, nheads, n_kv,
                  hd, window or 0, 1.0 / math.sqrt(hd), _SPLIT_KEYS, n_split,
                  int(q.dtype == torch.bfloat16), _build.stream(q.device))
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
