"""Flash-decode attention: one query per row over its live KV-cache
positions (port of ``bitdelta_tpu/ops/flash_decode.py``): a bf16/fp32
cache, or an int8 cache with its per-(row, position, KV head) fp32
scales (``ops/kv_quant.py``), read at 1 byte an element.

:func:`flash_decode_attention` launches ``csrc/flash_decode.cu`` on a
CUDA tensor (``flash_decode_split_kernel`` over splits of 64 live keys,
then ``flash_decode_merge_kernel``) and takes
:func:`flash_decode_attention_plain` on a CPU tensor; launches are
counted in ``flash_decode_attention.launches``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._build import F, I, P
from .kv_quant import dequantize_kv

_NEG_INF = -1e30
_LIB = "flash_decode"
_SPLIT_KEYS = 64    # live keys per block (the kernel's DEC_CHUNK)


def _live_range(lengths: torch.Tensor, window: Optional[int], s: int):
    pos = torch.arange(s, device=lengths.device)
    hi = lengths.to(torch.int64)[:, None]
    valid = pos[None, :] < hi
    if window is not None:
        valid &= pos[None, :] >= torch.clamp(hi - window, min=0)
    return valid                                           # (B, S)


def flash_decode_attention_plain(q, k, v, lengths, *, k_scale=None,
                                 v_scale=None, window=None):
    """Plain version: masked softmax attention in fp32 over the same live
    positions (an int8 cache dequantized to fp32 first); rows with no live
    position give zeros."""
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, torch.float32)
        v = dequantize_kv(v, v_scale, torch.float32)
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
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a right-aligned cache.

    q ``(B, H, hd)``; k, v ``(B, S, KV, hd)`` including this step's K/V,
    of q's dtype, or int8 with ``k_scale``/``v_scale`` ``(B, S, KV)``
    fp32; lengths ``(B,)`` live positions per row (the token just written
    included: the caller passes ``q_positions + 1``); ``window``: keys at
    positions ``>= len - window`` attend. Returns ``(B, H, hd)`` in q's
    dtype."""
    bsz, nheads, hd = q.shape
    _, s, n_kv, hdk = k.shape
    if hdk != hd or k.shape != v.shape or nheads % n_kv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    if quantized and (tuple(k_scale.shape) != (bsz, s, n_kv)
                      or tuple(v_scale.shape) != (bsz, s, n_kv)):
        raise ValueError(f"scales {tuple(k_scale.shape)} "
                         f"{tuple(v_scale.shape)} != {(bsz, s, n_kv)}")
    if not q.is_cuda:
        return flash_decode_attention_plain(q, k, v, lengths, k_scale=k_scale,
                                            v_scale=v_scale, window=window)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("kernel takes q of dtype bf16 or fp32")
    if quantized:
        if not (k.dtype == v.dtype == torch.int8):
            raise TypeError("scaled K/V must be int8")
        if not (k_scale.dtype == v_scale.dtype == torch.float32):
            raise TypeError("K/V scales must be fp32")
    elif not (q.dtype == k.dtype == v.dtype):
        raise TypeError("kernel takes q/k/v of one dtype, bf16 or fp32")
    if hd not in (64, 128) or nheads // n_kv not in (1, 2, 4, 8):
        raise ValueError("kernel takes head_dim 64 or 128 and 1, 2, 4 or 8 "
                         "query heads a KV head")
    qc, kc, vc = (_build.aligned16(t) for t in (q, k, v))
    ksc = k_scale.contiguous() if quantized else None
    vsc = v_scale.contiguous() if quantized else None
    lens = lengths.to(torch.int32).contiguous()
    # Splits for the most keys a row can see; the kernel reads the lengths
    # on the device, and splits past a row's live keys exit at once.
    live = min(s, window) if window else s
    n_split = -(-live // _SPLIT_KEYS)
    part_acc = torch.empty((bsz, nheads, n_split, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((bsz, nheads, n_split, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(qc)
    _build.launch(_LIB, "bd_flash_decode",
                  [P] * 9 + [I] * 6 + [F, I, I, I, I, P],
                  _build.ptr(qc), _build.ptr(kc), _build.ptr(vc),
                  _build.ptr(ksc) if quantized else None,
                  _build.ptr(vsc) if quantized else None,
                  _build.ptr(lens), _build.ptr(part_acc),
                  _build.ptr(part_ml), _build.ptr(out), bsz, s, nheads, n_kv,
                  hd, window or 0, 1.0 / math.sqrt(hd), _SPLIT_KEYS, n_split,
                  int(q.dtype == torch.bfloat16), int(quantized),
                  _build.stream(q.device))
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
