"""Int8 KV-cache quantization (port of ``bitdelta_tpu/ops/kv_quant.py``,
the same fp32 arithmetic and round-half-to-even, bit for bit).

Symmetric absmax per ``(batch, position, kv_head)``: one fp32 scale per
stored K (or V) vector, so a row dequantizes with one multiply inside
the flash-decode kernel, and the cache streams 1 byte an element (half
a bf16 cache's traffic, twice its capacity).
"""

from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor):
    """``(..., KV, hd)`` float -> (int8 ``(..., KV, hd)``, fp32 scale
    ``(..., KV)``) with ``x ~ q * scale[..., None]``."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (the attention paths other than the
    flash-decode kernel read this view)."""
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)
            ).to(dtype)
