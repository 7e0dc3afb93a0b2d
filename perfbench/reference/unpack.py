"""Sign words to dense weights, the harness's own frozen copy of the
layout: bit ``s`` of int32 word ``[k32, n]`` is the sign of row ``32 k32
+ s`` of column ``n``, 1 for +1 and 0 for -1."""

from __future__ import annotations

import torch


def unpack_pm1(words: torch.Tensor) -> torch.Tensor:
    """``(*, K//32, N)`` int32 words -> ``(*, K, N)`` fp32 of +-1."""
    *lead, k32, n = words.shape
    u = words.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((*lead, k32, 32, n), dtype=torch.float32,
                      device=words.device)
    for s in range(32):
        out[..., s, :] = ((u >> s) & 1).to(torch.float32) * 2.0 - 1.0
    return out.reshape(*lead, k32 * 32, n)

