"""Per-slot token sampling: greedy / temperature / top-k / top-p (port of
``bitdelta_tpu/serving/sampling.py``). Vectorized over the batch, no
host sync; random bits come from an explicit ``torch.Generator``, so
sampled tokens differ from JAX's while greedy tokens are identical.
"""

from __future__ import annotations

import torch


def sample_tokens(generator: torch.Generator, logits: torch.Tensor,
                  temps: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor) -> torch.Tensor:
    """One token per row. logits ``(B, V)`` fp32 (already vocab-masked
    with -inf); temps ``(B,)`` (0 = greedy); top_ks ``(B,)`` (0 = off);
    top_ps ``(B,)`` (1.0 = off). Returns int32 ``(B,)``."""
    b, v = logits.shape
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values

    k = torch.clamp(top_ks.to(torch.int64), 1, v)
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    mask_k = torch.where((top_ks > 0)[:, None], logits >= kth,
                         torch.ones_like(logits, dtype=torch.bool))

    temps_safe = torch.clamp(temps, min=1e-4)[:, None]
    probs_sorted = torch.softmax(sorted_desc / temps_safe, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < top_ps[:, None]
    min_kept = torch.where(keep_sorted, sorted_desc,
                           torch.full_like(sorted_desc, float("inf"))
                           ).amin(dim=-1)
    mask_p = torch.where((top_ps < 1.0)[:, None],
                         logits >= min_kept[:, None],
                         torch.ones_like(logits, dtype=torch.bool))

    masked = torch.where(mask_k & mask_p, logits / temps_safe,
                         torch.full_like(logits, float("-inf")))
    # Gumbel-max: argmax(logits + Gumbel noise) samples the categorical.
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)
