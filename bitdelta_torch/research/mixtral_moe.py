"""Mixtral MoE expert compression: every expert as a 1-bit delta off its
layer's mean expert (port of ``bitdelta_tpu/research/mixtral_moe.py``).

An 8-expert FFN then stores one mean expert plus 8 one-bit deltas, about
(1 + 8/16) experts instead of 8. Evaluation is dense over experts: the
mean GEMM is shared, each expert's delta runs through the batched binary
GEMM (an expert is a tenant of the mean expert), and the router's top-k
softmax weights combine them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.delta import BinaryDelta, quantize_delta
from ..ops.binary_matmul import binary_bmm, matmul_f32


class MoEExpertDelta(NamedTuple):
    """One FFN matrix family across experts: mean weights + per-expert
    1-bit deltas (packed ``(E, K//32, N)``, scale ``(E,)``)."""

    mean_w: torch.Tensor
    delta: BinaryDelta


def compress_experts(expert_w: torch.Tensor) -> MoEExpertDelta:
    """expert_w ``(E, K, N)`` -> the mean expert and each expert's delta
    against it."""
    mean_w = expert_w.to(torch.float32).mean(dim=0).to(expert_w.dtype)
    delta = quantize_delta(mean_w.expand(expert_w.shape), expert_w)
    return MoEExpertDelta(mean_w=mean_w, delta=delta)


class MoEDeltaFFN(NamedTuple):
    """A compressed SwiGLU expert family (w1 = gate, w3 = up, w2 =
    down)."""

    w1: MoEExpertDelta
    w3: MoEExpertDelta
    w2: MoEExpertDelta


def compress_moe_ffn(w1: torch.Tensor, w3: torch.Tensor,
                     w2: torch.Tensor) -> MoEDeltaFFN:
    return MoEDeltaFFN(w1=compress_experts(w1), w3=compress_experts(w3),
                       w2=compress_experts(w2))


def _expert_matmul(x: torch.Tensor, fam: MoEExpertDelta,
                   compute_dtype) -> torch.Tensor:
    """``x (E, M, K)`` against mean + delta: the shared mean GEMM plus the
    batched 1-bit delta GEMM."""
    y_mean = matmul_f32(x.to(compute_dtype), fam.mean_w.to(compute_dtype))
    y_delta = binary_bmm(x, fam.delta.packed, fam.delta.scale,
                         compute_dtype=compute_dtype).to(torch.float32)
    return (y_mean + y_delta).to(compute_dtype)


def moe_ffn_apply(x: torch.Tensor, ffn: MoEDeltaFFN,
                  router_logits: torch.Tensor, top_k: int = 2,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense-evaluated top-k routed SwiGLU over compressed experts: x
    ``(M, K)``, router_logits ``(M, E)``; every expert computes and the
    renormalized top-k softmax weights combine them."""
    from ..models.mixtral import _route

    m, k = x.shape
    e = ffn.w1.delta.packed.shape[0]
    topv, topi = _route(router_logits, top_k)                  # (M, k)
    gates = torch.softmax(topv, dim=-1)
    weight = torch.zeros((m, e), dtype=torch.float32, device=x.device)
    weight.scatter_(-1, topi, gates.to(torch.float32))
    xe = x[None].expand(e, m, k)
    h1 = _expert_matmul(xe, ffn.w1, compute_dtype)
    h3 = _expert_matmul(xe, ffn.w3, compute_dtype)
    h = torch.nn.functional.silu(h1.to(torch.float32)).to(compute_dtype) * h3
    out = _expert_matmul(h, ffn.w2, compute_dtype)             # (E, M, N)
    return torch.einsum("emn,me->mn", out.to(torch.float32),
                        weight).to(x.dtype)


def moe_compression_ratio(w: torch.Tensor, fam: MoEExpertDelta) -> float:
    """Dense bf16 bytes of ``w`` over the compressed family's bytes."""
    dense = w.numel() * 2
    comp = (fam.mean_w.numel() * 2 + fam.delta.packed.numel() * 4
            + fam.delta.scale.numel() * 4)
    return dense / comp
