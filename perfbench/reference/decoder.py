"""The served model's plain forward in fp32: Mistral's decoder (GQA with
RoPE, a sliding window, RMSNorm, SwiGLU) or Mixtral's (the same attention,
a top-2 routed SwiGLU over 8 experts), each tenant's weights being the
base plus ``scale * sign`` at every projection, expert and router, with
the tenant's own norms, embed and head.

It works layer by layer over whole sequences (no cache, no batching),
regenerating each layer's inputs from the seed, so it fits beside
nothing else on the card once the program's state is freed. TF32 is off.
``precision="fp8"`` is the control: every weight matmul rounds both
operands to float8 e4m3 (one scale a row of x, one a column of W).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .. import world
from .unpack import unpack_pm1

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, -2)
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``(S, heads, hd)`` at positions 0..S-1, rotate-half convention."""
    s, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], -1)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def attention(q, k, v, window) -> torch.Tensor:
    """Causal GQA: q ``(S, H, hd)``, k/v ``(S, KV, hd)`` -> ``(S, H*hd)``;
    query head h reads KV head ``h // (H // KV)``."""
    s, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1),
                        v).reshape(s, h * hd)


def tenant_weights(cfg: dict, seed: int, name: str, layer: int,
                   tenants: Sequence[int], device) -> Dict[int, torch.Tensor]:
    """fp32 fine-tune weights of one layer of ``name`` for each tenant:
    the base (a W8 leaf dequantized, ``q * scale``) plus ``scale *
    sign``."""
    base = world.base_layer(cfg, seed, name, layer, device)
    if isinstance(base, tuple):
        w0 = base[0].to(torch.float32) * base[1].unsqueeze(-2)
    else:
        w0 = base.to(torch.float32)
    words = world.delta_layer(cfg, seed, name, layer, device)
    scales = world.delta_scales(cfg, seed, name, device)[layer]
    return {t: w0 + scales[t][..., None, None] * unpack_pm1(words[t])
            for t in tenants}


def _moe(h, w, top_k: int, precision: str) -> torch.Tensor:
    """Top-k routed SwiGLU: router logits over the experts, the k largest
    kept (the lower index first among equal values), softmax over them,
    and each token through its k experts."""
    logits = matmul(h, w["router"], precision)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :top_k], -1)
    top = idx[:, :top_k]
    y = torch.zeros_like(h)
    for e in range(w["w1"].shape[0]):
        rows, slot = (top == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        he = h[rows]
        a = (torch.nn.functional.silu(matmul(he, w["w1"][e], precision))
             * matmul(he, w["w3"][e], precision))
        y.index_add_(0, rows, gates[rows, slot, None]
                     * matmul(a, w["w2"][e], precision))
    return y


def served_logits(cfg: dict, seed: int, seqs: List[dict], device,
                  precision: str = "fp32") -> List[torch.Tensor]:
    """For each ``{"tenant", "tokens", "start"}`` the fp32 logits ``(len -
    start, V)`` at positions ``start ..`` of the whole sequence
    ``tokens``."""
    no_tf32()
    s, c = world.shapes(cfg), cfg["config"]
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    window = c.get("sliding_window")
    hd, heads, kv = s["head_dim"], s["heads"], s["kv_heads"]
    ex = world.tenant_extras(cfg, seed, device)
    tenants = sorted({q["tenant"] for q in seqs})
    xs = [ex["embed"][q["tenant"]][torch.as_tensor(q["tokens"],
                                                   device=device)].float()
          for q in seqs]
    names = list(world.leaf_specs(cfg))
    with torch.no_grad():
        for layer in range(s["layers"]):
            w = {n: tenant_weights(cfg, seed, n, layer, tenants, device)
                 for n in names}
            for i, q in enumerate(seqs):
                t, x = q["tenant"], xs[i]
                wt = {n: w[n][t] for n in names}
                h = rms_norm(x, ex["attn_norm"][layer, t].float(), eps)
                n_tok = h.shape[0]
                qh = rope(matmul(h, wt["q_proj"], precision).reshape(
                    n_tok, heads, hd), theta)
                kh = rope(matmul(h, wt["k_proj"], precision).reshape(
                    n_tok, kv, hd), theta)
                vh = matmul(h, wt["v_proj"], precision).reshape(n_tok, kv, hd)
                x = x + matmul(attention(qh, kh, vh, window), wt["o_proj"],
                               precision)
                h = rms_norm(x, ex["mlp_norm"][layer, t].float(), eps)
                if s["experts"]:
                    x = x + _moe(h, wt, s["experts_per_token"], precision)
                else:
                    a = (torch.nn.functional.silu(
                        matmul(h, wt["gate_proj"], precision))
                        * matmul(h, wt["up_proj"], precision))
                    x = x + matmul(a, wt["down_proj"], precision)
                xs[i] = x
            del w
        out = []
        for q, x in zip(seqs, xs):
            t = q["tenant"]
            h = rms_norm(x[q["start"]:], ex["final_norm"][t].float(), eps)
            out.append(matmul(h, ex["lm_head"][t].float(), precision))
    return out
