"""Scale distillation in plain fp32 (no TF32): the teacher is the dense
fine-tune's forward, the student the base plus ``scale * sign(fine -
base)`` at every projection (a zero difference counts as +1, each scale
starting at ``mean |fine - base|``), the loss the mean squared
difference of their logits, and AdamW (torch's decoupled weight decay
and bias corrections) under a cosine decay over ``num_steps``.

Layer by layer: each layer's weights are regenerated from the seed when
they are needed, and the student's layers are recomputed in the
backward pass (``torch.utils.checkpoint``), so one layer's fp32 weights
are on the card at a time."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import world
from .decoder import attention, matmul, no_tf32, rms_norm, rope


def _weights(cfg, seed, name, layer, device):
    """``(base, fine)`` fp32 of one layer of ``name``; the fine-tune is
    rounded to bf16 as the inputs are."""
    base = world.base_layer(cfg, seed, name, layer, device)
    fine = world.noise_layer(cfg, seed, name, layer, device).add_(base)
    return base.to(torch.float32), fine.to(torch.float32)


def _layer(cfg, x, w, precision):
    """One Mistral block over ``x (B, S, D)``; ``w(name, h)`` is the
    projection ``h @ W``."""
    s, c = world.shapes(cfg), cfg["config"]
    b, n, d = x.shape
    eps, hd = c["rms_norm_eps"], s["head_dim"]
    h = rms_norm(x, 1.0, eps).reshape(b * n, d)
    q = w("q_proj", h).reshape(b, n, s["heads"], hd)
    k = w("k_proj", h).reshape(b, n, s["kv_heads"], hd)
    v = w("v_proj", h).reshape(b, n, s["kv_heads"], hd)
    att = torch.stack([attention(rope(q[i], c["rope_theta"]),
                                 rope(k[i], c["rope_theta"]), v[i],
                                 c.get("sliding_window")) for i in range(b)])
    x = x + w("o_proj", att.reshape(b * n, -1)).reshape(b, n, d)
    h = rms_norm(x, 1.0, eps).reshape(b * n, d)
    a = torch.nn.functional.silu(w("gate_proj", h)) * w("up_proj", h)
    return x + w("down_proj", a).reshape(b, n, d)


def _head(cfg, seed, x, device, precision):
    """Final norm (unit weights) and the shared head."""
    head = world.dense_model_head(cfg, seed, device).to(torch.float32)
    h = rms_norm(x, 1.0, cfg["config"]["rms_norm_eps"])
    return matmul(h.reshape(-1, h.shape[-1]), head, precision)


def follow(cfg: dict, seed: int, batches: List[np.ndarray], dcfg, device,
           precision: str = "fp32") -> Dict[str, object]:
    """Losses of ``len(batches)`` steps, the first step's gradient and the
    scales' change after the last, each scale leaf ``(L,)`` by name."""
    no_tf32()
    s = world.shapes(cfg)
    names = list(world.leaf_specs(cfg))
    L = s["layers"]
    embed = world.dense_model_embed(cfg, seed, device).to(torch.float32)
    start = {n: torch.empty(L, device=device) for n in names}
    for layer in range(L):
        for n in names:
            base, fine = _weights(cfg, seed, n, layer, device)
            start[n][layer] = (fine - base).abs().mean()
    scales = {n: v.clone().requires_grad_() for n, v in start.items()}
    m = {n: torch.zeros_like(v) for n, v in start.items()}
    v2 = {n: torch.zeros_like(v) for n, v in start.items()}
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    losses, grad1 = [], None

    def student_layer(x, layer, *sc):
        by = dict(zip(names, sc))

        def w(name, h):
            base, fine = _weights(cfg, seed, name, layer, device)
            sign = torch.where(fine >= base, 1.0, -1.0)
            return (matmul(h, base, precision)
                    + by[name][layer] * matmul(h, sign, precision))
        return _layer(cfg, x, w, precision)

    for t, tokens in enumerate(batches):
        tok = torch.as_tensor(tokens, device=device)
        with torch.no_grad():
            x = embed[tok]
            for layer in range(L):
                x = _layer(cfg, x, lambda name, h: matmul(
                    h, _weights(cfg, seed, name, layer, device)[1],
                    precision), precision)
            teacher = _head(cfg, seed, x, device, precision)
        x = embed[tok]
        for layer in range(L):
            x = checkpoint(student_layer, x, layer,
                           *[scales[n] for n in names], use_reentrant=False)
        student = _head(cfg, seed, x, device, precision)
        loss = ((teacher - student) ** 2).mean()
        grads = torch.autograd.grad(loss, [scales[n] for n in names])
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr = dcfg.lr * 0.5 * (1 + math.cos(
            math.pi * min(t, dcfg.num_steps) / dcfg.num_steps))
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = scales[n]
                p.mul_(1 - lr * dcfg.weight_decay)
                m[n].mul_(beta1).add_(g, alpha=1 - beta1)
                v2[n].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = (v2[n].sqrt() / math.sqrt(1 - beta2 ** (t + 1))
                         ).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - beta1 ** (t + 1)))
    return {"losses": losses, "grad1": grad1,
            "change": {n: (scales[n] - start[n]).detach() for n in names}}


def _leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names) -> float:
    """The worst leaf's gap of norms, ``| |got| - |ref| |``, against the
    larger of that leaf's reference norm and the median leaf's."""
    norms = {n: float(ref[n].norm()) for n in names}
    med = statistics.median(norms.values())
    return max(abs(float(got[n].norm()) - norms[n]) / max(norms[n], med)
               for n in names)


def gaps(got: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: the largest relative gap of a step's loss,
    the first gradient's and the three steps' change's worst leaf. A
    leaf whose reference gradient is under a thousandth of the median
    leaf's moves by round-off alone and is left out of the change."""
    g_norm = {n: float(g.norm()) for n, g in ref["grad1"].items()}
    med = statistics.median(g_norm.values())
    moving = [n for n in ref["change"] if g_norm[n] >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad1_gap": _leaf_gap(got["grad1"], ref["grad1"],
                                   list(ref["grad1"])),
            "change_gap": _leaf_gap(got["change"], ref["change"], moving)}
