"""The inputs of every cell, made on the device from ``--seed``: a base
model, tenants' 1-bit deltas with their per-tenant extras, or a dense
fine-tune to distill. Plain torch only: the plain references regenerate
any leaf from the same seed, layer by layer, and get the same bits.

Each leaf layer is filled by one call from a generator seeded by
``leaf_seed(seed, kind, name, layer)``, so a leaf does not depend on the
order in which others were made. Matrices are ``(K_in, N_out)`` (``y = x
@ W``), as the port keeps them.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Dict, Tuple

import torch

ROOT = Path(__file__).resolve().parent
INT8_STD = 127 / math.sqrt(3)     # std of uniform integers in [-127, 127]


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def shapes(cfg: dict) -> Dict[str, int]:
    """The sizes the harness needs from a configuration file's published
    ``config``."""
    c = cfg["config"]
    heads = c["num_attention_heads"]
    return {"hidden": c["hidden_size"], "intermediate": c["intermediate_size"],
            "layers": c["num_hidden_layers"], "heads": heads,
            "kv_heads": c.get("num_key_value_heads", heads),
            "head_dim": c.get("head_dim") or c["hidden_size"] // heads,
            "vocab": c["vocab_size"], "experts": c.get("num_local_experts", 0),
            "experts_per_token": c.get("num_experts_per_tok", 0)}


def leaf_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one leaf layer, stable across runs."""
    text = ":".join(str(p) for p in (seed,) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(leaf_seed(seed, *parts))


def leaf_specs(cfg: dict) -> Dict[str, Tuple[tuple, float]]:
    """Per-layer shape and standard deviation of each base projection. The
    residual branch's output projections are drawn narrower by sqrt(2 L)
    (``assumed.out_proj_std_divisor``), so the residual stream is not
    swamped by any one layer, as in a trained model."""
    s, a = shapes(cfg), cfg["assumed"]
    d, i, hd = s["hidden"], s["intermediate"], s["head_dim"]
    q, kv = s["heads"] * hd, s["kv_heads"] * hd
    std = a["weight_std"]
    out_std = std / math.sqrt(a["out_proj_std_divisor"] * s["layers"])
    specs = {"q_proj": ((d, q), std), "k_proj": ((d, kv), std),
             "v_proj": ((d, kv), std), "o_proj": ((q, d), out_std)}
    if s["experts"]:
        e = s["experts"]
        specs.update({"w1": ((e, d, i), std), "w3": ((e, d, i), std),
                      "w2": ((e, i, d), out_std), "router": ((d, e), std)})
    else:
        specs.update({"gate_proj": ((d, i), std), "up_proj": ((d, i), std),
                      "down_proj": ((i, d), out_std)})
    return specs


def base_layer(cfg: dict, seed: int, name: str, layer: int, device,
               out=None):
    """One layer of base leaf ``name``: a bf16 matrix drawn N(0, std^2),
    or for a W8 configuration (``assumed.base == "int8"``; the router
    stays bf16) ``(q int8, scale fp32 (.., N))``: integers uniform in
    [-127, 127] and per-column scales around std / INT8_STD."""
    shape, std = leaf_specs(cfg)[name]
    gen = generator(device, seed, "base", name, layer)
    if cfg["assumed"]["base"] == "int8" and name != "router":
        q = out[0] if out is not None else torch.empty(
            shape, dtype=torch.int8, device=device)
        q.random_(-127, 128, generator=gen)
        scale = out[1] if out is not None else torch.empty(
            shape[:-2] + shape[-1:], dtype=torch.float32, device=device)
        scale.uniform_(0.75, 1.25, generator=gen).mul_(std / INT8_STD)
        return q, scale
    w = out if out is not None else torch.empty(shape, dtype=torch.bfloat16,
                                                device=device)
    return w.normal_(0.0, std, generator=gen)


def base_leaves(cfg: dict, seed: int, device) -> Dict[str, object]:
    """Every base projection, layer-stacked ``(L, ...)``: a tensor, or a
    ``(q, scale)`` pair of stacks for a W8 leaf."""
    L = shapes(cfg)["layers"]
    out = {}
    for name, (shape, _) in leaf_specs(cfg).items():
        if cfg["assumed"]["base"] == "int8" and name != "router":
            leaf = (torch.empty((L,) + shape, dtype=torch.int8, device=device),
                    torch.empty((L,) + shape[:-2] + shape[-1:],
                                dtype=torch.float32, device=device))
            for layer in range(L):
                base_layer(cfg, seed, name, layer, device,
                           out=(leaf[0][layer], leaf[1][layer]))
        else:
            leaf = torch.empty((L,) + shape, dtype=torch.bfloat16,
                               device=device)
            for layer in range(L):
                base_layer(cfg, seed, name, layer, device, out=leaf[layer])
        out[name] = leaf
    return out


def delta_layer(cfg: dict, seed: int, name: str, layer: int, device,
                out=None) -> torch.Tensor:
    """Every tenant's packed sign words of one layer of ``name``, ``(T,
    [E,] K//32, N)`` int32: bit ``s`` of word ``[k32, n]`` is the sign of
    row ``32 k32 + s`` (1 for +1), each bit a fair coin."""
    shape, _ = leaf_specs(cfg)[name]
    words = shape[:-2] + (shape[-2] // 32, shape[-1])
    t = cfg["assumed"]["tenants"]
    w = out if out is not None else torch.empty((t,) + words,
                                                dtype=torch.int32,
                                                device=device)
    return w.random_(-2 ** 31, 2 ** 31,
                     generator=generator(device, seed, "words", name, layer))


def delta_scales(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    """``(L, T, [E])`` fp32 scales: ``mean |delta|`` of a fine-tune whose
    delta is ``assumed.delta_ratio`` of the leaf's std, times a factor
    uniform in [0.5, 1.5] per matrix."""
    shape, std = leaf_specs(cfg)[name]
    s = shapes(cfg)
    lead = (s["layers"], cfg["assumed"]["tenants"]) + shape[:-2]
    mean_abs = cfg["assumed"]["delta_ratio"] * std * math.sqrt(2 / math.pi)
    out = torch.empty(lead, dtype=torch.float32, device=device)
    out.uniform_(0.5, 1.5, generator=generator(device, seed, "scale", name))
    return out.mul_(mean_abs)


def deltas(cfg: dict, seed: int, device) -> Dict[str, Tuple[torch.Tensor,
                                                           torch.Tensor]]:
    """``{name: (words (L, T, [E,] K//32, N), scales (L, T, [E]))}``."""
    L = shapes(cfg)["layers"]
    out = {}
    for name, (shape, _) in leaf_specs(cfg).items():
        words = shape[:-2] + (shape[-2] // 32, shape[-1])
        w = torch.empty((L, cfg["assumed"]["tenants"]) + words,
                        dtype=torch.int32, device=device)
        for layer in range(L):
            delta_layer(cfg, seed, name, layer, device, out=w[layer])
        out[name] = (w, delta_scales(cfg, seed, name, device))
    return out


def tenant_extras(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Each tenant's own dense embed ``(T, V, D)`` and head ``(T, D, V)``
    and fine-tuned norms (``final_norm (T, D)``, ``attn_norm`` and
    ``mlp_norm (L, T, D)``: 1 plus ``assumed.norm_jitter`` noise), bf16."""
    s, a = shapes(cfg), cfg["assumed"]
    t, v, d, L = a["tenants"], s["vocab"], s["hidden"], s["layers"]

    def normal(name, shape, mean, std):
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        return out.normal_(mean, std, generator=generator(
            device, seed, "extra", name))

    return {"embed": normal("embed", (t, v, d), 0.0, a["embed_std"]),
            "lm_head": normal("lm_head", (t, d, v), 0.0, a["weight_std"]),
            "final_norm": normal("final_norm", (t, d), 1.0, a["norm_jitter"]),
            "attn_norm": normal("attn_norm", (L, t, d), 1.0,
                                a["norm_jitter"]),
            "mlp_norm": normal("mlp_norm", (L, t, d), 1.0, a["norm_jitter"])}


def noise_layer(cfg: dict, seed: int, name: str, layer: int, device,
                out=None) -> torch.Tensor:
    """The fine-tune's change of one layer of ``name``, bf16, drawn
    N(0, (delta_ratio * std)^2)."""
    shape, std = leaf_specs(cfg)[name]
    w = out if out is not None else torch.empty(shape, dtype=torch.bfloat16,
                                                device=device)
    return w.normal_(0.0, cfg["assumed"]["delta_ratio"] * std,
                     generator=generator(device, seed, "noise", name, layer))


def dense_model_embed(cfg: dict, seed: int, device) -> torch.Tensor:
    """The dense model's embed ``(V, D)``, bf16."""
    s = shapes(cfg)
    return torch.empty((s["vocab"], s["hidden"]), dtype=torch.bfloat16,
                       device=device).normal_(
        0.0, cfg["assumed"]["embed_std"],
        generator=generator(device, seed, "dense", "embed"))


def dense_model_head(cfg: dict, seed: int, device) -> torch.Tensor:
    """The dense model's head ``(D, V)``, bf16."""
    s = shapes(cfg)
    return torch.empty((s["hidden"], s["vocab"]), dtype=torch.bfloat16,
                       device=device).normal_(
        0.0, cfg["assumed"]["weight_std"],
        generator=generator(device, seed, "dense", "lm_head"))


def dense_model(cfg: dict, seed: int, device):
    """A dense bf16 base with its own embed and head and unit norms, and
    its fine-tune: every projection plus :func:`noise_layer`, rounded to
    bf16 (embed, head and norms shared). Returns ``(base, finetune)`` as
    the port's params dicts ``{"embed", "lm_head", "final_norm",
    "layers": {...}}``."""
    s = shapes(cfg)
    L, d = s["layers"], s["hidden"]
    ones_l = torch.ones((L, d), dtype=torch.bfloat16, device=device)
    base = {"embed": dense_model_embed(cfg, seed, device),
            "lm_head": dense_model_head(cfg, seed, device),
            "final_norm": torch.ones((d,), dtype=torch.bfloat16,
                                     device=device),
            "layers": {"attn_norm": ones_l, "mlp_norm": ones_l}}
    fine = {**base, "layers": dict(base["layers"])}
    for name, leaf in base_leaves(cfg, seed, device).items():
        base["layers"][name] = leaf
        tuned = torch.empty_like(leaf)
        for layer in range(L):
            noise_layer(cfg, seed, name, layer, device, out=tuned[layer])
            tuned[layer].add_(leaf[layer])
        fine["layers"][name] = tuned
    return base, fine
