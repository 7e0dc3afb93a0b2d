"""Whole-model compression: fine-tune -> (1-bit deltas + uncompressed
extras). Port of ``bitdelta_tpu/core/compress.py``.

Every {q,k,v,o,gate,up,down}_proj becomes a 1-bit delta against the base;
embeddings, lm_head and norms stay uncompressed and carry the fine-tuned
values.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .delta import BinaryDelta, quantize_delta
from ..models.llama import PROJ_NAMES, Params

# Small per-layer tensors carried uncompressed with fine-tuned values
# (whichever exist): norms always; q/k/v biases for Qwen2-style models.
LAYER_EXTRA_NAMES = ("attn_norm", "mlp_norm", "q_bias", "k_bias", "v_bias")


class CompressedModel(NamedTuple):
    """deltas: proj name -> BinaryDelta with ``(L, K//32, N)`` packed and
    ``(L,)`` scales. extras: fine-tuned ``final_norm``, per-layer norms
    (and biases), ``embed`` and ``lm_head``."""

    deltas: Dict[str, BinaryDelta]
    extras: Dict[str, Any]


def compress_model(base_params: Params, finetuned_params: Params, *,
                   compress_embeddings: bool = False,
                   zero_sign: str = "positive") -> CompressedModel:
    """Quantize every projection's ``finetune - base``.

    Layer by layer: the fp32 diff exists for one ``(K, N)`` matrix at a
    time, never for a whole ``(L, K, N)`` stack (7.5 GB for Mistral-7B's
    MLP), so a full-size fine-tune compresses next to its base on one
    card. Per layer it is the same computation as the JAX package's one
    stacked call (the scale is a per-matrix mean either way).
    """
    if compress_embeddings:
        raise NotImplementedError(
            "compress_embeddings is not ported yet (see ROADMAP.md)")
    deltas = {}
    for name in PROJ_NAMES:
        base_w = base_params["layers"][name]
        fine_w = finetuned_params["layers"][name]
        n_layers, k, n = base_w.shape
        packed = torch.empty((n_layers, k // 32, n), dtype=torch.int32,
                             device=base_w.device)
        scale = torch.empty((n_layers,), dtype=torch.float32,
                            device=base_w.device)
        for layer in range(n_layers):
            d = quantize_delta(base_w[layer], fine_w[layer],
                               zero_sign=zero_sign)
            packed[layer] = d.packed
            scale[layer] = d.scale
        deltas[name] = BinaryDelta(packed=packed, scale=scale)
    extras: Dict[str, Any] = {"final_norm": finetuned_params["final_norm"]}
    for name in LAYER_EXTRA_NAMES:
        if name in finetuned_params["layers"]:
            extras[name] = finetuned_params["layers"][name]
    extras["embed"] = finetuned_params["embed"]
    if "lm_head" in finetuned_params:
        extras["lm_head"] = finetuned_params["lm_head"]
    return CompressedModel(deltas=deltas, extras=extras)

