"""Whole-model compression: fine-tune -> (1-bit deltas + uncompressed
extras). Port of ``bitdelta_tpu/core/compress.py``.

Every {q,k,v,o,gate,up,down}_proj becomes a 1-bit delta against the base;
norms stay uncompressed and carry the fine-tuned values, and so do the
embeddings and lm_head unless ``compress_embeddings=True`` makes them
1-bit deltas too. ``fuse_compressed`` turns a compressed model back into
dense params (the evaluation path).

Over a mesh (``mesh=``) the weights are this rank's shards
(``parallel/sharding.py``), as JAX's ``cli/train.py`` compresses its
sharded arrays: each rank packs its own shard's signs (a contiguous K or
N slice of the whole matrix's words), and each matrix's scale is the
whole matrix's ``mean |Δ|``: the shards' fp32 sums of ``|Δ|`` summed
over the model axis, over the whole count.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .delta import BinaryDelta, apply_delta, quantize_delta
from ..models.llama import PROJ_NAMES, Params

# Small per-layer tensors carried uncompressed with fine-tuned values
# (whichever exist): norms always; q/k/v biases for Qwen2-style models.
LAYER_EXTRA_NAMES = ("attn_norm", "mlp_norm", "q_bias", "k_bias", "v_bias")


class CompressedModel(NamedTuple):
    """deltas: proj name -> BinaryDelta with ``(L, K//32, N)`` packed and
    ``(L,)`` scales; with compressed embeddings also ``"embed"`` and,
    untied, ``"lm_head"``, each ``(D//32, V)`` with a 0-d scale. extras:
    fine-tuned ``final_norm``, per-layer norms (and biases) and, unless
    the embeddings are compressed, ``embed`` and ``lm_head``."""

    deltas: Dict[str, BinaryDelta]
    extras: Dict[str, Any]


def embedding_deltas(base_params: Params, finetuned_params: Params,
                     zero_sign: str = "positive", mesh=None
                     ) -> Dict[str, BinaryDelta]:
    """The 1-bit ``"embed"`` delta (quantized transposed, ``(V, D) ->
    (D, V)``, so it is packed along D, the unpack axis of both its uses)
    and, for an untied model, the ``"lm_head"`` delta. ``mesh``: both are
    vocab shards (``quantize_delta(mesh=)``)."""
    if finetuned_params["embed"].shape != base_params["embed"].shape:
        raise ValueError(
            "compress_embeddings requires the fine-tune to share the base "
            f"vocab/hidden: {tuple(finetuned_params['embed'].shape)} != "
            f"{tuple(base_params['embed'].shape)}")
    if ("lm_head" in finetuned_params) != ("lm_head" in base_params):
        raise ValueError("base and fine-tune disagree on tied lm_head")
    deltas = {"embed": quantize_delta(
        base_params["embed"].transpose(-1, -2),
        finetuned_params["embed"].transpose(-1, -2), zero_sign=zero_sign,
        mesh=mesh)}
    if "lm_head" in finetuned_params:
        deltas["lm_head"] = quantize_delta(base_params["lm_head"],
                                           finetuned_params["lm_head"],
                                           zero_sign=zero_sign, mesh=mesh)
    return deltas


def compress_model(base_params: Params, finetuned_params: Params, *,
                   compress_embeddings: bool = False,
                   zero_sign: str = "positive", mesh=None
                   ) -> CompressedModel:
    """Quantize every projection's ``finetune - base`` (and, with
    ``compress_embeddings``, the embed's and lm_head's).

    Layer by layer: the fp32 diff exists for one ``(K, N)`` matrix at a
    time, never for a whole ``(L, K, N)`` stack (7.5 GB for Mistral-7B's
    MLP), so a full-size fine-tune compresses next to its base on one
    card. Per layer it is the same computation as the JAX package's one
    stacked call (the scale is a per-matrix mean either way). The embed
    and head are one matrix each and quantize in one call.

    ``mesh``: the params are this rank's shards; so are the deltas and
    extras returned (every projection, the embed and the head are split
    over the model axis; ``quantize_delta(mesh=)``).
    """
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
                               zero_sign=zero_sign, mesh=mesh)
            packed[layer] = d.packed
            scale[layer] = d.scale
        deltas[name] = BinaryDelta(packed=packed, scale=scale)
    extras: Dict[str, Any] = {"final_norm": finetuned_params["final_norm"]}
    for name in LAYER_EXTRA_NAMES:
        if name in finetuned_params["layers"]:
            extras[name] = finetuned_params["layers"][name]
    if compress_embeddings:
        deltas.update(embedding_deltas(base_params, finetuned_params,
                                       zero_sign, mesh))
    else:
        extras["embed"] = finetuned_params["embed"]
        if "lm_head" in finetuned_params:
            extras["lm_head"] = finetuned_params["lm_head"]
    return CompressedModel(deltas=deltas, extras=extras)


def student_params(base_params: Params, compressed: CompressedModel
                   ) -> Params:
    """Params for the compressed model's forward: the base projection
    weights (the deltas ride on top through ``forward(deltas=...)``) with
    the fine-tuned extras overlaid. Tensors are shared, not copied."""
    params = dict(base_params)
    params["layers"] = dict(base_params["layers"])
    ex = compressed.extras
    params["final_norm"] = ex["final_norm"]
    for name in LAYER_EXTRA_NAMES:
        if name in ex:
            params["layers"][name] = ex[name]
    if "embed" in ex:
        params["embed"] = ex["embed"]
        if "lm_head" in ex:
            params["lm_head"] = ex["lm_head"]
        elif "lm_head" in params:
            del params["lm_head"]
    # Else compressed embeddings: the base embed / lm_head stay, and the
    # deltas' "embed" / "lm_head" entries ride on top in the forward.
    return params


def _fuse_by_layer(w: torch.Tensor, delta: BinaryDelta) -> torch.Tensor:
    """:func:`apply_delta` of a layer-stacked delta one layer at a time
    into a preallocated output (the fp32 transients stay one layer's)."""
    out = torch.empty_like(w)
    for layer in range(w.shape[0]):
        out[layer] = apply_delta(w[layer], BinaryDelta(delta.packed[layer],
                                                       delta.scale[layer]))
    return out


def fuse_compressed(base_params: Params, compressed: CompressedModel
                    ) -> Params:
    """Dense fusion for evaluation: ``W_base + scale * sign`` materialized
    into ordinary params (the reference's dense ``load_diff`` path, so
    perplexity isolates the quantization error). The embed delta is
    packed against ``embed.T`` and fused transposed."""
    params = student_params(base_params, compressed)
    params["layers"] = dict(params["layers"])
    for name, delta in compressed.deltas.items():
        if name == "embed":
            fused_t = apply_delta(base_params["embed"].transpose(-1, -2),
                                  delta)
            params["embed"] = fused_t.transpose(-1, -2).contiguous()
        elif name == "lm_head":
            params["lm_head"] = apply_delta(base_params["lm_head"], delta)
        else:
            params["layers"][name] = _fuse_by_layer(
                base_params["layers"][name], delta)
    return params


def with_scales(compressed: CompressedModel,
                scales: Dict[str, torch.Tensor]) -> CompressedModel:
    """Rebuild with distilled scales (proj name -> ``(L,)``), detached and
    in fp32."""
    deltas = {name: BinaryDelta(packed=compressed.deltas[name].packed,
                                scale=scales[name].detach().to(
                                    torch.float32))
              for name in compressed.deltas}
    return CompressedModel(deltas=deltas, extras=compressed.extras)


def get_scales(compressed: CompressedModel) -> Dict[str, torch.Tensor]:
    return {name: d.scale for name, d in compressed.deltas.items()}


def _leaves(tree):
    """Every tensor of nested dicts / tuples / lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def compressed_nbytes(compressed: CompressedModel) -> int:
    """Bytes of every tensor of a compressed model (deltas and extras)."""
    return _nbytes(compressed)


def delta_compression_stats(base_params: Params,
                            compressed: CompressedModel) -> Dict[str, float]:
    """The reference's compression accounting: the dense fine-tune's bytes
    (every base tensor at 2 bytes, bf16) against the delta artifact's
    (packed signs + scales + uncompressed extras)."""
    dense = sum(t.numel() * 2 for t in _leaves(base_params))
    packed = sum(d.packed.numel() * 4 + d.scale.numel() * 4
                 for d in compressed.deltas.values())
    extras = _nbytes(compressed.extras)
    return {"dense_bytes": float(dense),
            "delta_bytes": float(packed + extras),
            "packed_bytes": float(packed),
            "extras_bytes": float(extras),
            "ratio": dense / (packed + extras)}
