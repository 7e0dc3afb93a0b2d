"""Full-model export to the HF format (port of
``bitdelta_tpu/core/export.py``): the compressed model, fused densely, as
an ordinary HF checkpoint (``model.safetensors`` + ``config.json`` + the
tokenizer, where one loads) for external evaluation harnesses.

Tensors are written in fp32 and the config says ``torch_dtype:
float32``, as JAX writes them; the file is written by the port's own
safetensors writer (``core/artifact.py``), so no ``safetensors`` package
is needed.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.hf_import import _EXPERTS, _LAYER_MAP, _MIXTRAL_LAYER_MAP
from ..models.mixtral import MixtralConfig
from .artifact import Deferred

# Our layer names -> (HF sub-name, transposed?): the inverse of the
# import's maps. Mixtral's experts are ``{_EXPERTS}.{e}.w1|w2|w3``.
HF_NAMES = {ours: (hf, transpose)
            for hf, (ours, transpose) in _LAYER_MAP.items()}
HF_NAMES.update({ours: (hf, True) for hf, ours in _MIXTRAL_LAYER_MAP.items()
                 if ours not in HF_NAMES})
_EXPERT_NAMES = ("w1", "w2", "w3")


class Lazy(NamedTuple):
    """A params leaf read only when :func:`save_full_model` writes it: its
    shape in the port's layout (a layer leaf's layer axis first) and
    ``read(*index)``, the tensor at ``index`` (a layer; nothing for the
    embed, the head and the final norm)."""

    shape: Tuple[int, ...]
    read: Callable[..., torch.Tensor]


def _host(t: torch.Tensor, dtype, transpose: bool = False) -> torch.Tensor:
    """A ``dtype`` copy on the host (transposed on the device first)."""
    t = t.t() if transpose else t
    return t.detach().to(dtype).contiguous().cpu()


def _hf_entries(cfg: ModelConfig, params, dtype) -> Dict[str, Deferred]:
    """:func:`hf_state_dict`'s tensors as :class:`Deferred` ones, each
    made from its params leaf (a tensor, or a :class:`Lazy` one) only as
    it is written."""
    def entry(w, index=(), transpose=False):
        shape = tuple(w.shape[len(index):])
        part = (functools.partial(w.read, *index) if isinstance(w, Lazy)
                else functools.partial(w.__getitem__, index))
        return Deferred(dtype, shape[::-1] if transpose else shape,
                        lambda: _host(part(), dtype, transpose))

    sd = {"model.embed_tokens.weight": entry(params["embed"]),
          "model.norm.weight": entry(params["final_norm"])}
    if "lm_head" in params:
        sd["lm_head.weight"] = entry(params["lm_head"], transpose=True)
    layers = params["layers"]
    for l in range(cfg.num_layers):
        pre = f"model.layers.{l}"
        for ours, w in layers.items():
            if ours in _EXPERT_NAMES:
                for e in range(w.shape[1]):
                    sd[f"{pre}.{_EXPERTS}.{e}.{ours}.weight"] = entry(
                        w, (l, e), True)
            elif ours in HF_NAMES:
                hf, transpose = HF_NAMES[ours]
                sd[f"{pre}.{hf}.weight"] = entry(w, (l,), transpose)
    return sd


def hf_state_dict(cfg: ModelConfig, params,
                  dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The port's params (Llama / Mistral, or Mixtral with its router and
    experts) as HF tensor names and ``(out, in)`` layout, host tensors of
    ``dtype`` (fp32 by default, as JAX exports): the inverse of
    ``models/hf_import.py``. Layer tensors outside its maps (Qwen2's
    biases) are not written, as in JAX."""
    return {k: d.make() for k, d in _hf_entries(cfg, params, dtype).items()}


def hf_config_dict(cfg: ModelConfig, model_type: str = "llama",
                   dtype=torch.float32) -> dict:
    """``config.json`` for ``cfg``: Llama, Mistral where a sliding window
    is set (as JAX writes them), Mixtral for a :class:`MixtralConfig`;
    ``torch_dtype`` names ``dtype``."""
    d = {
        "architectures": ["LlamaForCausalLM" if model_type == "llama"
                          else "MistralForCausalLM"],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "hidden_act": "silu",
        "torch_dtype": str(dtype).removeprefix("torch."),
    }
    if cfg.sliding_window is not None:
        d["sliding_window"] = cfg.sliding_window
        d["model_type"] = "mistral"
        d["architectures"] = ["MistralForCausalLM"]
    if isinstance(cfg, MixtralConfig):
        d.update(model_type="mixtral", architectures=["MixtralForCausalLM"],
                 num_local_experts=cfg.num_experts,
                 num_experts_per_tok=cfg.experts_per_token)
    return d


def save_full_model(cfg: ModelConfig, params, out_dir: str,
                    tokenizer_src: Optional[str] = None) -> None:
    """``params`` as an HF checkpoint in fp32, written one tensor at a
    time (each made from its leaf only as it is written). A leaf may be
    :class:`Lazy` (:func:`fused_checkpoint`)."""
    _write_model(cfg, _hf_entries(cfg, params, torch.float32), out_dir,
                 tokenizer_src)


def fused_checkpoint(cfg: ModelConfig, ckpt_dir: str, compressed,
                     dtype=torch.bfloat16, base_quant: Optional[str] = None,
                     device="cpu"):
    """``fuse_compressed(base, compressed)`` with :class:`Lazy` leaves,
    where ``base`` is ``load_hf_params(ckpt_dir, dtype=dtype)`` (round-
    tripped through ``base_quant`` where given): each of the base's
    tensors is read from the checkpoint on ``device`` and fused only when
    :func:`save_full_model` writes it, so the base is never whole.
    Llama-family models (the train CLI exports no Mixtral)."""
    from ..models.hf_import import checkpoint_index, read_layer
    from ..research.quantized_base import roundtrip_matrix
    from .compress import LAYER_EXTRA_NAMES
    from .delta import BinaryDelta, apply_delta

    index = checkpoint_index(ckpt_dir)
    deltas, extras = compressed.deltas, compressed.extras

    def on(d):
        return BinaryDelta(*(f.to(device) for f in d))

    def top(key):
        return index[key].read().to(device).to(dtype)

    def embed():
        w = top("model.embed_tokens.weight")
        if "embed" in deltas:
            w = apply_delta(w.t(), on(deltas["embed"])).t()
        return w

    def lm_head():
        w = top("lm_head.weight").t()
        if "lm_head" in deltas:
            w = apply_delta(w, on(deltas["lm_head"]))
        return w

    def layer(name, l):
        w = read_layer(index, cfg, name, l, dtype, device)
        if base_quant is not None and name not in LAYER_EXTRA_NAMES:
            w = roundtrip_matrix(w, base_quant, dtype)
        if name in deltas:
            d = deltas[name]
            w = apply_delta(w, on(BinaryDelta(d.packed[l], d.scale[l])))
        return w

    params = {"final_norm": extras["final_norm"], "layers": {}}
    if "embed" in extras:
        params["embed"] = extras["embed"]
    else:
        params["embed"] = Lazy(
            tuple(index["model.embed_tokens.weight"].shape), embed)
    if "lm_head" in extras:
        params["lm_head"] = extras["lm_head"]
    elif "embed" not in extras and "lm_head.weight" in index:
        params["lm_head"] = Lazy(
            tuple(index["lm_head.weight"].shape)[::-1], lm_head)
    for name, (hf, transpose) in HF_NAMES.items():
        shape = getattr(index.get(f"model.layers.0.{hf}.weight"), "shape",
                        None)
        if name in extras:
            params["layers"][name] = extras[name]
        elif shape is not None and name not in _EXPERT_NAMES:
            params["layers"][name] = Lazy(
                (cfg.num_layers, *(shape[::-1] if transpose else shape)),
                functools.partial(layer, name))
    return params


def _write_model(cfg, sd, out_dir, tokenizer_src) -> None:
    from .artifact import write_safetensors

    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), sd,
                      {"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    if tokenizer_src is not None:
        try:
            from ..utils.tokenizer import get_tokenizer
            get_tokenizer(tokenizer_src).save_pretrained(out_dir)
        except Exception as e:
            print(f"[export] tokenizer copy failed: {e}")
