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

import json
import os
from typing import Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.hf_import import _EXPERTS, _LAYER_MAP, _MIXTRAL_LAYER_MAP
from ..models.mixtral import MixtralConfig

# Our layer names -> (HF sub-name, transposed?): the inverse of the
# import's maps. Mixtral's experts are ``{_EXPERTS}.{e}.w1|w2|w3``.
HF_NAMES = {ours: (hf, transpose)
            for hf, (ours, transpose) in _LAYER_MAP.items()}
HF_NAMES.update({ours: (hf, True) for hf, ours in _MIXTRAL_LAYER_MAP.items()
                 if ours not in HF_NAMES})
_EXPERT_NAMES = ("w1", "w2", "w3")


def _host(t: torch.Tensor, dtype, transpose: bool = False) -> torch.Tensor:
    """A ``dtype`` copy on the host (transposed on the device first)."""
    t = t.t() if transpose else t
    return t.detach().to(dtype).contiguous().cpu()


def hf_state_dict(cfg: ModelConfig, params,
                  dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The port's params (Llama / Mistral, or Mixtral with its router and
    experts) as HF tensor names and ``(out, in)`` layout, host tensors of
    ``dtype`` (fp32 by default, as JAX exports): the inverse of
    ``models/hf_import.py``. Layer tensors outside its maps (Qwen2's
    biases) are not written, as in JAX."""
    sd = {"model.embed_tokens.weight": _host(params["embed"], dtype),
          "model.norm.weight": _host(params["final_norm"], dtype)}
    if "lm_head" in params:
        sd["lm_head.weight"] = _host(params["lm_head"], dtype, True)
    layers = params["layers"]
    for l in range(cfg.num_layers):
        pre = f"model.layers.{l}"
        for ours, w in layers.items():
            if ours in _EXPERT_NAMES:
                for e in range(w.shape[1]):
                    sd[f"{pre}.{_EXPERTS}.{e}.{ours}.weight"] = _host(
                        w[l, e], dtype, True)
            elif ours in HF_NAMES:
                hf, transpose = HF_NAMES[ours]
                sd[f"{pre}.{hf}.weight"] = _host(w[l], dtype, transpose)
    return sd


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
    from .artifact import write_safetensors

    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"),
                      hf_state_dict(cfg, params), {"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    if tokenizer_src is not None:
        try:
            from ..utils.tokenizer import get_tokenizer
            get_tokenizer(tokenizer_src).save_pretrained(out_dir)
        except Exception as e:
            print(f"[export] tokenizer copy failed: {e}")
