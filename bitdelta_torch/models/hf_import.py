"""Import HuggingFace Llama/Mistral/Qwen2 and Mixtral checkpoints into the
port's params (port of ``bitdelta_tpu/models/hf_import.py``).

Matrices take the port's ``(K_in, N_out)`` layout, stacked on a leading
layer axis: ``(L, K, N)``, Mixtral experts ``(L, E, K, N)``. Each stacked
tensor is allocated on ``device`` once and every layer is copied into its
slot as it is read: HF's ``(out, in)`` matrix goes to the device as
stored and is transposed there (``slot.copy_(w.t())``), so no whole state
dict and no transposed copy is ever built on the host. Norms and biases
are not transposed; ``lm_head`` becomes ``(D, V)`` and is absent when the
embeddings are tied.

Entry points:
  * :func:`params_from_state_dict` / :func:`mixtral_params_from_state_dict`
    from a mapping of numpy arrays or torch tensors;
  * :func:`load_hf_params` from a local checkpoint directory (every
    ``*.safetensors`` shard in sorted order, read through memory maps by
    ``core/artifact.py::iter_safetensors``; no ``safetensors`` or
    ``transformers`` package needed); with ``mesh=`` a rank's blocks
    alone, each read from its file (``core/artifact.py::StoredTensor``);
  * :func:`params_from_torch_model` from a live transformers model.

Every entry point puts the params on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from .config import ModelConfig

_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.(.+)\.(weight|bias)")

# HF sub-name -> (our name, transpose?): the one place the port names HF's
# layer tensors (core/export.py and models/quant_import.py derive theirs).
_LAYER_MAP = {
    "self_attn.q_proj": ("q_proj", True),
    "self_attn.k_proj": ("k_proj", True),
    "self_attn.v_proj": ("v_proj", True),
    "self_attn.o_proj": ("o_proj", True),
    "mlp.gate_proj": ("gate_proj", True),
    "mlp.up_proj": ("up_proj", True),
    "mlp.down_proj": ("down_proj", True),
    "input_layernorm": ("attn_norm", False),
    "post_attention_layernorm": ("mlp_norm", False),
}

# Qwen2-style attention biases (1-D, no transpose).
_BIAS_MAP = {
    "self_attn.q_proj": "q_bias",
    "self_attn.k_proj": "k_bias",
    "self_attn.v_proj": "v_bias",
}

# Mixtral: the attention and norms of _LAYER_MAP, the MoE block's router
# and experts (``{_EXPERTS}.{e}.w1|w2|w3``) in place of its mlp.
_EXPERTS = "block_sparse_moe.experts"
_MIXTRAL_EXPERT_RE = re.compile(
    rf"model\.layers\.(\d+)\.{re.escape(_EXPERTS)}\.(\d+)\.(w[123])"
    r"\.weight")
_MIXTRAL_LAYER_MAP = {hf: ours for hf, (ours, _) in _LAYER_MAP.items()
                      if hf.startswith("self_attn.")}
_MIXTRAL_LAYER_MAP["block_sparse_moe.gate"] = "router"
_MIXTRAL_LAYER_MAP.update({hf: ours for hf, (ours, transpose)
                           in _LAYER_MAP.items() if not transpose})
_NORMS = ("attn_norm", "mlp_norm")


def _as_tensor(val) -> torch.Tensor:
    return val if isinstance(val, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(val))


class _Stacker:
    """Stacked params filled one tensor at a time. A stacked leaf is
    allocated on the device at its first slot's arrival (its shape the
    slot's, behind ``lead`` stack dims); every slot is then copied in,
    transposed on the device where asked.

    With ``specs`` (``parallel/sharding.py::param_specs``) the values are
    ``StoredTensor``s and each is read as this rank's block of ``mesh``
    alone: its leaf's spec without the stack dims, reversed where HF
    stores the matrix transposed."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 specs=None, mesh=None):
        self.device, self.dtype = device, dtype
        self.specs, self.mesh = specs, mesh
        self.stacks: Dict[str, torch.Tensor] = {}
        self.filled: Dict[str, np.ndarray] = {}
        self.top: Dict[str, torch.Tensor] = {}

    def _dev(self, val, transpose: bool, spec=()) -> torch.Tensor:
        if self.specs is not None:
            from ..parallel.sharding import block_of

            spec = tuple(spec) + (None,) * (len(val.shape) - len(spec))
            val = val.read(block_of(val.shape,
                                    spec[::-1] if transpose else spec,
                                    self.mesh),
                           meta=self.device.type == "meta")
        t = _as_tensor(val).to(self.device)
        return t.t() if transpose else t

    def _spec(self, name: str, n_lead: int):
        if self.specs is None:
            return ()
        if n_lead == 0:
            return self.specs.get(name, ())
        return self.specs["layers"].get(name, ())[n_lead:]

    def put(self, name: str, lead: Tuple[int, ...], index: Tuple[int, ...],
            val, transpose: bool) -> None:
        src = self._dev(val, transpose, self._spec(name, len(lead)))
        if name not in self.stacks:
            self.stacks[name] = torch.empty(lead + tuple(src.shape),
                                            dtype=self.dtype,
                                            device=self.device)
            self.filled[name] = np.zeros(lead, bool)
        self.stacks[name][index].copy_(src)
        self.filled[name][index] = True

    def put_top(self, name: str, val, transpose: bool = False) -> None:
        self.top[name] = self._dev(val, transpose, self._spec(name, 0)).to(
            self.dtype).contiguous()

    def layers(self, names: Iterable[str]) -> Dict[str, torch.Tensor]:
        out = {}
        for name in names:
            if name not in self.stacks:
                raise ValueError(f"missing {name} for every layer")
            missing = np.argwhere(~self.filled[name])
            if len(missing):
                where = sorted({int(m[0]) for m in missing})
                raise ValueError(f"missing {name} for layers {where}")
            out[name] = self.stacks[name]
        return out


def _finish(cfg: ModelConfig, st: _Stacker, layer_names) -> dict:
    for name in ("embed", "final_norm"):
        if name not in st.top:
            raise ValueError(f"checkpoint has no {name}")
    params = {"embed": st.top["embed"], "final_norm": st.top["final_norm"],
              "layers": st.layers(layer_names)}
    if "lm_head" in st.top:
        params["lm_head"] = st.top["lm_head"]
    elif not cfg.tie_word_embeddings:
        raise ValueError("checkpoint has no lm_head but embeddings not tied")
    return params


def _top_level(st: _Stacker, key: str, val) -> bool:
    """Embeddings, final norm and lm_head; True when ``key`` was one."""
    if key == "model.embed_tokens.weight":
        st.put_top("embed", val)                 # (V, D) stays (row lookup)
    elif key == "model.norm.weight":
        st.put_top("final_norm", val)
    elif key == "lm_head.weight":
        st.put_top("lm_head", val, transpose=True)   # (V, D) -> (D, V)
    else:
        return False
    return True


def params_from_state_dict(cfg: ModelConfig,
                           tensors: Iterable[Tuple[str, object]] | Mapping,
                           dtype=torch.bfloat16, device="cuda") -> dict:
    """An HF-style llama-family state dict (a mapping, or ``(name,
    tensor)`` pairs; numpy arrays or torch tensors) as the port's params
    on ``device`` in ``dtype``. Unknown layer tensors and missing ones
    raise ``ValueError``; keys outside the layers that are not embed /
    norm / head (rotary buffers) are skipped."""
    return _llama_params(cfg, tensors, _Stacker(resolve_device(device),
                                                torch_dtype(dtype)))


def _llama_params(cfg: ModelConfig, tensors, st: _Stacker) -> dict:
    L = cfg.num_layers
    items = tensors.items() if isinstance(tensors, Mapping) else tensors
    for key, val in items:
        if _top_level(st, key, val):
            continue
        m = _LAYER_RE.fullmatch(key)
        if not m:
            continue  # rotary inv_freq buffers etc.
        idx, sub, kind = int(m.group(1)), m.group(2), m.group(3)
        if idx >= L:
            raise ValueError(f"layer {idx} of {key} past num_layers {L}")
        if kind == "bias":
            if sub not in _BIAS_MAP:
                raise ValueError(f"unrecognized layer bias: {key}")
            if cfg.attention_bias:
                st.put(_BIAS_MAP[sub], (L,), (idx,), val, False)
            continue
        if sub not in _LAYER_MAP:
            raise ValueError(f"unrecognized layer tensor: {key}")
        name, transpose = _LAYER_MAP[sub]
        st.put(name, (L,), (idx,), val, transpose)
    names = [name for name, _ in _LAYER_MAP.values()]
    if cfg.attention_bias:
        names += list(_BIAS_MAP.values())
    return _finish(cfg, st, names)


def mixtral_params_from_state_dict(cfg, tensors, dtype=torch.bfloat16,
                                   device="cuda") -> dict:
    """A Mixtral state dict as the port's params: experts stacked ``(L, E,
    K, N)``, the router ``(L, D, E)``."""
    return _mixtral_params(cfg, tensors, _Stacker(resolve_device(device),
                                                  torch_dtype(dtype)))


def _mixtral_params(cfg, tensors, st: _Stacker) -> dict:
    L, E = cfg.num_layers, cfg.num_experts
    items = tensors.items() if isinstance(tensors, Mapping) else tensors
    for key, val in items:
        if _top_level(st, key, val):
            continue
        m = _MIXTRAL_EXPERT_RE.fullmatch(key)
        if m:
            layer, expert = int(m.group(1)), int(m.group(2))
            if layer >= L or expert >= E:
                raise ValueError(f"{key} past ({L} layers, {E} experts)")
            st.put(m.group(3), (L, E), (layer, expert), val, True)
            continue
        m = _LAYER_RE.fullmatch(key)
        if not m:
            continue
        sub, kind = m.group(2), m.group(3)
        if kind != "weight" or sub not in _MIXTRAL_LAYER_MAP:
            raise ValueError(f"unrecognized mixtral tensor: {key}")
        layer = int(m.group(1))
        if layer >= L:
            raise ValueError(f"layer {layer} of {key} past num_layers {L}")
        name = _MIXTRAL_LAYER_MAP[sub]
        st.put(name, (L,), (layer,), val, name not in _NORMS)
    return _finish(cfg, st,
                   list(_MIXTRAL_LAYER_MAP.values()) + ["w1", "w2", "w3"])


def _shard_files(ckpt_dir: str):
    files = sorted(f for f in os.listdir(ckpt_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {ckpt_dir}")
    return [os.path.join(ckpt_dir, f) for f in files]


def _iter_safetensors(ckpt_dir: str):
    """``(name, CPU tensor)`` of every ``*.safetensors`` shard of a
    directory, the shards in sorted order."""
    from ..core.artifact import iter_safetensors

    for path in _shard_files(ckpt_dir):
        yield from iter_safetensors(path)


def checkpoint_index(ckpt_dir: str):
    """``{name: StoredTensor}`` of every tensor of every ``*.safetensors``
    shard of a directory, from the headers alone
    (``core/artifact.py::stored_tensors``): any tensor can then be read
    whole, or a block of it, on its own."""
    from ..core.artifact import stored_tensors

    return {name: t for path in _shard_files(ckpt_dir)
            for name, t in stored_tensors(path)}


class _Obj:
    def __init__(self, d):
        self.__dict__.update(d)


def load_hf_config(ckpt_dir: str) -> ModelConfig:
    """``config.json`` of a checkpoint directory as a ``ModelConfig``
    (``MixtralConfig`` for ``model_type: "mixtral"``)."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        raw = json.load(f)
    if raw.get("model_type") == "mixtral":
        from .mixtral import MixtralConfig

        return MixtralConfig.from_hf_config(_Obj(raw))
    return ModelConfig.from_hf_config(_Obj(raw))


def load_hf_params(ckpt_dir: str, cfg: Optional[ModelConfig] = None,
                   dtype=torch.bfloat16, device="cuda", mesh=None):
    """Load a local HF checkpoint directory into ``(config, params)`` on
    ``device``. Routes by ``model_type``: Llama/Mistral/Qwen2 share the
    llama layout; Mixtral gets expert-stacked MoE params.

    ``mesh``: this rank's shards alone, ``shard_tree(params,
    param_specs(cfg), mesh)`` of the whole, bit for bit: each tensor's
    block is read straight from its file (``StoredTensor.read``; a
    column-parallel projection's block is a run of HF's rows, a
    row-parallel one's a column block of every row, the vocab-sharded
    embed and head runs of rows), cast to ``dtype`` and transposed on
    ``device`` as the whole path does; the host holds one block at a
    time. ``device="meta"``: the whole params' shapes and dtypes from the
    headers, nothing read."""
    from ..parallel.sharding import param_specs
    from .mixtral import MixtralConfig

    cfg = cfg or load_hf_config(ckpt_dir)
    device, dtype = resolve_device(device), torch_dtype(dtype)
    if mesh is None and device.type != "meta":
        tensors = _iter_safetensors(ckpt_dir)
        st = _Stacker(device, dtype)
    else:
        tensors = checkpoint_index(ckpt_dir).items()
        st = _Stacker(device, dtype, param_specs(cfg), mesh)
    if isinstance(cfg, MixtralConfig):
        return cfg, _mixtral_params(cfg, tensors, st)
    return cfg, _llama_params(cfg, tensors, st)


def read_layer(index, cfg: ModelConfig, name: str, layer: int,
               dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """One layer's slot of the port's leaf ``name`` (``(K, N)``; a
    Mixtral expert stack ``(E, K, N)``) read whole from a checkpoint's
    ``index`` (:func:`checkpoint_index`), as :func:`load_hf_params` fills
    it: the HF tensor on ``device``, transposed there, cast to
    ``dtype``."""
    device, dtype = resolve_device(device), torch_dtype(dtype)

    def read(key, transpose):
        t = index[key].read().to(device)
        return (t.t() if transpose else t).to(dtype)
    pre = f"model.layers.{layer}"
    if name in ("w1", "w2", "w3"):
        return torch.stack([read(f"{pre}.{_EXPERTS}.{e}.{name}.weight", True)
                            for e in range(cfg.num_experts)])
    hf = {ours: (sub, transpose) for sub, (ours, transpose)
          in _LAYER_MAP.items()}
    hf.update({ours: (sub, ours not in _NORMS)
               for sub, ours in _MIXTRAL_LAYER_MAP.items()})
    sub, transpose = hf[name]
    return read(f"{pre}.{sub}.weight", transpose)


def params_from_torch_model(cfg: ModelConfig, torch_model,
                            dtype=torch.float32, device="cuda") -> dict:
    """Convert a live llama-family transformers model (tests) to the
    port's params. Tied-embedding models may leave ``lm_head`` out of the
    state dict."""
    sd = ((k, v.detach().float())
          for k, v in torch_model.state_dict().items())
    return params_from_state_dict(cfg, sd, dtype, device)
