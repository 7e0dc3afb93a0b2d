"""Import pre-quantized layers (AutoGPTQ int4, bitsandbytes int8); port
of ``bitdelta_tpu/models/quant_import.py`` in numpy and torch.

The reference dequantizes such layers back to fp16 so BitDelta can ride
on top (``deq = (q - zero) * scale`` per K group with the legacy
``zeros + 1`` offset; int8 ``CB * SCB / 127``). Beyond that:

* the GPTQ nibble layout (8 4-bit values per int32, LSB-first along the
  input dimension) is the :class:`Int4Weight` word layout, and a
  symmetric layer (every zero point 8) maps onto it losslessly by one
  XOR with 0x88888888 (unsigned nibble ``q`` -> two's-complement
  ``q - 8``), so an imported base serves through the W4 path without
  dense weights;
* asymmetric or act-order (``g_idx``) layers dequantize to dense, which
  is what the reference does for every checkpoint.

GPTQ stores ``(K_in, N_out)``, the port's layout, so imports need no
transpose. :func:`load_gptq_params` loads a whole checkpoint directory.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from .config import ModelConfig
from .hf_import import _LAYER_MAP, _iter_safetensors, load_hf_config
from ..research.quantized_base import INT4_GROUP, Int4Weight, Int8Weight

_SYM_NIBBLES = np.uint32(0x77777777)   # zero-point nibble 7 => zero == 8
_SYM_NIBBLES_V2 = np.uint32(0x88888888)  # gptq_v2 stores zeros unshifted
_SIGN_FLIP = np.uint32(0x88888888)     # unsigned nibble -> two's-complement


def unpack_gptq_nibbles(packed: np.ndarray, axis: int = 0) -> np.ndarray:
    """Unpack int32 words into unsigned 4-bit values ``[0, 15]`` along
    ``axis`` (LSB-first)."""
    u = np.ascontiguousarray(packed).view(np.uint32)
    shifts = np.arange(8, dtype=np.uint32) * 4
    nib = (u[..., None] >> shifts).astype(np.uint32) & 0xF
    # (..., W, ..., 8) -> interleave the nibble axis right after `axis`.
    nib = np.moveaxis(nib, -1, axis + 1)
    out_shape = list(packed.shape)
    out_shape[axis] *= 8
    return nib.reshape(out_shape).astype(np.int32)


def dequantize_gptq(qweight: np.ndarray, qzeros: np.ndarray,
                    scales: np.ndarray,
                    g_idx: Optional[np.ndarray] = None,
                    checkpoint_format: str = "gptq") -> np.ndarray:
    """Dense fp32 ``(K, N)`` from GPTQ arrays: ``(q - zero) * scale``.

    qweight ``(K//8, N)`` int32; qzeros ``(G, N//8)`` int32; scales
    ``(G, N)``; g_idx ``(K,)`` optional group index per input row
    (act-order checkpoints), contiguous groups by default.
    ``checkpoint_format``: ``"gptq"`` (legacy, zeros stored shifted by
    -1) or ``"gptq_v2"`` (zeros stored unshifted)."""
    if checkpoint_format not in ("gptq", "gptq_v2"):
        raise ValueError(f"unknown checkpoint_format {checkpoint_format!r}")
    q = unpack_gptq_nibbles(qweight, axis=0)            # (K, N)
    z = unpack_gptq_nibbles(qzeros, axis=1)             # (G, N)
    if checkpoint_format == "gptq":
        z = z + 1                                       # legacy offset
    k = q.shape[0]
    if g_idx is None:
        if k % scales.shape[0]:
            raise ValueError(
                f"K={k} does not divide into {scales.shape[0]} groups; "
                f"an act-order checkpoint must supply g_idx explicitly")
        g_idx = np.arange(k) // (k // scales.shape[0])
    g_idx = np.asarray(g_idx, np.int64)
    s = scales.astype(np.float32)[g_idx]                # (K, N)
    return (q - z[g_idx]).astype(np.float32) * s


def gptq_is_symmetric(qzeros: np.ndarray,
                      g_idx: Optional[np.ndarray] = None,
                      k: Optional[int] = None,
                      checkpoint_format: str = "gptq") -> bool:
    """True when the layer maps losslessly onto :class:`Int4Weight`:
    every zero point is 8 (nibble 7 in the legacy shifted format, 8 in
    gptq_v2) and the group assignment is the contiguous one."""
    want = _SYM_NIBBLES if checkpoint_format == "gptq" else _SYM_NIBBLES_V2
    if not np.all(np.ascontiguousarray(qzeros).view(np.uint32) == want):
        return False
    if g_idx is not None and k is not None:
        groups = qzeros.shape[0]
        if k % groups or not np.array_equal(
                np.asarray(g_idx), np.arange(k) // (k // groups)):
            return False
    return True


def int4_from_gptq(qweight: np.ndarray, qzeros: np.ndarray,
                   scales: np.ndarray,
                   g_idx: Optional[np.ndarray] = None,
                   checkpoint_format: str = "gptq",
                   device="cuda") -> Int4Weight:
    """Lossless :class:`Int4Weight` on ``device`` from a symmetric GPTQ
    layer: the words up to the unsigned -> two's-complement XOR; the
    scales pass through (any group size dividing K; ``int4_matmul``
    derives the group from the scale's shape)."""
    device = resolve_device(device)
    if not gptq_is_symmetric(qzeros, g_idx, qweight.shape[0] * 8,
                             checkpoint_format):
        raise ValueError(
            "asymmetric or act-order GPTQ layer: no lossless Int4Weight "
            "mapping — use dequantize_gptq (dense), as the reference "
            "does for every checkpoint")
    packed = (np.ascontiguousarray(qweight).view(np.uint32)
              ^ _SIGN_FLIP).view(np.int32)
    return Int4Weight(
        packed=torch.from_numpy(packed.copy()).to(device),
        scale=torch.from_numpy(np.asarray(scales, np.float32)).to(device))


def int8_from_bnb(cb: np.ndarray, scb: np.ndarray,
                  device="cuda") -> Int8Weight:
    """:class:`Int8Weight` on ``device`` from bitsandbytes
    ``Linear8bitLt`` state: weight = ``CB * SCB[:, None] / 127`` in
    torch's ``(out, in)`` layout -> ``(K, N)`` with a per-column scale."""
    device = resolve_device(device)
    q = torch.from_numpy(np.ascontiguousarray(cb.T).copy())
    scale = torch.from_numpy(np.asarray(scb, np.float32) / np.float32(127.0))
    return Int8Weight(q=q.to(device), scale=scale.to(device))


# HF sub-name -> our name, for the seven projections (the transposed
# matrices of the dense import's map).
_PROJ_SUBS = {hf: ours for hf, (ours, transpose) in _LAYER_MAP.items()
              if transpose}


def _checkpoint_format(ckpt_dir: str) -> str:
    """``checkpoint_format`` of ``quantize_config.json``: gptqmodel writes
    ``"gptq_v2"`` (zeros unshifted); the legacy AutoGPTQ format ``"gptq"``
    (the default) shifts them by -1."""
    path = os.path.join(ckpt_dir, "quantize_config.json")
    fmt = "gptq"
    if os.path.exists(path):
        with open(path) as f:
            fmt = json.load(f).get("checkpoint_format", "gptq")
    if fmt not in ("gptq", "gptq_v2"):
        raise ValueError(f"unsupported GPTQ checkpoint_format {fmt!r} "
                         f"in {path}")
    return fmt


def _w4_native(k: int, n_groups: int, device: torch.device) -> bool:
    """Whether a symmetric projection of ``n_groups`` scale groups over
    ``k`` rows keeps its packed words on ``device``. On the card only at
    the W4 kernel's 128-row groups: ``llama._base_matmul`` sends the
    kernel nothing else, so another group would decode in plain PyTorch.
    On the CPU at any group dividing ``k``, as JAX's importer."""
    return device.type != "cuda" or n_groups * INT4_GROUP == k


def load_gptq_params(ckpt_dir: str, cfg: Optional[ModelConfig] = None,
                     dtype=torch.bfloat16, native: bool = True,
                     device="cuda") -> Tuple[ModelConfig, Dict]:
    """Load an AutoGPTQ-format llama-family checkpoint directory into the
    port's params on ``device``.

    A projection whose layers are all symmetric (and not act-order)
    becomes a stacked :class:`Int4Weight` (``packed (L, K//8, N)``,
    ``scale (L, G, N)``) when ``native=True``, served through the W4 path
    with no dequantization error. On the CPU its scales pass through
    whatever the group size (``int4_matmul`` takes any that divides K),
    as JAX's importer does. On the card only 128-row groups do, the W4
    kernel's: a symmetric projection of another group size (AutoGPTQ's
    32 or 64) is dequantized to the dense stack, served by the dense
    matmul, with a warning naming it. Anything else (asymmetric zeros,
    ``g_idx`` act-order) is dequantized to a dense ``dtype`` stack, which
    is what the reference does for every checkpoint. Embeddings, norms and
    lm_head load as a dense HF checkpoint's. Each stacked tensor is
    allocated on the device once and filled a layer at a time."""
    device, dtype = resolve_device(device), torch_dtype(dtype)
    cfg = cfg or load_hf_config(ckpt_dir)
    fmt = _checkpoint_format(ckpt_dir)
    # The quantized arrays are small (a quarter of the dense weights):
    # held as host views of the memory-mapped shards until stacked.
    tensors = dict(_iter_safetensors(ckpt_dir))
    L = cfg.num_layers

    def dense(name, transpose=False):
        t = tensors[name].to(device)
        return (t.t() if transpose else t).to(dtype).contiguous()

    def stacked(fmt_name):
        first = tensors[fmt_name.format(0)]
        out = torch.empty((L,) + tuple(first.shape), dtype=dtype,
                          device=device)
        for i in range(L):
            out[i].copy_(tensors[fmt_name.format(i)].to(device))
        return out

    params: Dict[str, object] = {
        "embed": dense("model.embed_tokens.weight"),
        "final_norm": dense("model.norm.weight"),
        "layers": {
            "attn_norm": stacked("model.layers.{}.input_layernorm.weight"),
            "mlp_norm": stacked(
                "model.layers.{}.post_attention_layernorm.weight"),
        },
    }
    if "lm_head.weight" in tensors:
        params["lm_head"] = dense("lm_head.weight", transpose=True)

    layers = params["layers"]
    regrouped = []
    for sub, ours in _PROJ_SUBS.items():
        def arr(i, field):
            key = f"model.layers.{i}.{sub}.{field}"
            return tensors[key].numpy() if key in tensors else None

        qw = [arr(i, "qweight") for i in range(L)]
        qz = [arr(i, "qzeros") for i in range(L)]
        gi = [arr(i, "g_idx") for i in range(L)]
        sym = native and all(
            gptq_is_symmetric(z, g, w.shape[0] * 8, fmt)
            for w, z, g in zip(qw, qz, gi))
        if sym and not _w4_native(qw[0].shape[0] * 8, qz[0].shape[0],
                                  device):
            regrouped.append(ours)
            sym = False
        if sym:
            packed = torch.empty((L,) + qw[0].shape, dtype=torch.int32,
                                 device=device)
            scale = torch.empty((L,) + tuple(arr(0, "scales").shape),
                                dtype=torch.float32, device=device)
            for i in range(L):
                w4 = int4_from_gptq(qw[i], qz[i], arr(i, "scales"), gi[i],
                                    fmt, device=device)
                packed[i].copy_(w4.packed)
                scale[i].copy_(w4.scale)
            layers[ours] = Int4Weight(packed=packed, scale=scale)
        else:
            k, n = qw[0].shape[0] * 8, qw[0].shape[1]
            out = torch.empty((L, k, n), dtype=dtype, device=device)
            for i in range(L):
                w = dequantize_gptq(qw[i], qz[i], arr(i, "scales"), gi[i],
                                    fmt)
                out[i].copy_(torch.from_numpy(w).to(device))
            layers[ours] = out
    if regrouped:
        warnings.warn(
            f"{ckpt_dir}: GPTQ groups of other than {INT4_GROUP} rows; the "
            f"W4 kernel takes {INT4_GROUP}-row groups, so "
            f"{', '.join(regrouped)} load dequantized to dense {dtype}",
            stacklevel=2)
    return cfg, params
