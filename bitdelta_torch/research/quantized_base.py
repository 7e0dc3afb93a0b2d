"""1-bit deltas on top of a quantized base (W8 or W4 base + W1 delta);
port of ``bitdelta_tpu/research/quantized_base.py``, same layouts and
the same fp32 arithmetic, bit for bit.

* W8: symmetric per-output-column int8 RTN (:class:`Int8Weight`);
* W4: symmetric int4 RTN per (128-row K group, column), 8 nibbles packed
  per int32 word along K, LSB-first (:class:`Int4Weight`) — the density
  configuration: a Mistral-7B base in about 3.7 GB instead of 14.

The deltas are taken against the *dequantized* base, as the reference's
quantized-base ablation prescribes:
``W ~ deq(q(W_base)) + alpha * sign(W_fine - deq(q(W_base)))``.

The ``quantize_*base_projections*`` / ``dequantize_base_projections``
functions walk a layer-stacked ``(L, K, N)`` projection (or a Mixtral
expert stack ``(L, E, K, N)``) one layer at a time into preallocated
outputs, so the fp32 temporaries stay the size of one layer's matrices
(the JAX package quantizes the whole stack in one call; the values are
the same, element by element).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.binary_matmul import matmul_f32
from ..ops.packing import _to_i32
from ..parallel.collectives import pmax


class Int8Weight(NamedTuple):
    """Symmetric per-output-channel int8: ``W ~ q * scale[None, :]``.

    q: ``(*, K, N)`` int8; scale: ``(*, N)`` fp32."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_int8(w: torch.Tensor, mesh=None) -> Int8Weight:
    """``mesh``: ``w`` is a row-parallel rank's K rows; each column's
    absmax is then taken over the model axis too (a max all-reduce, which
    rounds nothing), so the result is this rank's block of the whole
    matrix's, bit for bit."""
    w32 = w.to(torch.float32)
    absmax = pmax(w32.abs().amax(dim=-2), mesh)          # per output column
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return Int8Weight(q=q.to(torch.int8), scale=scale)


def dequantize_int8(w: Int8Weight, dtype=torch.float32) -> torch.Tensor:
    return (w.q.to(torch.float32) * w.scale[..., None, :]).to(dtype)


def int8_matmul(x: torch.Tensor, w: Int8Weight,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ deq(w)``: contract against the int8 values cast to the
    compute dtype, then scale the fp32 sum per column."""
    y = matmul_f32(x.to(compute_dtype), w.q.to(compute_dtype))
    return (y * w.scale[..., None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# W4 base (grouped int4 RTN)
# ---------------------------------------------------------------------------

INT4_GROUP = 128  # K rows per quantization group


class Int4Weight(NamedTuple):
    """Grouped symmetric int4: ``W ~ nib * scale[k // GROUP, :]``.

    packed: ``(*, K//8, N)`` int32 — 8 two's-complement nibbles along K,
      LSB-first (nibble ``s`` of word ``k8`` is row ``8*k8 + s``).
    scale: ``(*, K//GROUP, N)`` fp32 per group and column (GROUP is
      INT4_GROUP for :func:`quantize_int4`; an imported GPTQ layer may
      carry smaller groups, derived from the scale's shape).
    """

    packed: torch.Tensor
    scale: torch.Tensor


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """``(*, K, N)`` int32 in [-8, 7] -> ``(*, K//8, N)`` int32,
    LSB-first. Built in int64 and narrowed with a two's-complement wrap
    (torch has no uint32 arithmetic), so a word whose top nibble is
    negative comes out as the same negative int32 as JAX's bitcast."""
    *lead, k, n = q.shape
    nib = (q & 0xF).to(torch.int64).reshape(*lead, k // 8, 8, n)
    words = torch.zeros((*lead, k // 8, n), dtype=torch.int64,
                        device=q.device)
    for s in range(8):
        words |= nib[..., s, :] << (4 * s)
    return _to_i32(words)


def _unpack_nibbles(packed: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """``(*, K//8, N)`` int32 -> ``(*, K, N)`` values in [-8, 7] as
    ``dtype`` (sign-extended). The int32 shift is arithmetic, but the
    0xF mask keeps only the nibble, so no unsigned view is needed."""
    *lead, k8, n = packed.shape
    out = torch.empty((*lead, k8, 8, n), dtype=dtype, device=packed.device)
    for s in range(8):
        out[..., s, :] = (((packed >> (4 * s)) & 0xF) ^ 8) - 8
    return out.reshape(*lead, k8 * 8, n)


def quantize_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Int4Weight:
    *lead, k, n = w.shape
    if k % group or group % 8:
        raise ValueError(f"K={k} must divide into {group}-row groups "
                         f"of whole words")
    w32 = w.to(torch.float32).reshape(*lead, k // group, group, n)
    absmax = w32.abs().amax(dim=-2)                     # (*, K//g, N)
    scale = torch.clamp(absmax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -7, 7)
    q = q.to(torch.int32).reshape(*lead, k, n)
    return Int4Weight(packed=_pack_nibbles(q), scale=scale)


def dequantize_int4(w: Int4Weight, dtype=torch.float32) -> torch.Tensor:
    *lead, k8, n = w.packed.shape
    k = k8 * 8
    nib = _unpack_nibbles(w.packed).to(torch.float32)
    g = k // w.scale.shape[-2]
    deq = (nib.reshape(*lead, k // g, g, n)
           * w.scale[..., :, None, :]).reshape(*lead, k, n)
    return deq.to(dtype)


def int4_matmul(x: torch.Tensor, w: Int4Weight, compute_dtype=torch.bfloat16,
                out_dtype=None) -> torch.Tensor:
    """``x @ deq(w)`` as JAX computes it: the contraction runs per K
    group (``"...Gg,Ggn->...Gn"``, nibbles in the compute dtype, fp32
    sums), each ``(G, N)`` partial is multiplied by its group's scale, and
    the partials are summed over groups in fp32. Dequantizing first and
    multiplying once would round differently in bf16. x ``(..., K)``;
    w a single ``(K//8, N)`` matrix."""
    k8, n = w.packed.shape
    k = k8 * 8
    groups = w.scale.shape[0]
    g = k // groups
    nib = _unpack_nibbles(w.packed, compute_dtype).reshape(groups, g, n)
    lead = x.shape[:-1]
    xr = x.to(compute_dtype).reshape(-1, groups, g).transpose(0, 1)
    partial = matmul_f32(xr.contiguous(), nib)            # (G, M, N) fp32
    y = torch.sum(partial * w.scale[:, None, :], dim=0)
    return y.reshape(*lead, n).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Whole-model conversion
# ---------------------------------------------------------------------------

def _layerwise(quantize, w: torch.Tensor):
    """``quantize`` over the leading layer axis of an ``(L, K, N)`` stack,
    one layer at a time into preallocated outputs (a 2-D matrix is
    quantized directly). On meta tensors (a whole stack described from
    checkpoint headers, ``stacking.load_stack_shard``) it gives the
    leaves' shapes and dtypes."""
    if w.ndim == 2:
        return quantize(w)
    first = quantize(w[0])
    out = type(first)(*(torch.empty((w.shape[0], *f.shape), dtype=f.dtype,
                                    device=f.device) for f in first))
    for layer in range(w.shape[0]):
        part = first if layer == 0 else quantize(w[layer])
        for dst, src in zip(out, part):
            dst[layer] = src
    return out


def _dequantize_layerwise(dequantize, w, dtype) -> torch.Tensor:
    lead = w[0]
    if lead.ndim == 2:
        return dequantize(w, dtype)
    first = dequantize(type(w)(*(f[0] for f in w)), dtype)
    out = torch.empty((lead.shape[0], *first.shape), dtype=dtype,
                      device=first.device)
    out[0] = first
    for layer in range(1, lead.shape[0]):
        out[layer] = dequantize(type(w)(*(f[layer] for f in w)), dtype)
    return out


def _quantize_projections(params, quantize, names=None, mesh=None):
    """``mesh``: the params are a rank's shards (``parallel/sharding.py::
    param_specs``); W8's row-parallel matrices take their absmax over the
    model axis. W4's 128-row groups stay within a rank's K rows, or
    :func:`quantize_int4` raises."""
    from ..models.llama import PROJ_NAMES
    from ..parallel.sharding import ROW_PARALLEL

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in names or PROJ_NAMES:
        q = quantize
        if (mesh is not None and quantize is quantize_int8
                and name in ROW_PARALLEL):
            q = functools.partial(quantize_int8, mesh=mesh)
        out["layers"][name] = _layerwise(q, params["layers"][name])
    return out


def quantize_base_projections(params, mesh=None):
    """W8 serving mode: every compressed projection of a params dict
    becomes an :class:`Int8Weight` (per-output-column RTN on the
    layer-stacked ``(L, K, N)`` matrices). Embeddings, lm_head and norms
    keep their dtype; the model's ``_base_matmul`` dispatches on the leaf
    type. ``mesh``: on a rank's shards (:func:`_quantize_projections`)."""
    return _quantize_projections(params, quantize_int8, mesh=mesh)


def quantize_mixtral_base_projections(params, include_router=False):
    """W8 serving mode for Mixtral: the attention projections and the
    expert stacks ``w1/w3/w2 (L, E, K, N)`` become :class:`Int8Weight`
    with per-column scales ``(L, E, N)``; the router stays dense unless
    ``include_router``."""
    from ..models.mixtral import ATTN_PROJS, EXPERT_MATS

    names = ATTN_PROJS + EXPERT_MATS + (("router",) if include_router
                                        else ())
    return _quantize_projections(params, quantize_int8, names)


def quantize_base_projections_int4(params):
    """W4 serving mode: every compressed projection becomes an
    :class:`Int4Weight` (about a quarter of the bf16 base's bytes). On a
    rank's shards it is the same call: its groups never cross a rank."""
    return _quantize_projections(params, quantize_int4)


def dequantize_base_projections(params, dtype=None):
    """Inverse of the ``quantize_base_projections*`` functions: the
    rounded dense weights, which the deltas must be taken against."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name, w in params["layers"].items():
        if isinstance(w, Int8Weight):
            out["layers"][name] = _dequantize_layerwise(
                dequantize_int8, w, dtype or torch.bfloat16)
        elif isinstance(w, Int4Weight):
            out["layers"][name] = _dequantize_layerwise(
                dequantize_int4, w, dtype or torch.bfloat16)
    return out


def quantize_int4_base_with_delta(base: torch.Tensor,
                                  finetune: torch.Tensor):
    """W4+W1 recipe: int4 the base, 1-bit the residual against the
    dequantized base."""
    from ..core.delta import quantize_delta

    qbase = quantize_int4(base)
    deq = dequantize_int4(qbase, base.dtype)
    return qbase, quantize_delta(deq, finetune)


def quantize_base_with_delta(base: torch.Tensor, finetune: torch.Tensor):
    """W8+W1 recipe: int8 the base, then 1-bit the residual fine-tune
    delta against the dequantized base."""
    from ..core.delta import quantize_delta

    qbase = quantize_int8(base)
    deq = dequantize_int8(qbase, base.dtype)
    return qbase, quantize_delta(deq, finetune)


BASE_QUANT_MODES = ("int8", "int4")


def quantize_base(params, mode: str, mesh=None):
    """Quantize every compressed projection per ``mode`` (serving form).
    ``mesh``: the params are a rank's shards, and so is the result (the
    shard of the whole base's, bit for bit)."""
    if mode == "int8":
        return quantize_base_projections(params, mesh)
    if mode == "int4":
        return quantize_base_projections_int4(params)
    raise ValueError(f"unknown base_quant mode {mode!r}; "
                     f"expected one of {BASE_QUANT_MODES}")


def roundtrip_base(params, mode: str, dtype=None, mesh=None):
    """``deq(q(params))`` — the dense base the deltas must be taken
    against so that W8/W4 + W1 serving is exact. ``mesh``: the params
    are a rank's shards (``parallel/sharding.py::param_specs``), and the
    result is the shard of the whole round trip, bit for bit: a
    column-parallel matrix holds whole columns, and a row-parallel one
    is rounded by :func:`_roundtrip_k_shard`, so a W4 group may straddle
    ranks, as the whole matrix's groups allow."""
    from ..parallel.collectives import axis_size
    from ..parallel.mesh import MODEL_AXIS

    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return dequantize_base_projections(quantize_base(params, mode),
                                           dtype)
    from ..models.llama import PROJ_NAMES
    from ..parallel.sharding import ROW_PARALLEL

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in PROJ_NAMES:
        if name in ROW_PARALLEL:
            fn = functools.partial(_roundtrip_k_shard, mode=mode, mesh=mesh,
                                   dtype=dtype)
        else:
            fn = functools.partial(roundtrip_matrix, mode=mode, dtype=dtype)
        out["layers"][name] = _dense_layerwise(fn, params["layers"][name])
    return out


def _dense_layerwise(fn, w: torch.Tensor) -> torch.Tensor:
    """``fn`` (a matrix to a matrix) over the leading layer axis of an
    ``(L, K, N)`` stack, one layer at a time into one output."""
    if w.ndim == 2:
        return fn(w)
    first = fn(w[0])
    out = torch.empty((w.shape[0], *first.shape), dtype=first.dtype,
                      device=first.device)
    out[0] = first
    for layer in range(1, w.shape[0]):
        out[layer] = fn(w[layer])
    return out


def roundtrip_matrix(w: torch.Tensor, mode: str, dtype=None) -> torch.Tensor:
    """:func:`roundtrip_base` of one whole ``(K, N)`` projection."""
    if mode == "int8":
        return dequantize_int8(quantize_int8(w), dtype or torch.bfloat16)
    if mode == "int4":
        return dequantize_int4(quantize_int4(w), dtype or torch.bfloat16)
    raise ValueError(f"unknown base_quant mode {mode!r}; "
                     f"expected one of {BASE_QUANT_MODES}")


def _roundtrip_k_shard(w: torch.Tensor, mode: str, mesh,
                       dtype=None) -> torch.Tensor:
    """:func:`roundtrip_matrix` of a whole row-parallel matrix, on this
    rank's ``(K/tp, N)`` block of its rows. The rows are cut at the whole
    matrix's group edges (W8: one group, all of K; W4: 128 rows), each
    group's absmax is the max over the ranks that hold part of it (a
    max all-reduce over the model axis, which rounds nothing), and every
    row is rounded as the whole matrix's is: the block of the whole round
    trip, bit for bit, where a W4 group straddles ranks too."""
    from ..parallel.collectives import axis_index, axis_size
    from ..parallel.mesh import MODEL_AXIS

    if mode not in BASE_QUANT_MODES:
        raise ValueError(f"unknown base_quant mode {mode!r}; "
                         f"expected one of {BASE_QUANT_MODES}")
    k, n = w.shape
    whole_k = k * axis_size(mesh, MODEL_AXIS)
    start = k * axis_index(mesh, MODEL_AXIS)
    group, qmax = (whole_k, 127.0) if mode == "int8" else (INT4_GROUP, 7.0)
    if whole_k % group:
        raise ValueError(f"K={whole_k} must divide into {group}-row groups "
                         f"of whole words")
    edges = sorted({0, k, *range(-start % group, k, group)})
    pieces = [(a, b, (start + a) // group) for a, b in zip(edges, edges[1:])]
    w32 = w.to(torch.float32)
    absmax = w32.new_zeros((whole_k // group, n))
    for a, b, g in pieces:
        absmax[g] = w32[a:b].abs().amax(dim=0)
    scale = torch.clamp(pmax(absmax, mesh), min=1e-8) / qmax
    out = torch.empty((k, n), dtype=dtype or torch.bfloat16, device=w.device)
    for a, b, g in pieces:
        # Through the integers, as the stored values are (-0.0 -> 0).
        q = torch.clamp(torch.round(w32[a:b] / scale[g]), -qmax, qmax)
        out[a:b] = q.to(torch.int32).to(torch.float32) * scale[g]
    return out


def int8_delta_linear(x: torch.Tensor, qbase: Int8Weight, delta,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Forward: int8 base matmul + 1-bit delta matmul (W8 + W1)."""
    from ..ops.binary_matmul import binary_matmul

    y = int8_matmul(x, qbase, compute_dtype).to(torch.float32)
    yd = binary_matmul(x, delta.packed, delta.scale,
                       compute_dtype=compute_dtype).to(torch.float32)
    return (y + yd).to(x.dtype)
