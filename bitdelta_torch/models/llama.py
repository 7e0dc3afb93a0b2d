"""The Llama/Mistral decoder in PyTorch (port of
``bitdelta_tpu/models/llama.py``).

Plain functions over a params dict whose layer tensors are stacked on a
leading L axis (the JAX scan becomes a Python loop over layers), with
per-projection 1-bit deltas: single-tenant ``(L, ...)`` stacks, or
tenant-routed ``(L, T, ...)`` stacks selected per batch row by
``tenant_ids``. Weights are ``(K_in, N_out)`` (``y = x @ W``); a base
projection may be dense, an ``Int8Weight`` (W8) or an ``Int4Weight``
(W4), and the KV cache bf16 or int8 (``init_cache(kv_dtype=)``).

``kernel`` picks the functions as JAX's does (``engine.py:188-189``):
``"cuda"`` takes the branches that JAX routes to its Pallas kernels
(``"pallas"``), ``"torch"`` the plain paths JAX leaves to XLA (``"xla"``).
``"cuda_fused"`` is ``"cuda"`` except at a tenant-routed decode
projection over a dense base leaf, where one kernel computes base and
delta (see :func:`_proj`); JAX dispatches no such route.
Each kernel wrapper then runs its CUDA kernel on a CUDA tensor and its
plain version on a CPU tensor, so the CPU tests walk the same branches
the card runs. For a forward with no tenant ids and no cache (the
distillation student) JAX's ``"pallas"`` and ``"pallas_train"`` take the
same branches, and so does ``"cuda"`` here: the binary matmul and flash
prefill go through autograd Functions, so ``forward`` is differentiable
in the delta scales on either device.

With compressed embeddings the deltas dict also holds ``"embed"`` (packed
along D: ``(D//32, V)``, tenant-stacked ``(T, D//32, V)``) and, untied,
``"lm_head"`` (``(D//32, V)`` / ``(T, D//32, V)``) over a shared base
embed / head; a tied model's embed delta is also its head delta.

Under tensor parallelism (``tp_group``, a ``(data, model)`` mesh from
``parallel/mesh.py``) each rank runs these same functions on its shard
with its LOCAL head counts, as JAX's ``shard_map`` bodies do with
``tp_axis``: the embedding sums its rank's vocab rows over the model
axis, o_proj and down_proj sum their partial outputs, and the logits
come back vocab-sharded. Under autograd (scale distillation) those sums
are Megatron's ``reduce_from_model`` and the inputs of the
column-parallel projections and of the vocab-sharded head pass through
``copy_to_model`` (``parallel/collectives.py``), so the gradients are
the single-process ones.

``seq_group`` splits a full-sequence forward's positions over the data
axis instead (the eval's long windows, JAX's ``P(None, "data")`` on
``eval/ppl.py``'s windows): each rank holds a contiguous slice, and
attention gathers every rank's K/V.

bf16 rounding follows JAX: ``rms_norm`` casts to the input dtype before
the weight multiply, RoPE and silu run in fp32 and cast once, and every
projection accumulates in fp32 and casts once.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..core.delta import BinaryDelta, PairedBinaryDelta
from ..device import resolve_device, torch_dtype
from ..ops import binary_gemm
from ..ops.binary_matmul import (binary_matmul, matmul_f32,
                                 tenant_binary_matmul)
from ..ops.flash_decode import flash_decode_attention
from ..ops.flash_prefill import flash_prefill_attention
from ..ops.int4 import MAX_M as W4_MAX_M
from ..ops.int4 import w4_matmul
from ..ops.kv_quant import dequantize_kv, quantize_kv
from ..ops.packing import unpair_packed
from ..parallel.collectives import (all_gather, axis_index, axis_size,
                                    copy_to_model, reduce_from_model)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..research.quantized_base import (INT4_GROUP, Int4Weight, Int8Weight,
                                       int4_matmul)
from ..utils.profiling import RECORDER
from .config import ModelConfig

PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")
# Row-parallel under tensor parallelism: their K inputs are head- or
# channel-local, so their partial outputs are summed over the model axis.
ROW_PARALLEL_PROJS = ("o_proj", "down_proj")
# The kernel routes: the values of ``kernel`` that take JAX's Pallas
# branches on the card (and the kernels' plain versions on the CPU).
CARD_KERNELS = ("cuda", "cuda_fused")

Params = Dict[str, Any]
Deltas = Dict[str, Any]


class KVCache(NamedTuple):
    """k/v: ``(L, B, S_max, KV_heads, head_dim)``; length: ``(B,)`` int32
    valid tokens per row (right-aligned).

    ``k_scale``/``v_scale``: None for a bf16 cache; for the int8 cache
    (``init_cache(kv_dtype="int8")``) fp32 ``(L, B, S_max, KV_heads)``,
    one absmax scale per stored vector (ops/kv_quant.py)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda",
               kv_dtype: Optional[str] = None) -> KVCache:
    """An empty cache: K/V of ``dtype``, or int8 with fp32 scales when
    ``kv_dtype="int8"`` (None, ``"bf16"`` and ``"bfloat16"`` keep
    ``dtype``)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if kv_dtype in (None, "bf16", "bfloat16"):
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       length=length)
    if kv_dtype != "int8":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                   v=torch.zeros(shape, dtype=torch.int8, device=device),
                   length=length,
                   k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
                   v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """weight: ``(D,)`` shared or ``(B, D)`` per row."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w = weight.to(x.dtype)
    if w.ndim == 2 and x.ndim == 3:
        w = w[:, None, :]
    return normed.to(x.dtype) * w


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                scaling=None):
    """fp32 cos/sin ``(*positions.shape, head_dim)``, HF rotate_half
    convention, optional linear / llama3 frequency scaling."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (ar / half))
    if scaling is not None:
        if scaling.rope_type == "linear":
            inv_freq = inv_freq / scaling.factor
        elif scaling.rope_type == "llama3":
            wavelen = 2.0 * math.pi / inv_freq
            orig = float(scaling.original_max_position_embeddings)
            low_wl = orig / scaling.low_freq_factor
            high_wl = orig / scaling.high_freq_factor
            smooth = ((orig / wavelen - scaling.low_freq_factor)
                      / (scaling.high_freq_factor - scaling.low_freq_factor))
            warped = ((1.0 - smooth) * inv_freq / scaling.factor
                      + smooth * inv_freq)
            inv_freq = torch.where(wavelen > low_wl,
                                   inv_freq / scaling.factor, inv_freq)
            medium = (wavelen <= low_wl) & (wavelen >= high_wl)
            inv_freq = torch.where(medium, warped, inv_freq)
        else:
            raise ValueError(f"unsupported rope scaling {scaling.rope_type!r}")
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: ``(B, S, H, hd)``; cos/sin: ``(B, S, hd)``. fp32, cast once."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = x.to(torch.float32) * c + rotated.to(torch.float32) * s
    return out.to(x.dtype)


def on_card(kernel: str) -> bool:
    """True for a kernel route (``"cuda"``, ``"cuda_fused"``)."""
    return kernel in CARD_KERNELS


def _layer_delta(delta, layer: int):
    """One layer's slice of a layer-stacked NamedTuple (a delta in either
    layout, or a quantized base leaf), field by field."""
    return type(delta)(*(leaf[layer] for leaf in delta))


def _base_matmul(x: torch.Tensor, w, compute_dtype, kernel: str = "torch"
                 ) -> torch.Tensor:
    """``x @ W_base`` with fp32 sums and an fp32 result. ``w`` is a dense
    matrix, an :class:`Int8Weight` (W8: the int8 values cast to the
    compute dtype, the per-column scale on the fp32 sum) or an
    :class:`Int4Weight` (W4: per-group contraction, ``int4_matmul``).

    On a kernel route a decode-shaped W4 matmul takes the W4 kernel
    (``w4_matmul``). The gate is JAX's (2-D x, at most 64 rows, K a
    multiple of 128) with one condition of the port's in place of the
    last: the scale has exactly K/128 rows (so K is a multiple of 128).
    A GPTQ layer imported on the CPU can carry groups of 16-64 rows,
    which ``int4_matmul`` takes and the kernel does not (JAX's Pallas
    kernel would fail its assert there); ``load_gptq_params`` dequantizes
    such a layer on the card. JAX's gate also misses N; the port's
    kernel masks its last column tile, so it needs no N condition. The
    choice is made by shape before any launch."""
    if isinstance(w, Int8Weight):
        y = matmul_f32(x.to(compute_dtype), w.q.to(compute_dtype))
        return y * w.scale[..., None, :].to(torch.float32)
    if isinstance(w, Int4Weight):
        if (on_card(kernel) and x.ndim == 2 and x.shape[0] <= W4_MAX_M
                and w.scale.shape[-2] * INT4_GROUP == x.shape[-1]):
            return w4_matmul(x.to(compute_dtype), w.packed, w.scale,
                             out_dtype=torch.float32)
        return int4_matmul(x, w, compute_dtype, out_dtype=torch.float32)
    return matmul_f32(x.to(compute_dtype), w.to(compute_dtype))


def pair_colsum(delta: PairedBinaryDelta) -> torch.Tensor:
    """The colsum the pair kernels take, ``(*, N)``. A row-parallel pair
    delta's model-axis shard carries its own K shard's colsum with a unit
    shard axis, ``(*, 1, N)`` (``stacking.to_pair_layout(tp=)``): that
    axis goes (the full-K correction would be wrong for a K slice)."""
    colsum = delta.colsum
    if colsum.ndim == delta.packed_pairs.ndim:
        colsum = colsum[..., 0, :]
    return colsum


def _proj(x: torch.Tensor, w, delta, tenant_ids, compute_dtype,
          kernel: str = "torch") -> torch.Tensor:
    """Linear with an optional fused 1-bit delta; the branch choices of
    ``bitdelta_tpu/models/llama.py::_proj``. ``w`` is any base leaf that
    :func:`_base_matmul` takes.

    A tenant-routed decode projection (``x.shape[-2] == 1``) on a kernel
    route takes, under ``"cuda"``, the base matmul and then the delta
    kernel of its layout (row 1 for a pair-layout delta, row 7 for a
    canonical one). Under ``"cuda_fused"`` the same projection over a
    DENSE base leaf takes one kernel for base and delta: row 10
    (:func:`binary_gemm.fused_base_pair_matmul`) for a pair-layout delta,
    row 9 (:func:`binary_gemm.fused_tenant_matmul`) for a canonical one.
    A quantized base leaf (``Int8Weight`` / ``Int4Weight``) keeps the
    ``"cuda"`` route. The choice is made by the leaf's type before any
    launch; nothing falls back on a failure."""
    decode = (on_card(kernel) and delta is not None
              and tenant_ids is not None and x.shape[-2] == 1)
    fused = (decode and kernel == "cuda_fused"
             and isinstance(w, torch.Tensor))
    if isinstance(delta, PairedBinaryDelta):
        if decode:
            xd = x[:, 0].to(compute_dtype)
            colsum = pair_colsum(delta)
            if fused:
                y = binary_gemm.fused_base_pair_matmul(
                    xd, w.to(compute_dtype), delta.packed_pairs, colsum,
                    delta.scale, tenant_ids, out_dtype=torch.float32)
            else:
                # Base matmul + pair-packed delta kernel.
                y = _base_matmul(x[:, 0], w, compute_dtype, kernel)
                y = y + binary_gemm.tenant_delta_matmul_pair(
                    xd, delta.packed_pairs, colsum, delta.scale,
                    tenant_ids, out_dtype=torch.float32)
            return y.to(compute_dtype)[:, None, :]
        delta = BinaryDelta(packed=unpair_packed(delta.packed_pairs),
                            scale=delta.scale)

    if decode:
        xd = x[:, 0].to(compute_dtype)
        if fused:
            y = binary_gemm.fused_tenant_matmul(
                xd, w.to(compute_dtype), delta.packed, delta.scale,
                tenant_ids, out_dtype=torch.float32)
        else:
            # Base matmul + the canonical tenant delta kernel (x on one
            # 14-bit grid).
            y = _base_matmul(x[:, 0], w, compute_dtype, kernel)
            y = y + binary_gemm.tenant_delta_matmul(
                xd, delta.packed, delta.scale, tenant_ids,
                out_dtype=torch.float32)
        return y.to(compute_dtype)[:, None, :]

    if (on_card(kernel) and delta is not None and tenant_ids is not None
            and x.shape[0] == 1):
        # Single-request prefill: the binary matmul kernel on the row's
        # tenant (index and scale stay on the device).
        packed_t = delta.packed[tenant_ids[0]]
        scale_t = delta.scale[tenant_ids[0]]
        y = _base_matmul(x, w, compute_dtype)
        yd = binary_gemm.binary_matmul(x[0].to(compute_dtype), packed_t,
                                       scale_t, out_dtype=torch.float32)
        return (y + yd[None]).to(compute_dtype)

    y = _base_matmul(x, w, compute_dtype)
    if delta is not None:
        if tenant_ids is None and on_card(kernel):
            # Training shapes (M = B*S): the binary matmul kernel behind
            # its autograd Function; gradients flow to x (the transposed
            # kernel) and to the scale.
            b, s, kdim = x.shape
            yd = binary_gemm.binary_matmul_trainable(
                x.reshape(b * s, kdim).to(compute_dtype), delta.packed,
                delta.scale).reshape(b, s, -1)
        elif tenant_ids is None:
            yd = binary_matmul(x, delta.packed, delta.scale,
                               compute_dtype=compute_dtype)
        else:
            yd = tenant_binary_matmul(x, delta.packed, delta.scale,
                                      tenant_ids,
                                      compute_dtype=compute_dtype)
        y = y + yd.to(torch.float32)
    return y.to(compute_dtype)


def _attention(cfg: ModelConfig, q, k, v, q_positions, kv_valid):
    """Grouped-query attention with a key-validity mask, causality and
    the sliding window (the plain path). q ``(B, Sq, H, hd)``; k/v
    ``(B, Sk, KV, hd)``; q_positions ``(B, Sq)``; kv_valid ``(B, Sk)``."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    groups = h // cfg.num_kv_heads
    q_ = q.reshape(b, sq, cfg.num_kv_heads, groups, hd).to(torch.float32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q_, k.to(torch.float32))
    scores = scores / math.sqrt(hd)
    key_pos = torch.arange(sk, device=q.device)[None, :]
    causal = key_pos[:, None, :] <= q_positions[..., None]
    mask = causal & kv_valid[:, None, :]
    if cfg.sliding_window is not None:
        mask = mask & (key_pos[:, None, :]
                       > (q_positions[..., None] - cfg.sliding_window))
    m5 = mask[:, None, None, :, :]
    scores = torch.where(m5, scores, torch.full_like(scores, -math.inf))
    probs = torch.softmax(scores, dim=-1)
    # Fully masked rows (padding queries) give NaN; zero them.
    probs = torch.where(m5.any(dim=-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h * hd).to(q.dtype)


def _split_deltas(deltas: Optional[Deltas], names=PROJ_NAMES):
    """``(layer deltas of names, embed delta, lm_head delta)``: the layer
    stacks run inside the layer loop, the embedding / head deltas outside
    it."""
    if deltas is None:
        return None, None, None
    layer = {k: v for k, v in deltas.items() if k in names}
    return (layer or None), deltas.get("embed"), deltas.get("lm_head")


def _embed_lookup(params: Params, tokens: torch.Tensor,
                  tenant_ids: Optional[torch.Tensor],
                  embed_delta=None, tp_group=None) -> torch.Tensor:
    """Token embedding; ``embed`` may be tenant-stacked ``(T, V, D)``, or
    shared ``(V, D)`` with a 1-bit per-tenant delta (``embed_delta``,
    packed along D, so a token's sign row is one packed-word column):
    ``base + alpha * ±1`` in fp32, cast to the embed's dtype.

    ``tp_group``: a mesh whose model axis shards the vocabulary — each
    rank looks up only its local vocab rows and the results are summed
    over the axis (exactly one rank contributes per token)."""
    e = params["embed"]
    valid, lookup = None, tokens
    if tp_group is not None:
        vloc = e.shape[-2]
        rel = tokens - axis_index(tp_group, MODEL_AXIS) * vloc
        valid = ((rel >= 0) & (rel < vloc))[..., None]
        lookup = torch.clamp(rel, 0, vloc - 1)
    if e.ndim == 3 and tenant_ids is not None:
        base = e[tenant_ids[:, None], lookup]
    else:
        base = e[lookup]
    if embed_delta is None:
        if tp_group is not None:
            base = reduce_from_model(
                torch.where(valid, base, torch.zeros_like(base)), tp_group)
        return base
    packed, scale = embed_delta.packed, embed_delta.scale
    if packed.ndim == 3 and tenant_ids is not None:
        # (T, D//32, V): rows (b, s) read tenant b's column tokens[b, s].
        words = packed[tenant_ids[:, None], :, lookup]      # (B, S, D//32)
        alpha = scale[tenant_ids][:, None, None]
    else:
        words = packed[..., lookup].movedim(-3, -1)
        alpha = scale
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1                # (B, S, D//32, 32)
    pm1 = (2 * bits - 1).reshape(*tokens.shape, -1).to(torch.float32)
    out = base.to(torch.float32) + alpha.to(torch.float32) * pm1
    if tp_group is not None:
        out = reduce_from_model(torch.where(valid, out, torch.zeros_like(out)),
                                tp_group)
    return out.to(e.dtype)


def _head_delta_logits(x: torch.Tensor, head_delta,
                       tenant_ids: Optional[torch.Tensor], compute_dtype,
                       kernel: str) -> torch.Tensor:
    """fp32 ``alpha * (x @ sign)`` of the head delta (``(D//32, V)``, per
    tenant when stacked); the branch choices of
    ``bitdelta_tpu/models/llama.py::_head_delta_logits``: at decode on a
    kernel route row 1 for a paired stacked head, row 7 for a canonical
    one; the plain paths otherwise."""
    if isinstance(head_delta, PairedBinaryDelta):
        stacked = head_delta.packed_pairs.ndim == 3
        if (on_card(kernel) and stacked and tenant_ids is not None
                and x.shape[1] == 1):
            yd = binary_gemm.tenant_delta_matmul_pair(
                x[:, 0].to(compute_dtype), head_delta.packed_pairs,
                head_delta.colsum, head_delta.scale, tenant_ids,
                out_dtype=torch.float32)
            return yd[:, None, :]
        head_delta = BinaryDelta(packed=unpair_packed(head_delta.packed_pairs),
                                 scale=head_delta.scale)
    stacked = head_delta.packed.ndim == 3
    if stacked and tenant_ids is not None:
        if on_card(kernel) and x.shape[1] == 1:
            yd = binary_gemm.tenant_delta_matmul(
                x[:, 0].to(compute_dtype), head_delta.packed,
                head_delta.scale, tenant_ids, out_dtype=torch.float32)
            return yd[:, None, :]
        return tenant_binary_matmul(x, head_delta.packed, head_delta.scale,
                                    tenant_ids, compute_dtype=compute_dtype
                                    ).to(torch.float32)
    return binary_matmul(x, head_delta.packed, head_delta.scale,
                         compute_dtype=compute_dtype).to(torch.float32)


def _lm_head_logits(params: Params, x: torch.Tensor,
                    tenant_ids: Optional[torch.Tensor], compute_dtype,
                    kernel: str = "torch", head_delta=None,
                    embed_delta=None) -> torch.Tensor:
    """fp32 logits ``(B, S, V)``; the branch choices of
    ``bitdelta_tpu/models/llama.py::_lm_head_logits``. With a head delta
    (or, tied, the embed delta) the shared base head's logits plus
    :func:`_head_delta_logits`."""
    lm_head = params.get("lm_head")
    if lm_head is None:  # tied embeddings
        lm_head = params["embed"].transpose(-1, -2)
        if head_delta is None:
            # Tied + compressed embeddings: the embed delta (packed along
            # D against embed.T) is the head delta.
            head_delta = embed_delta
    if head_delta is not None:
        base = matmul_f32(x.to(compute_dtype), lm_head.to(compute_dtype))
        return base + _head_delta_logits(x, head_delta, tenant_ids,
                                         compute_dtype, kernel)
    if lm_head.ndim == 3 and tenant_ids is not None:
        if on_card(kernel) and x.shape[1] == 1:
            # Decode: each row streams its tenant's head; no gather.
            y = binary_gemm.tenant_dense_matmul(
                x[:, 0].to(compute_dtype), lm_head, tenant_ids,
                out_dtype=torch.float32)
            return y[:, None, :]
        return matmul_f32(x.to(compute_dtype),
                          lm_head[tenant_ids].to(compute_dtype))
    return matmul_f32(x.to(compute_dtype), lm_head.to(compute_dtype))


def _final_norm_w(params: Params, tenant_ids):
    w = params["final_norm"]
    if w.ndim == 2 and tenant_ids is not None:
        return w[tenant_ids]
    return w


# ---------------------------------------------------------------------------
# Decoder layer + full forward
# ---------------------------------------------------------------------------

def write_cache(cache: torch.Tensor, write_pos: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write ``new`` ``(B, Sq, ...)`` into ``cache`` ``(B, S, ...)`` in
    place, position j of row b at slot ``write_pos[b] + j``.

    JAX's ``.at[rows, idx].set`` drops every write whose slot is ``>= S``
    (a decode step on a full cache, a prefill bucket longer than the
    cache). So does this, without a host synchronisation: each position
    is pointed at slot ``min(slot, S - 1)`` and carries the value that
    slot ends up with (the in-range write to it, or its old contents),
    so positions that share a slot all write the same value."""
    b, sq = new.shape[:2]
    s = cache.shape[1]
    dev = cache.device
    rows = torch.arange(b, device=dev)[:, None]
    start = write_pos.to(torch.int64)[:, None]
    slot = torch.clamp(start + torch.arange(sq, device=dev)[None, :],
                       max=s - 1)
    src = slot - start                   # the position whose write lands
    keep = (src < 0).reshape(b, sq, *([1] * (new.dim() - 2)))
    vals = new[rows, torch.clamp(src, min=0)].to(cache.dtype)
    cache[rows, slot] = torch.where(keep, cache[rows, slot], vals)


def _layer_fwd(cfg: ModelConfig, compute_dtype, x, p, d, tenant_ids,
               q_positions, kv_valid, cos, sin, cache_k=None, cache_v=None,
               write_pos=None, kernel: str = "torch", lengths=None,
               cache_k_scale=None, cache_v_scale=None, tp_group=None,
               seq_group=None, layer: int = 0):
    """One decoder block (``layer``, for its host spans). ``p``/``d``:
    this layer's params / deltas. With
    ``cache_k``/``cache_v`` (``(B, S, KV, hd)`` views of the cache) the
    new K/V are written IN PLACE at ``write_pos`` per row — the JAX
    version returns a new cache from ``.at[].set``; here the cache
    tensors are preallocated and updated where they lie — and attention
    runs over the cache.

    With ``cache_k_scale``/``cache_v_scale`` (``(B, S, KV)`` views) the
    cache is int8: the fresh K/V are quantized before the write and their
    scales written beside them. Decode under ``kernel="cuda"`` hands the
    int8 K/V and scales to flash decode; every other attention path,
    prefill included, attends over a dequantized view of the whole cache,
    so prefill logits see the quantized K/V, as JAX's do.

    ``tp_group``: Megatron TP on one rank's shard (JAX's ``tp_axis``
    inside ``shard_map``): cfg carries LOCAL head counts, column-parallel
    projections produce local N slices, and the row-parallel ones
    (o_proj, down_proj) sum their partial outputs over the mesh's model
    axis, so the residual stream stays replicated (under autograd through
    Megatron's pair of collectives, ``parallel/collectives.py``).

    ``seq_group``: this rank's queries are a contiguous slice of the
    sequence (``q_positions`` global); the K/V of every rank of the data
    axis are gathered, and attention is the plain path whatever
    ``kernel`` says (JAX evaluates with XLA attention)."""
    d = d or {}
    b, sq, _ = x.shape

    def proj(name, inp):
        y = _proj(inp, p[name], d.get(name), tenant_ids, compute_dtype,
                  kernel)
        if name in ROW_PARALLEL_PROJS:
            y = reduce_from_model(y, tp_group)
        return y

    def norm_w(w):
        if tenant_ids is not None and w.ndim == 2:
            return w[tenant_ids]
        return w

    def biased(name, y):
        bias = p.get(name.split("_")[0] + "_bias")
        if bias is None:
            return y
        bias = norm_w(bias).to(torch.float32)
        if bias.ndim == 2:
            bias = bias[:, None, :]
        return (y.to(torch.float32) + bias).to(y.dtype)

    with RECORDER.span("model.attention", layer=layer):
        h = copy_to_model(rms_norm(x, norm_w(p["attn_norm"]),
                                   cfg.rms_norm_eps), tp_group)
        q = biased("q_proj", proj("q_proj", h)).reshape(
            b, sq, cfg.num_heads, cfg.head_dim)
        k = biased("k_proj", proj("k_proj", h)).reshape(
            b, sq, cfg.num_kv_heads, cfg.head_dim)
        v = biased("v_proj", proj("v_proj", h)).reshape(
            b, sq, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        quantized = cache_k is not None and cache_k_scale is not None
        kernel_decode = on_card(kernel) and cache_k is not None and sq == 1
        if cache_k is not None:
            if quantized:
                k_store, ks_new = quantize_kv(k)
                v_store, vs_new = quantize_kv(v)
                write_cache(cache_k_scale, write_pos, ks_new)
                write_cache(cache_v_scale, write_pos, vs_new)
            else:
                k_store, v_store = k, v
            write_cache(cache_k, write_pos, k_store)
            write_cache(cache_v, write_pos, v_store)
            k_all, v_all = cache_k, cache_v
            if quantized and not kernel_decode:
                k_all = dequantize_kv(cache_k, cache_k_scale, compute_dtype)
                v_all = dequantize_kv(cache_v, cache_v_scale, compute_dtype)
        elif seq_group is not None:
            k_all = all_gather(k, seq_group, DATA_AXIS, dim=1)
            v_all = all_gather(v, seq_group, DATA_AXIS, dim=1)
        else:
            k_all, v_all = k, v

        if kernel_decode:
            attn = flash_decode_attention(
                q[:, 0], k_all, v_all, q_positions[:, 0] + 1,
                k_scale=cache_k_scale if quantized else None,
                v_scale=cache_v_scale if quantized else None,
                window=cfg.sliding_window).reshape(b, sq, -1)
        elif (on_card(kernel) and lengths is not None and seq_group is None
              and sq > 1 and sq % 8 == 0 and k_all.shape[1] % 8 == 0):
            attn = flash_prefill_attention(q, k_all, v_all, lengths,
                                           window=cfg.sliding_window)
        else:
            attn = _attention(cfg, q, k_all, v_all, q_positions, kv_valid)
        x = x + proj("o_proj", attn)

    with RECORDER.span("model.mlp", layer=layer):
        h = copy_to_model(rms_norm(x, norm_w(p["mlp_norm"]),
                                   cfg.rms_norm_eps), tp_group)
        gate = proj("gate_proj", h)
        up = proj("up_proj", h)
        act = torch.nn.functional.silu(gate.to(torch.float32)).to(
            compute_dtype)
        return x + proj("down_proj", act * up)


def _layer(params: Params, deltas: Optional[Deltas], layer: int):
    # ``w[layer]`` of a quantized base leaf (Int8Weight / Int4Weight)
    # would index the tuple, not its tensors.
    lp = {name: (_layer_delta(w, layer) if isinstance(w, tuple)
                 else w[layer])
          for name, w in params["layers"].items()}
    ld = None
    if deltas is not None:
        ld = {name: _layer_delta(dl, layer) for name, dl in deltas.items()}
    return lp, ld


def _cache_views(cache: Optional[KVCache], layer: int):
    """One layer's ``(k, v, k_scale, v_scale)`` views (Nones where the
    cache or its scales are absent)."""
    if cache is None:
        return None, None, None, None
    if cache.quantized:
        return (cache.k[layer], cache.v[layer], cache.k_scale[layer],
                cache.v_scale[layer])
    return cache.k[layer], cache.v[layer], None, None


def sequence_slice(seq_group, s: int, lengths, return_cache: bool):
    """``(start, keys)`` of a forward over ``s`` positions: with
    ``seq_group`` this rank's first global position and the whole
    sequence's length (the rank's slice of whole rows: no ``lengths`` and
    no cache), else ``(0, s)``."""
    if seq_group is None:
        return 0, s
    if lengths is not None or return_cache:
        raise ValueError("a sequence split over the data axis takes whole "
                         "rows: no lengths and no cache")
    return (axis_index(seq_group, DATA_AXIS) * s,
            s * axis_size(seq_group, DATA_AXIS))


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            lengths: Optional[torch.Tensor] = None,
            deltas: Optional[Deltas] = None,
            tenant_ids: Optional[torch.Tensor] = None,
            compute_dtype=None, return_cache: bool = False,
            cache_max_seq: Optional[int] = None, kernel: str = "torch",
            kv_quant: bool = False, tp_group=None, seq_group=None):
    """Full-sequence forward (prefill / eval). tokens ``(B, S)``
    right-padded; lengths ``(B,)`` (default S). Returns fp32 logits
    ``(B, S, V)`` and, with ``return_cache``, a KVCache holding this
    sequence's K/V in slots ``[0, S)`` of a cache padded to
    ``cache_max_seq`` (int8 with its scales when ``kv_quant``, the
    engine's ``kv_dtype="int8"``).

    ``tp_group``: a ``(data, model)`` mesh whose model axis carries
    Megatron TP; this rank holds its shard (``parallel/sharding.py``), cfg
    its LOCAL head counts, and the logits come back vocab-sharded, ``(B,
    S, V/tp)`` (the caller gathers them in rank order).

    ``seq_group``: a mesh whose data axis splits the sequence; tokens
    ``(B, S/dp)`` are this rank's contiguous slice of whole ``(B, S)``
    rows (RoPE offset by the slice's start, K/V gathered over the axis,
    the plain attention), and the logits are the slice's. It takes no
    ``lengths`` and no cache."""
    compute_dtype = torch_dtype(compute_dtype or cfg.dtype)
    b, s = tokens.shape
    dev = tokens.device
    start, kv_len = sequence_slice(seq_group, s, lengths, return_cache)
    if lengths is None and seq_group is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    deltas, embed_delta, head_delta = _split_deltas(deltas)
    x = _embed_lookup(params, tokens, tenant_ids, embed_delta,
                      tp_group).to(compute_dtype)
    positions = (start + torch.arange(s, device=dev))[None, :].expand(b, s)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)

    cache = None
    if return_cache:
        max_seq = cache_max_seq or s
        cache = init_cache(cfg, b, max_seq, compute_dtype, dev,
                           kv_dtype="int8" if kv_quant else None)
        cache = cache._replace(length=lengths.to(torch.int32))
        kv_valid = (torch.arange(max_seq, device=dev)[None, :]
                    < lengths[:, None])
        write_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    elif seq_group is not None:
        kv_valid = torch.ones((b, kv_len), dtype=torch.bool, device=dev)
    else:
        kv_valid = positions < lengths[:, None]
    for layer in range(cfg.num_layers):
        lp, ld = _layer(params, deltas, layer)
        ck, cv, cks, cvs = _cache_views(cache, layer)
        x = _layer_fwd(cfg, compute_dtype, x, lp, ld, tenant_ids,
                       positions, kv_valid, cos, sin, cache_k=ck,
                       cache_v=cv,
                       write_pos=write_pos if cache is not None else None,
                       kernel=kernel, lengths=lengths, cache_k_scale=cks,
                       cache_v_scale=cvs, tp_group=tp_group,
                       seq_group=seq_group, layer=layer)

    x = rms_norm(x, _final_norm_w(params, tenant_ids), cfg.rms_norm_eps)
    logits = _lm_head_logits(params, copy_to_model(x, tp_group), tenant_ids,
                             compute_dtype, kernel, head_delta=head_delta,
                             embed_delta=embed_delta)
    if not return_cache:
        return logits
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: KVCache, *, deltas: Optional[Deltas] = None,
                tenant_ids: Optional[torch.Tensor] = None,
                compute_dtype=None, kernel: str = "torch", tp_group=None):
    """Append ``tokens`` ``(B, Sq)`` at each row's current length. The
    cache's k/v are updated in place; returns ``(logits (B, Sq, V),
    KVCache with the same k/v and the advanced length)``. ``tp_group``:
    as :func:`forward` (the cache holds this rank's KV heads; the logits
    come back vocab-sharded)."""
    compute_dtype = torch_dtype(compute_dtype or cfg.dtype)
    b, sq = tokens.shape
    dev = tokens.device
    positions = cache.length.to(torch.int64)[:, None] + torch.arange(
        sq, device=dev)[None, :]
    new_length = cache.length + sq
    kv_valid = (torch.arange(cache.max_seq, device=dev)[None, :]
                < new_length[:, None])
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    deltas, embed_delta, head_delta = _split_deltas(deltas)
    x = _embed_lookup(params, tokens, tenant_ids, embed_delta,
                      tp_group).to(compute_dtype)
    for layer in range(cfg.num_layers):
        lp, ld = _layer(params, deltas, layer)
        ck, cv, cks, cvs = _cache_views(cache, layer)
        x = _layer_fwd(cfg, compute_dtype, x, lp, ld, tenant_ids,
                       positions, kv_valid, cos, sin,
                       cache_k=ck, cache_v=cv, write_pos=cache.length,
                       kernel=kernel, cache_k_scale=cks, cache_v_scale=cvs,
                       tp_group=tp_group, layer=layer)
    x = rms_norm(x, _final_norm_w(params, tenant_ids), cfg.rms_norm_eps)
    logits = _lm_head_logits(params, x, tenant_ids, compute_dtype, kernel,
                             head_delta=head_delta, embed_delta=embed_delta)
    return logits, cache._replace(length=new_length)


# ---------------------------------------------------------------------------
# Parameter init (tests / benchmarks)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, scale: float = 0.02,
                device="cuda") -> Params:
    """Random params ``N(0, scale^2)`` from ``generator`` (a generator on
    ``device``; seed 0 if omitted). Layer stacks are drawn one layer at a
    time into the final tensor, so no fp32 copy of a whole stack exists."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def n(*shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        parts = out if len(shape) == 3 else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device) * scale)
        return out

    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    params = {
        "embed": n(cfg.vocab_size, D),
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
            "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
            "q_proj": n(L, D, cfg.q_dim),
            "k_proj": n(L, D, cfg.kv_dim),
            "v_proj": n(L, D, cfg.kv_dim),
            "o_proj": n(L, cfg.q_dim, D),
            "gate_proj": n(L, D, I),
            "up_proj": n(L, D, I),
            "down_proj": n(L, I, D),
        },
    }
    if cfg.attention_bias:
        params["layers"]["q_bias"] = n(L, cfg.q_dim)
        params["layers"]["k_bias"] = n(L, cfg.kv_dim)
        params["layers"]["v_bias"] = n(L, cfg.kv_dim)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = n(D, cfg.vocab_size)
    return params


def param_count(params) -> int:
    """Elements over every tensor leaf of nested dicts / lists /
    NamedTuples, as ``jax.tree.leaves`` counts them: an ``Int8Weight``
    or ``Int4Weight`` counts its words and its scales."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(param_count(v) for v in params)
    return 0 if params is None else params.numel()
