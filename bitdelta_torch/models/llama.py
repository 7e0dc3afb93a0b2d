"""The Llama/Mistral decoder in PyTorch (port of
``bitdelta_tpu/models/llama.py``).

Plain functions over a params dict whose layer tensors are stacked on a
leading L axis (the JAX scan becomes a Python loop over layers), with
per-projection 1-bit deltas: single-tenant ``(L, ...)`` stacks, or
tenant-routed ``(L, T, ...)`` stacks selected per batch row by
``tenant_ids``. Weights are ``(K_in, N_out)`` (``y = x @ W``).

``kernel`` picks the functions as JAX's does (``engine.py:188-189``):
``"cuda"`` takes the branches that JAX routes to its Pallas kernels
(``"pallas"``), ``"torch"`` the plain paths JAX leaves to XLA (``"xla"``).
Each kernel wrapper then runs its CUDA kernel on a CUDA tensor and its
plain version on a CPU tensor, so the CPU tests walk the same branches
the card runs.

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
from ..ops.packing import unpair_packed
from .config import ModelConfig

PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")

Params = Dict[str, Any]
Deltas = Dict[str, Any]


class KVCache(NamedTuple):
    """k/v: ``(L, B, S_max, KV_heads, head_dim)``; length: ``(B,)`` int32
    valid tokens per row (right-aligned)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32,
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


def _layer_delta(delta, layer: int):
    """One layer's slice of a layer-stacked delta (either layout)."""
    return type(delta)(*(leaf[layer] for leaf in delta))


def _proj(x: torch.Tensor, w: torch.Tensor, delta, tenant_ids,
          compute_dtype, kernel: str = "torch") -> torch.Tensor:
    """Linear with an optional fused 1-bit delta; the branch choices of
    ``bitdelta_tpu/models/llama.py::_proj``."""
    if isinstance(delta, PairedBinaryDelta):
        if kernel == "cuda" and tenant_ids is not None and x.shape[-2] == 1:
            # Decode: base matmul + pair-packed delta kernel.
            y = matmul_f32(x[:, 0].to(compute_dtype), w.to(compute_dtype))
            yd = binary_gemm.tenant_delta_matmul_pair(
                x[:, 0].to(compute_dtype), delta.packed_pairs, delta.colsum,
                delta.scale, tenant_ids, out_dtype=torch.float32)
            return (y + yd).to(compute_dtype)[:, None, :]
        delta = BinaryDelta(packed=unpair_packed(delta.packed_pairs),
                            scale=delta.scale)

    # JAX routes canonical-layout decode deltas to its
    # tenant_delta_matmul_pallas (kernel table row 7, not ported yet);
    # that branch takes the plain tenant path below here, which computes
    # the same function — and, as in JAX, it is NOT the prefill branch.
    canonical_decode = (kernel == "cuda" and delta is not None
                        and tenant_ids is not None and x.shape[-2] == 1)
    if (kernel == "cuda" and delta is not None and tenant_ids is not None
            and x.shape[0] == 1 and not canonical_decode):
        # Single-request prefill: the binary matmul kernel on the row's
        # tenant (index and scale stay on the device).
        packed_t = delta.packed[tenant_ids[0]]
        scale_t = delta.scale[tenant_ids[0]]
        y = matmul_f32(x.to(compute_dtype), w.to(compute_dtype))
        yd = binary_gemm.binary_matmul(x[0].to(compute_dtype), packed_t,
                                       scale_t, out_dtype=torch.float32)
        return (y + yd[None]).to(compute_dtype)

    y = matmul_f32(x.to(compute_dtype), w.to(compute_dtype))
    if delta is not None:
        # Without tenant ids JAX's "pallas" takes binary_matmul_trainable
        # (kernel table row 6, the training slice); the plain binary
        # matmul computes the same forward.
        if tenant_ids is None:
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


def _split_deltas(deltas: Optional[Deltas]):
    if deltas is None:
        return None
    if "embed" in deltas or "lm_head" in deltas:
        raise NotImplementedError(
            "compressed embeddings / lm_head deltas are not ported yet")
    return {k: v for k, v in deltas.items() if k in PROJ_NAMES} or None


def _embed_lookup(params: Params, tokens: torch.Tensor,
                  tenant_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embedding; ``embed`` may be tenant-stacked ``(T, V, D)``."""
    e = params["embed"]
    if e.ndim == 3 and tenant_ids is not None:
        return e[tenant_ids[:, None], tokens]
    return e[tokens]


def _lm_head_logits(params: Params, x: torch.Tensor,
                    tenant_ids: Optional[torch.Tensor], compute_dtype,
                    kernel: str = "torch") -> torch.Tensor:
    """fp32 logits ``(B, S, V)``; the branch choices of
    ``bitdelta_tpu/models/llama.py::_lm_head_logits`` (no head deltas)."""
    lm_head = params.get("lm_head")
    if lm_head is None:  # tied embeddings
        lm_head = params["embed"].transpose(-1, -2)
    if lm_head.ndim == 3 and tenant_ids is not None:
        if kernel == "cuda" and x.shape[1] == 1:
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

def _layer_fwd(cfg: ModelConfig, compute_dtype, x, p, d, tenant_ids,
               q_positions, kv_valid, cos, sin, cache_k=None, cache_v=None,
               write_pos=None, kernel: str = "torch", lengths=None):
    """One decoder block. ``p``/``d``: this layer's params / deltas. With
    ``cache_k``/``cache_v`` (``(B, S, KV, hd)`` views of the cache) the
    new K/V are written IN PLACE at ``write_pos`` per row — the JAX
    version returns a new cache from ``.at[].set``; here the cache
    tensors are preallocated and updated where they lie — and attention
    runs over the cache."""
    d = d or {}
    b, sq, _ = x.shape

    def proj(name, inp):
        return _proj(inp, p[name], d.get(name), tenant_ids, compute_dtype,
                     kernel)

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

    h = rms_norm(x, norm_w(p["attn_norm"]), cfg.rms_norm_eps)
    q = biased("q_proj", proj("q_proj", h)).reshape(
        b, sq, cfg.num_heads, cfg.head_dim)
    k = biased("k_proj", proj("k_proj", h)).reshape(
        b, sq, cfg.num_kv_heads, cfg.head_dim)
    v = biased("v_proj", proj("v_proj", h)).reshape(
        b, sq, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache_k is not None:
        rows = torch.arange(b, device=x.device)[:, None]
        idx = write_pos.to(torch.int64)[:, None] + torch.arange(
            sq, device=x.device)[None, :]
        # JAX's scatter clamps out-of-range slots; so does this write.
        idx = torch.clamp(idx, max=cache_k.shape[1] - 1)
        cache_k[rows, idx] = k.to(cache_k.dtype)
        cache_v[rows, idx] = v.to(cache_v.dtype)
        k_all, v_all = cache_k, cache_v
    else:
        k_all, v_all = k, v

    if kernel == "cuda" and cache_k is not None and sq == 1:
        attn = flash_decode_attention(
            q[:, 0], k_all, v_all, q_positions[:, 0] + 1,
            window=cfg.sliding_window).reshape(b, sq, -1)
    elif (kernel == "cuda" and lengths is not None and sq > 1
          and sq % 8 == 0 and k_all.shape[1] % 8 == 0):
        attn = flash_prefill_attention(q, k_all, v_all, lengths,
                                       window=cfg.sliding_window)
    else:
        attn = _attention(cfg, q, k_all, v_all, q_positions, kv_valid)
    x = x + proj("o_proj", attn)

    h = rms_norm(x, norm_w(p["mlp_norm"]), cfg.rms_norm_eps)
    gate = proj("gate_proj", h)
    up = proj("up_proj", h)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(compute_dtype)
    return x + proj("down_proj", act * up)


def _layer(params: Params, deltas: Optional[Deltas], layer: int):
    lp = {name: w[layer] for name, w in params["layers"].items()}
    ld = None
    if deltas is not None:
        ld = {name: _layer_delta(dl, layer) for name, dl in deltas.items()}
    return lp, ld


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            lengths: Optional[torch.Tensor] = None,
            deltas: Optional[Deltas] = None,
            tenant_ids: Optional[torch.Tensor] = None,
            compute_dtype=None, return_cache: bool = False,
            cache_max_seq: Optional[int] = None, kernel: str = "torch"):
    """Full-sequence forward (prefill / eval). tokens ``(B, S)``
    right-padded; lengths ``(B,)`` (default S). Returns fp32 logits
    ``(B, S, V)`` and, with ``return_cache``, a KVCache holding this
    sequence's K/V in slots ``[0, S)`` of a cache padded to
    ``cache_max_seq``."""
    compute_dtype = torch_dtype(compute_dtype or cfg.dtype)
    b, s = tokens.shape
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    deltas = _split_deltas(deltas)
    x = _embed_lookup(params, tokens, tenant_ids).to(compute_dtype)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)

    cache = None
    if return_cache:
        max_seq = cache_max_seq or s
        cache = init_cache(cfg, b, max_seq, compute_dtype, dev)
        cache = cache._replace(length=lengths.to(torch.int32))
        kv_valid = (torch.arange(max_seq, device=dev)[None, :]
                    < lengths[:, None])
        write_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        kv_valid = positions < lengths[:, None]
    for layer in range(cfg.num_layers):
        lp, ld = _layer(params, deltas, layer)
        ck = cache.k[layer] if cache is not None else None
        cv = cache.v[layer] if cache is not None else None
        x = _layer_fwd(cfg, compute_dtype, x, lp, ld, tenant_ids,
                       positions, kv_valid, cos, sin, cache_k=ck,
                       cache_v=cv,
                       write_pos=write_pos if cache is not None else None,
                       kernel=kernel, lengths=lengths)

    x = rms_norm(x, _final_norm_w(params, tenant_ids), cfg.rms_norm_eps)
    logits = _lm_head_logits(params, x, tenant_ids, compute_dtype, kernel)
    if not return_cache:
        return logits
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: KVCache, *, deltas: Optional[Deltas] = None,
                tenant_ids: Optional[torch.Tensor] = None,
                compute_dtype=None, kernel: str = "torch"):
    """Append ``tokens`` ``(B, Sq)`` at each row's current length. The
    cache's k/v are updated in place; returns ``(logits (B, Sq, V),
    KVCache with the same k/v and the advanced length)``."""
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
    deltas = _split_deltas(deltas)
    x = _embed_lookup(params, tokens, tenant_ids).to(compute_dtype)
    for layer in range(cfg.num_layers):
        lp, ld = _layer(params, deltas, layer)
        x = _layer_fwd(cfg, compute_dtype, x, lp, ld, tenant_ids,
                       positions, kv_valid, cos, sin,
                       cache_k=cache.k[layer], cache_v=cache.v[layer],
                       write_pos=cache.length, kernel=kernel)
    x = rms_norm(x, _final_norm_w(params, tenant_ids), cfg.rms_norm_eps)
    logits = _lm_head_logits(params, x, tenant_ids, compute_dtype, kernel)
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
