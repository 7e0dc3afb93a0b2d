"""The Mixtral (sparse MoE) decoder in PyTorch (port of
``bitdelta_tpu/models/mixtral.py``; the HF import is
``models/hf_import.py``).

Attention is llama's (the same RoPE / GQA blocks, and llama's ``_proj``
for the four attention projections, so their deltas take the same kernel
dispatch); the MLP is a top-k routed SwiGLU over E experts, evaluated
densely over experts as JAX does. Expert matrices are stacked on their
own axis after the layer axis: ``w1/w3 (L, E, D, I)``, ``w2 (L, E, I,
D)``, router ``(L, D, E)``. Their 1-bit deltas keep the expert axis:
``(L, E, K//32, N)``, tenant-stacked ``(L, T, E, K//32, N)``.

At decode the base experts still run densely, but each row's delta runs
only for its top-k routed experts: the (tenant, expert) pair is
flattened into the tenant kernels' one stack axis (a view, no copy) and
selected per row. On a kernel route (``"cuda"``, ``"cuda_fused"``) a
pair-layout expert stack takes the pair kernel and a canonical one the
canonical tenant delta kernel; the router and the prefill experts stay on
the plain paths, as they stay on XLA in JAX. ``"cuda_fused"`` fuses only
an attention projection over a dense base (llama's ``_proj``): the
experts' base runs densely over all experts, apart from their routed
deltas. Compressed embed / head deltas take llama's helpers. The KV cache
is bf16 (llama's ``init_cache``).

Under tensor parallelism (``tp_group``, as in llama) each rank holds its
shard of every expert — w1/w3 column-parallel on the intermediate, w2
row-parallel — and the router whole: the MoE block's combine is summed
once over the model axis, and o_proj's output is summed in fp32, as in
JAX. Under autograd those sums are Megatron's ``reduce_from_model`` and
the inputs of the column-parallel projections and experts pass through
``copy_to_model``; so do the routing weights, which the replicated
router hands to each rank's partial expert outputs: their gradient is
summed over the model axis there, and the router's (its delta scale's
included) is then whole on every rank. ``seq_group`` splits the
sequence as llama's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core.delta import BinaryDelta, PairedBinaryDelta
from ..device import resolve_device, torch_dtype
from ..ops import binary_gemm
from ..ops.binary_matmul import (binary_matmul, matmul_f32,
                                 tenant_binary_matmul)
from ..ops.flash_decode import flash_decode_attention
from ..ops.packing import unpack_to_pm1, unpair_packed
from ..parallel.collectives import (all_gather, copy_to_model,
                                    reduce_from_model)
from ..parallel.mesh import DATA_AXIS
from ..research.quantized_base import Int8Weight
from ..utils.profiling import RECORDER
from .config import ModelConfig
from .llama import (KVCache, Params, _attention, _base_matmul, _cache_views,
                    _embed_lookup, _final_norm_w, _layer, _lm_head_logits,
                    _proj, _split_deltas, apply_rope, on_card, pair_colsum,
                    rms_norm, rope_tables, sequence_slice, write_cache)


@dataclasses.dataclass(frozen=True)
class MixtralConfig(ModelConfig):
    num_experts: int = 8
    experts_per_token: int = 2

    @staticmethod
    def from_hf_config(hf) -> "MixtralConfig":
        base = ModelConfig.from_hf_config(hf)
        # Shallow field copy (dataclasses.asdict would recurse into the
        # frozen RopeScaling and hand MixtralConfig a plain dict).
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(base)}
        return MixtralConfig(
            **fields,
            num_experts=getattr(hf, "num_local_experts", 8),
            experts_per_token=getattr(hf, "num_experts_per_tok", 2))


def mixtral_8x7b() -> MixtralConfig:
    """Mixtral-8x7B-v0.1's published ``config.json``."""
    return MixtralConfig(vocab_size=32000, hidden_size=4096,
                         intermediate_size=14336, num_layers=32,
                         num_heads=32, num_kv_heads=8, rope_theta=1e6,
                         rms_norm_eps=1e-5, max_seq_len=32768,
                         num_experts=8, experts_per_token=2)


ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
EXPERT_MATS = ("w1", "w3", "w2")  # gate, up, down (HF mixtral naming)
MOE_PARTS = ATTN_PROJS + EXPERT_MATS + ("router",)


def _delta_matmul(x, w, delta: Optional[BinaryDelta], compute_dtype,
                  tenant_ids=None):
    """Base matmul plus an optional canonical delta on the plain paths
    (the router's)."""
    y = _base_matmul(x, w, compute_dtype)
    if delta is not None:
        if tenant_ids is not None:
            yd = tenant_binary_matmul(x, delta.packed, delta.scale,
                                      tenant_ids, compute_dtype=compute_dtype)
        else:
            yd = binary_matmul(x, delta.packed, delta.scale,
                               compute_dtype=compute_dtype)
        y = y + yd.to(torch.float32)
    return y.to(compute_dtype)


def _unpair(delta):
    """A pair-layout delta back in canonical words (the dense and prefill
    paths); other deltas pass through."""
    if isinstance(delta, PairedBinaryDelta):
        return BinaryDelta(packed=unpair_packed(delta.packed_pairs),
                           scale=delta.scale)
    return delta


def _flatten_stack(delta, lead: int):
    """Merge the leading ``lead`` stack axes of every delta leaf into one
    ((T, E, ...) -> (T*E, ...)), so the tenant kernels' single stack axis
    routes (tenant, expert) pairs. A layer slice is contiguous, so each
    leaf is a view."""
    if lead == 1:
        return delta
    return type(delta)(*(leaf.reshape((-1,) + tuple(leaf.shape[lead:]))
                         for leaf in delta))


def _routed_expert_delta(x_rows, delta, flat_ids, compute_dtype,
                         kernel: str = "torch"):
    """Delta matmul of routed (row, expert) pairs, the Mixtral decode hot
    path: x_rows ``(R, K)``; ``delta`` leaves lead with ONE flattened
    stack axis G; flat_ids ``(R,)`` in ``[0, G)``. Returns ``(R, N)``
    fp32. On a kernel route: the pair kernel for a pair-layout stack, the
    canonical tenant delta kernel otherwise."""
    if isinstance(delta, PairedBinaryDelta):
        if on_card(kernel):
            return binary_gemm.tenant_delta_matmul_pair(
                x_rows.to(compute_dtype), delta.packed_pairs,
                pair_colsum(delta), delta.scale, flat_ids,
                out_dtype=torch.float32)
        delta = _unpair(delta)
    if on_card(kernel):
        return binary_gemm.tenant_delta_matmul(
            x_rows.to(compute_dtype), delta.packed, delta.scale, flat_ids,
            out_dtype=torch.float32)
    y = tenant_binary_matmul(x_rows[:, None, :], delta.packed, delta.scale,
                             flat_ids, compute_dtype=compute_dtype)
    return y[:, 0].to(torch.float32)


def _contract(x, w_e):
    """Per-expert contraction with fp32 sums. Expert input (w1/w3): x
    ``(B, S, D)``, w_e ``(E, D, I)`` -> ``(B, S, E, I)``; expert output
    (w2): x ``(B, S, E, I)``, w_e ``(E, I, D)`` -> ``(B, S, E, D)``."""
    e, _, n = w_e.shape
    if x.ndim == 3:
        b, s, d = x.shape
        xe = x.reshape(1, b * s, d).expand(e, b * s, d).contiguous()
        y = matmul_f32(xe, w_e)                         # (E, B*S, N)
        return y.reshape(e, b, s, n).permute(1, 2, 0, 3)
    b, s, _, i = x.shape
    xt = x.permute(2, 0, 1, 3).reshape(e, b * s, i).contiguous()
    y = matmul_f32(xt, w_e)
    return y.reshape(e, b, s, n).permute(1, 2, 0, 3)


def _expert_matmul(x, w, delta: Optional[BinaryDelta], compute_dtype,
                   tenant_ids=None):
    """All-experts matmul, dense over the expert axis (JAX's
    ``_expert_matmul``): x ``(B, S, D)`` against w1/w3 ``(E, D, I)``, or
    x ``(B, S, E, I)`` against w2 ``(E, I, D)``. ``w`` may be an
    :class:`Int8Weight` (the W8 expert base: the int8 stack cast to the
    compute dtype for the contraction, the per-column scale ``(E, N)`` on
    the fp32 sum).

    Deltas: packed ``(E, K//32, N)`` single-tenant or ``(T, E, K//32,
    N)`` routed per row by ``tenant_ids``. The tenant path unpacks one
    row's ``(E, K, N)`` signs at a time (JAX unpacks ``(B, E, K, N)`` at
    once): the same values with a transient of one row's size."""
    x = x.to(compute_dtype)
    if isinstance(w, Int8Weight):
        y = _contract(x, w.q.to(compute_dtype))
        y = y * w.scale.to(torch.float32)               # (B,S,E,N) * (E,N)
    else:
        y = _contract(x, w.to(compute_dtype))
    delta = _unpair(delta)
    if delta is not None:
        if tenant_ids is not None:
            rows = []
            for b in range(x.shape[0]):
                tid = tenant_ids[b]
                signs = unpack_to_pm1(delta.packed[tid], compute_dtype)
                yd = _contract(x[b:b + 1], signs)        # (1, S, E, N)
                rows.append(yd * delta.scale[tid][:, None])
            yd = torch.cat(rows, dim=0)
        else:
            signs = unpack_to_pm1(delta.packed, compute_dtype)
            yd = _contract(x, signs) * delta.scale[:, None]
        y = y + yd
    return y.to(compute_dtype)


def _route(router_logits: torch.Tensor, k: int):
    """Top-k over the expert axis as ``jax.lax.top_k`` picks it: the
    largest values first, the lower index first among equal values (a
    stable descending sort). Returns ``(values, indices)``."""
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_ffn(cfg: MixtralConfig, compute_dtype, x, p, d, tenant_ids=None,
             kernel: str = "torch", tp_group=None):
    """Top-k routed SwiGLU, dense over experts: x ``(B, S, D)``. With
    ``tenant_ids`` the deltas are tenant-stacked and routed per row.
    ``tp_group``: the experts hold this rank's intermediate columns; the
    combine is summed over the model axis (one reduction a block). The
    router reads ``x`` itself; the experts read it through
    ``copy_to_model``."""
    b, s, _ = x.shape
    e, topk = cfg.num_experts, cfg.experts_per_token

    router_logits = _delta_matmul(x, p["router"], d.get("router"),
                                  torch.float32, tenant_ids)   # (B,S,E)
    topv, topi = _route(router_logits.to(torch.float32), topk)
    gates = torch.softmax(topv, dim=-1)                        # (B,S,k)
    weight = torch.zeros((b, s, e), dtype=torch.float32, device=x.device)
    weight = copy_to_model(weight.scatter(-1, topi, gates), tp_group)
    x = copy_to_model(x, tp_group)

    if s == 1 and any(d.get(m) is not None for m in EXPERT_MATS):
        # Routed delta decode: the base experts run densely; each row's
        # delta runs only for its top-k experts, (tenant, expert)
        # flattened into the kernels' stack axis. Unrouted experts get
        # no delta; their zero routing weight masks them in the combine.
        lead = 1 if tenant_ids is None else 2
        ti = topi[:, 0, :]                                     # (B, k)
        if tenant_ids is None:
            flat_ids = ti.reshape(-1)
        else:
            flat_ids = (tenant_ids[:, None] * e + ti).reshape(-1)
        onehot = (ti[..., None] == torch.arange(e, device=x.device)).to(
            torch.float32)                                     # (B, k, E)

        def routed(rows, name):                                # (B*k, K)
            dd = _flatten_stack(d[name], lead)
            yd = _routed_expert_delta(rows, dd, flat_ids, compute_dtype,
                                      kernel)
            return yd.reshape(b, topk, -1)                     # (B, k, N)

        x0 = x[:, 0]
        xrows = torch.repeat_interleave(x0, topk, dim=0)
        h1 = _expert_matmul(x, p["w1"], None, compute_dtype).to(
            torch.float32)                                     # (B,1,E,I)
        h3 = _expert_matmul(x, p["w3"], None, compute_dtype).to(
            torch.float32)
        if d.get("w1") is not None:
            h1 = h1 + torch.einsum("bke,bki->bei", onehot,
                                   routed(xrows, "w1"))[:, None]
        if d.get("w3") is not None:
            h3 = h3 + torch.einsum("bke,bki->bei", onehot,
                                   routed(xrows, "w3"))[:, None]
        h = (torch.nn.functional.silu(h1).to(compute_dtype)
             * h3.to(compute_dtype))                           # (B,1,E,I)
        out = _expert_matmul(h, p["w2"], None, compute_dtype)  # (B,1,E,D)
        y = torch.einsum("bsed,bse->bsd", out.to(torch.float32), weight)
        if d.get("w2") is not None:
            # Each routed pair's w2 input is its own expert's
            # intermediate.
            x2 = torch.take_along_dim(h[:, 0], ti[:, :, None],
                                      dim=1).reshape(b * topk, -1)
            yd2 = routed(x2, "w2")                             # (B, k, D)
            y = y + torch.einsum("bkd,bk->bd", yd2, gates[:, 0])[:, None]
        return reduce_from_model(y, tp_group).to(compute_dtype)

    h1 = _expert_matmul(x, p["w1"], d.get("w1"), compute_dtype, tenant_ids)
    h3 = _expert_matmul(x, p["w3"], d.get("w3"), compute_dtype, tenant_ids)
    h = torch.nn.functional.silu(h1.to(torch.float32)).to(compute_dtype) * h3
    out = _expert_matmul(h, p["w2"], d.get("w2"), compute_dtype, tenant_ids)
    y = torch.einsum("bsed,bse->bsd", out.to(torch.float32), weight)
    return reduce_from_model(y, tp_group).to(compute_dtype)


def _layer_fwd(cfg: MixtralConfig, compute_dtype, x, p, d, positions,
               kv_valid, cos, sin, cache_k=None, cache_v=None,
               write_pos=None, tenant_ids=None, kernel: str = "torch",
               tp_group=None, seq_group=None, layer: int = 0):
    """One Mixtral block (``layer``, for its host spans). With
    ``cache_k``/``cache_v`` (``(B, S, KV, hd)`` views) the new K/V are
    written IN PLACE at ``write_pos`` per row and attention runs over the
    cache. Decode under ``kernel="cuda"`` takes flash decode; every other
    attention, prefill included, is the plain one, as in JAX.
    ``seq_group``: as llama's ``_layer_fwd``."""
    d = d or {}
    b, sq, _ = x.shape

    def norm_w(w):
        if tenant_ids is not None and w.ndim == 2:
            return w[tenant_ids]
        return w

    def attn_proj(xx, name):
        y = _proj(xx, p[name], d.get(name), tenant_ids, compute_dtype,
                  kernel)
        if name == "o_proj":
            # Row-parallel: heads are rank-local; the sum runs in fp32.
            y = reduce_from_model(y, tp_group, dtype=torch.float32)
        return y

    with RECORDER.span("model.attention", layer=layer):
        h = copy_to_model(rms_norm(x, norm_w(p["attn_norm"]),
                                   cfg.rms_norm_eps), tp_group)
        q = attn_proj(h, "q_proj").reshape(b, sq, cfg.num_heads,
                                           cfg.head_dim)
        k = attn_proj(h, "k_proj").reshape(b, sq, cfg.num_kv_heads,
                                           cfg.head_dim)
        v = attn_proj(h, "v_proj").reshape(b, sq, cfg.num_kv_heads,
                                           cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if cache_k is not None:
            write_cache(cache_k, write_pos, k)
            write_cache(cache_v, write_pos, v)
            k_all, v_all = cache_k, cache_v
        elif seq_group is not None:
            k_all = all_gather(k, seq_group, DATA_AXIS, dim=1)
            v_all = all_gather(v, seq_group, DATA_AXIS, dim=1)
        else:
            k_all, v_all = k, v

        if on_card(kernel) and cache_k is not None and sq == 1:
            attn = flash_decode_attention(
                q[:, 0], k_all, v_all, positions[:, 0] + 1,
                window=cfg.sliding_window).reshape(b, sq, -1)
        else:
            attn = _attention(cfg, q, k_all, v_all, positions, kv_valid)
        x = x + attn_proj(attn, "o_proj")
    with RECORDER.span("model.mlp", layer=layer):
        h = rms_norm(x, norm_w(p["mlp_norm"]), cfg.rms_norm_eps)
        return x + _moe_ffn(cfg, compute_dtype, h, p, d, tenant_ids, kernel,
                            tp_group)


def forward(cfg: MixtralConfig, params: Params, tokens: torch.Tensor, *,
            lengths: Optional[torch.Tensor] = None,
            deltas: Optional[Dict[str, Any]] = None,
            tenant_ids: Optional[torch.Tensor] = None,
            compute_dtype=None, return_cache: bool = False,
            cache_max_seq: Optional[int] = None, kernel: str = "torch",
            tp_group=None, seq_group=None):
    """Full-sequence Mixtral forward. tokens ``(B, S)`` right-padded;
    lengths ``(B,)`` (default S); deltas layer-stacked ``(L, ...)`` (a
    tenant axis after the layer axis with ``tenant_ids``). Returns fp32
    logits ``(B, S, V)`` and, with ``return_cache``, a bf16 KVCache of
    ``cache_max_seq`` slots holding this sequence's K/V. ``tp_group``:
    as llama's (this rank's shard, LOCAL head counts, vocab-sharded
    logits); ``seq_group`` as llama's."""
    from .llama import init_cache

    compute_dtype = torch_dtype(compute_dtype or cfg.dtype)
    b, s = tokens.shape
    dev = tokens.device
    start, kv_len = sequence_slice(seq_group, s, lengths, return_cache)
    if lengths is None and seq_group is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    deltas, embed_delta, head_delta = _split_deltas(deltas, MOE_PARTS)
    x = _embed_lookup(params, tokens, tenant_ids, embed_delta,
                      tp_group).to(compute_dtype)
    positions = (start + torch.arange(s, device=dev))[None, :].expand(b, s)
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
    elif seq_group is not None:
        kv_valid = torch.ones((b, kv_len), dtype=torch.bool, device=dev)
        write_pos = None
    else:
        kv_valid = positions < lengths[:, None]
        write_pos = None
    for layer in range(cfg.num_layers):
        lp, ld = _layer(params, deltas, layer)
        ck, cv, _, _ = _cache_views(cache, layer)
        x = _layer_fwd(cfg, compute_dtype, x, lp, ld, positions, kv_valid,
                       cos, sin, cache_k=ck, cache_v=cv, write_pos=write_pos,
                       tenant_ids=tenant_ids, kernel=kernel,
                       tp_group=tp_group, seq_group=seq_group, layer=layer)
    x = rms_norm(x, _final_norm_w(params, tenant_ids), cfg.rms_norm_eps)
    logits = _lm_head_logits(params, copy_to_model(x, tp_group), tenant_ids,
                             compute_dtype, kernel, head_delta=head_delta,
                             embed_delta=embed_delta)
    if not return_cache:
        return logits
    return logits, cache


def decode_step(cfg: MixtralConfig, params: Params, tokens: torch.Tensor,
                cache: KVCache, *, deltas: Optional[Dict[str, Any]] = None,
                tenant_ids: Optional[torch.Tensor] = None,
                compute_dtype=None, kernel: str = "torch", tp_group=None):
    """Append ``tokens`` ``(B, Sq)`` at each row's current length (the
    cache's k/v are updated in place); MoE routing runs per token.
    Returns ``(logits (B, Sq, V), KVCache with the advanced length)``;
    ``tp_group`` as :func:`forward`."""
    if cache.quantized:
        raise ValueError("mixtral keeps a bf16 cache (the int8 cache is "
                         "wired for the llama family only)")
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
    deltas, embed_delta, head_delta = _split_deltas(deltas, MOE_PARTS)
    x = _embed_lookup(params, tokens, tenant_ids, embed_delta,
                      tp_group).to(compute_dtype)
    for layer in range(cfg.num_layers):
        lp, ld = _layer(params, deltas, layer)
        x = _layer_fwd(cfg, compute_dtype, x, lp, ld, positions, kv_valid,
                       cos, sin, cache_k=cache.k[layer],
                       cache_v=cache.v[layer], write_pos=cache.length,
                       tenant_ids=tenant_ids, kernel=kernel,
                       tp_group=tp_group, layer=layer)
    x = rms_norm(x, _final_norm_w(params, tenant_ids), cfg.rms_norm_eps)
    logits = _lm_head_logits(params, x, tenant_ids, compute_dtype, kernel,
                             head_delta=head_delta, embed_delta=embed_delta)
    return logits, cache._replace(length=new_length)


# ---------------------------------------------------------------------------
# Parameters and compression
# ---------------------------------------------------------------------------

def init_params(cfg: MixtralConfig,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32, scale: float = 0.02,
                device="cuda") -> Params:
    """Random params ``N(0, scale^2)`` from ``generator`` (a generator on
    ``device``; seed 0 if omitted), drawn one matrix at a time into the
    final tensors. Expert stacks ``w1/w3 (L, E, D, I)``, ``w2 (L, E, I,
    D)``, router ``(L, D, E)``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def n(*shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        mats = out.reshape(-1, shape[-2], shape[-1])
        for mat in mats:
            mat.copy_(torch.randn(mat.shape, generator=generator,
                                  device=device) * scale)
        return out

    L, D, I, E = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_experts)
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
            "w1": n(L, E, D, I),
            "w3": n(L, E, D, I),
            "w2": n(L, E, I, D),
            "router": n(L, D, E),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = n(D, cfg.vocab_size)
    return params


def compress_mixtral(base_params: Params, finetuned_params: Params, *,
                     compress_embeddings: bool = False,
                     zero_sign: str = "positive", mesh=None):
    """1-bit fine-tune delta of every attention projection, expert matrix
    and the router; extras are the fine-tuned norms and, unless
    ``compress_embeddings``, embed / head. One matrix at a time, so the
    fp32 diff never exceeds one ``(K, N)`` matrix (JAX quantizes each
    stack in one call; the values agree). ``compress_embeddings=True``:
    embed / lm_head become 1-bit deltas against the base (packed along
    D), as llama's ``compress_model`` makes them. ``mesh``: the params
    are this rank's shards, as ``compress_model``'s; the router is whole
    on every rank, so its scale is its own."""
    from ..core.compress import CompressedModel, embedding_deltas
    from ..core.delta import quantize_delta

    deltas = {}
    for name in MOE_PARTS:
        base_w = base_params["layers"][name]
        fine_w = finetuned_params["layers"][name]
        lead, (k, n) = tuple(base_w.shape[:-2]), tuple(base_w.shape[-2:])
        packed = torch.empty(lead + (k // 32, n), dtype=torch.int32,
                             device=base_w.device)
        scale = torch.empty(lead, dtype=torch.float32, device=base_w.device)
        flat_p = packed.reshape(-1, k // 32, n)
        flat_s = scale.reshape(-1)
        base_m = base_w.reshape(-1, k, n)
        fine_m = fine_w.reshape(-1, k, n)
        for i in range(base_m.shape[0]):
            dm = quantize_delta(base_m[i], fine_m[i], zero_sign=zero_sign,
                                mesh=None if name == "router" else mesh)
            flat_p[i] = dm.packed
            flat_s[i] = dm.scale
        deltas[name] = BinaryDelta(packed=packed, scale=scale)
    extras = {"final_norm": finetuned_params["final_norm"],
              "attn_norm": finetuned_params["layers"]["attn_norm"],
              "mlp_norm": finetuned_params["layers"]["mlp_norm"]}
    if compress_embeddings:
        deltas.update(embedding_deltas(base_params, finetuned_params,
                                       zero_sign, mesh))
    else:
        extras["embed"] = finetuned_params["embed"]
        if "lm_head" in finetuned_params:
            extras["lm_head"] = finetuned_params["lm_head"]
    return CompressedModel(deltas=deltas, extras=extras)


def mixtral_student_params(base_params: Params, compressed) -> Params:
    """The base's layer weights with the fine-tuned extras overlaid (the
    deltas ride on top through ``forward(deltas=...)``)."""
    params = dict(base_params)
    params["layers"] = dict(base_params["layers"])
    ex = compressed.extras
    params["final_norm"] = ex["final_norm"]
    params["layers"]["attn_norm"] = ex["attn_norm"]
    params["layers"]["mlp_norm"] = ex["mlp_norm"]
    if "embed" in ex:
        params["embed"] = ex["embed"]
        if "lm_head" in ex:
            params["lm_head"] = ex["lm_head"]
        elif "lm_head" in params:
            del params["lm_head"]
    return params


def params_from_torch_mixtral(cfg: MixtralConfig, torch_model,
                              dtype=torch.float32, device="cuda") -> Params:
    """Convert a live transformers ``MixtralForCausalLM`` to the port's
    params on ``device`` (the counterpart of
    ``hf_import.params_from_torch_model``). Every tensor of its state dict
    is widened to fp32 first, as the JAX converter does."""
    from .hf_import import mixtral_params_from_state_dict

    sd = ((k, v.detach().float())
          for k, v in torch_model.state_dict().items())
    return mixtral_params_from_state_dict(cfg, sd, dtype, device)
