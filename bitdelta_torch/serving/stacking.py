"""Tenant stacking: N compressed fine-tunes -> one serving stack (port of
``bitdelta_tpu/serving/stacking.py``).

Packed deltas of all tenants are stacked per projection into
``(L, T, K//32, N)`` (Mixtral's expert stacks keep their expert axis
after the tenant axis: ``(L, T, E, K//32, N)``); per-tenant extras (embed / norms / lm_head) are
stacked on a tenant axis, with ragged vocabularies right-padded to the
largest (logits are masked per tenant at sampling). With compressed
embeddings the embed / lm_head deltas stack tenant-first, ``(T, D//32,
V)``, over the base's shared embed / head, and every tenant has the
base's vocabulary.

Over a mesh, :func:`load_stack_shard` builds a rank's shard of the stack
straight from the checkpoint and the artifacts on disk (a
:class:`StackShard`), so no rank ever holds the whole stack.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..core.compress import LAYER_EXTRA_NAMES, CompressedModel
from ..core.delta import BinaryDelta, PairedBinaryDelta, pair_delta
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import Params
from ..ops.packing import (PAIR_BLOCK, column_popcount, repack_pairs,
                           unpair_packed)
from ..parallel.sharding import (COLUMN_PARALLEL, EXPERT_COLUMN_PARALLEL,
                                 EXPERT_ROW_PARALLEL, ROW_PARALLEL)
from ..research.quantized_base import Int4Weight, Int8Weight

EMBED_DELTAS = ("embed", "lm_head")   # deltas with no layer axis


class TenantStack(NamedTuple):
    params: Params              # base projections + stacked extras
    # packed (L, T, K//32, N), scale (L, T); embed / lm_head (T, D//32, V)
    deltas: Dict[str, object]
    vocab_sizes: torch.Tensor   # (T,) int32 — true vocab per tenant
    num_tenants: int


class StackShard(NamedTuple):
    """One rank's shard of a serving stack, loaded as a shard
    (:func:`load_stack_shard`) rather than cut from a whole one. ``local``
    holds this rank's blocks, canonical layout; ``whole`` is the whole
    stack as meta tensors (shapes and dtypes, no data), from which
    ``Engine(mesh=)`` runs its mesh checks and the shapes ``local`` must
    have (``parallel/sharding.py::check_stack_shard``)."""

    local: TenantStack
    whole: TenantStack


def _pad_vocab(arr: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    if arr.shape[axis] == target:
        return arr
    shape = list(arr.shape)
    shape[axis] = target
    out = arr.new_zeros(shape)
    out.narrow(axis, 0, arr.shape[axis]).copy_(arr)
    return out


def _stack(tensors, dim: int, device, dtype=None) -> torch.Tensor:
    """``torch.stack(tensors, dim)`` on ``device`` (cast to ``dtype``),
    each tensor copied into its slot of one allocation, so that tenants
    on the host cross to the card one at a time: the card holds the
    stacked leaf, not also a copy of every tenant's."""
    first = tensors[0]
    if any(t.shape != first.shape for t in tensors):
        raise ValueError(f"stacking tensors of shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    if dtype is None:
        dtype = functools.reduce(torch.promote_types,
                                 (t.dtype for t in tensors))
    out = torch.empty((*first.shape[:dim], len(tensors),
                       *first.shape[dim:]), dtype=dtype, device=device)
    for i, t in enumerate(tensors):
        out.select(dim, i).copy_(t)
    return out


def _to_device(w, device):
    """A base leaf on ``device``: a tensor, or a quantized weight
    (``Int8Weight`` / ``Int4Weight``) moved field by field."""
    if isinstance(w, tuple):
        return type(w)(*(f.to(device) for f in w))
    return w.to(device)


def stack_tenants(cfg: ModelConfig, base_params: Params,
                  tenants: Sequence[CompressedModel],
                  device="cuda", vocab_sizes=None) -> TenantStack:
    """Build the serving stack on ``device`` from a base model and N
    compressed tenants (tensors are moved there as they are stacked).

    ``vocab_sizes``: each tenant's whole vocabulary, where the base and
    tenants are a rank's shards (:func:`load_stack_shard`: their embeds
    and heads already hold the rank's block of the padded vocabulary, so
    their shapes do not tell the sizes)."""
    device = resolve_device(device)
    if not tenants:
        raise ValueError("need at least one tenant")
    t = len(tenants)
    delta_keys = sorted(tenants[0].deltas.keys())
    ref_shapes = {n: tuple(tenants[0].deltas[n].packed.shape)
                  for n in delta_keys}
    for i, c in enumerate(tenants):
        if sorted(c.deltas.keys()) != delta_keys:
            raise ValueError(
                f"tenant {i} delta keys {sorted(c.deltas.keys())} != "
                f"{delta_keys} — all tenants must be compressed the same way")
        for n in delta_keys:
            if tuple(c.deltas[n].packed.shape) != ref_shapes[n]:
                raise ValueError(
                    f"tenant {i} has mismatched {n} shape "
                    f"{tuple(c.deltas[n].packed.shape)} != {ref_shapes[n]}"
                    f" — all tenants must share the base architecture")

    deltas = {}
    for name in delta_keys:
        # Layer stacks take the tenant axis second, (L, T, ...); the
        # embed / lm_head deltas have no layer axis: (T, D//32, V).
        axis = 0 if name in EMBED_DELTAS else 1
        packed = _stack([c.deltas[name].packed for c in tenants], axis,
                        device)
        scale = _stack([c.deltas[name].scale for c in tenants], axis,
                       device, torch.float32)
        deltas[name] = BinaryDelta(packed=packed, scale=scale)

    compressed_embeds = "embed" in deltas
    if compressed_embeds:
        # compress_model made every tenant's deltas against the base's
        # vocabulary.
        rows = [int(base_params["embed"].shape[0])] * t
    else:
        rows = [int(c.extras["embed"].shape[0]) for c in tenants]
    vocab_sizes = rows if vocab_sizes is None else list(vocab_sizes)
    vmax = max(rows)
    params: Params = {
        "final_norm": _stack([c.extras["final_norm"] for c in tenants], 0,
                             device),
        "layers": {
            name: _stack([c.extras[name] for c in tenants], 1, device)
            for name in LAYER_EXTRA_NAMES if name in tenants[0].extras
        },
    }
    for name, w in base_params["layers"].items():
        if name not in LAYER_EXTRA_NAMES:
            params["layers"][name] = _to_device(w, device)
    if compressed_embeds:
        # The shared base embed / head; the tenants' 1-bit deltas ride on
        # top (no per-tenant dense (V, D) tensors).
        params["embed"] = base_params["embed"].to(device)
        if "lm_head" in deltas:
            params["lm_head"] = base_params["lm_head"].to(device)
    else:
        params["embed"] = _stack(
            [_pad_vocab(c.extras["embed"], vmax, 0) for c in tenants], 0,
            device)
        if all("lm_head" in c.extras for c in tenants):
            params["lm_head"] = _stack(
                [_pad_vocab(c.extras["lm_head"], vmax, 1) for c in tenants],
                0, device)
        elif any("lm_head" in c.extras for c in tenants):
            raise ValueError("mixing tied and untied lm_head tenants")
    return TenantStack(params=params, deltas=deltas,
                       vocab_sizes=torch.tensor(vocab_sizes,
                                                dtype=torch.int32,
                                                device=device),
                       num_tenants=t)


def _pair(d: BinaryDelta, shards: Optional[int]) -> PairedBinaryDelta:
    """:func:`pair_delta`; with ``shards`` the colsum is per K shard,
    ``(*, shards, N)`` = ``2*popcount(shard) - K/shards`` (a row-parallel
    projection's model-axis shard holds K/tp rows; a rank's own shard is
    one)."""
    if shards is None:
        return pair_delta(d)
    *lead, k32, n = d.packed.shape
    per_shard = d.packed.reshape(*lead, shards, k32 // shards, n)
    colsum = (2.0 * column_popcount(per_shard)
              - (k32 // shards) * 32).to(torch.float32)
    return PairedBinaryDelta(packed_pairs=repack_pairs(d.packed),
                             colsum=colsum,
                             scale=d.scale.to(torch.float32))


def _pair_by_matrix(d: BinaryDelta,
                    shards: Optional[int] = None) -> PairedBinaryDelta:
    """:func:`_pair` of a stacked delta one ``(K//32, N)`` matrix (a
    layer's tenant; its expert) at a time into preallocated outputs, so
    the conversion's int64 transients stay one matrix's size."""
    lead = tuple(d.scale.shape)          # one scale a matrix
    matrices = itertools.product(*map(range, lead))
    idx = next(matrices)
    first = _pair(BinaryDelta(d.packed[idx], d.scale[idx]), shards)
    out = PairedBinaryDelta(*(torch.empty((*lead, *f.shape), dtype=f.dtype,
                                          device=f.device) for f in first))
    for dst, src in zip(out, first):
        dst[idx] = src
    del first
    for idx in matrices:
        for dst, src in zip(out, _pair(BinaryDelta(d.packed[idx],
                                                   d.scale[idx]), shards)):
            dst[idx] = src
    return out


def to_pair_layout(stack: TenantStack, *, tp: int = 1,
                   in_place: bool = False,
                   local: bool = False) -> TenantStack:
    """Convert delta stacks to the pair-packed serving layout of the pair
    decode kernel. ``embed`` (read by a gather, not a matmul) and the
    Mixtral ``router`` stay canonical by name, as in JAX; so does a
    projection whose N is not a multiple of 256 (the model dispatch
    handles a mixed dict). A compressed ``lm_head`` pairs where V is a
    multiple of 256. Already-paired leaves pass through.

    ``tp``: the model-axis shard count for tensor-parallel serving. Pair
    words of a contiguous K or N shard equal that shard of the full pair
    layout, so the bits never repack under TP; but the popcount
    correction of a row-parallel projection (o_proj, down_proj, Mixtral
    w2) must be per K shard: its colsum gains a shard axis, ``(L, T, tp,
    N)``. An already-paired row-parallel leaf whose colsum lacks that
    axis is rebuilt from its words. Eligibility is judged on LOCAL
    sizes: a column-parallel projection whose N/tp is not a multiple of
    256 stays canonical, and so does a row-parallel one whose K words do
    not split over ``tp``. At ``tp=1`` nothing changes.

    ``local=True``: the stack is already one rank's shard
    (:func:`load_stack_shard`). Its sizes are the local ones, and a
    row-parallel colsum takes a shard axis of one, ``(L, T, 1, N)``:
    the result is this rank's shard of the whole stack's pair layout.

    ``in_place=True`` replaces the entries of ``stack.deltas`` itself,
    one projection at a time, so each canonical stack is freed as soon as
    its pair layout exists (when nothing else holds it): the conversion
    then needs one projection's stack more, not a second copy of all."""
    row_par = ROW_PARALLEL + EXPERT_ROW_PARALLEL
    col_par = COLUMN_PARALLEL + EXPERT_COLUMN_PARALLEL + ("lm_head",)
    deltas = stack.deltas if in_place else {}
    for name in list(stack.deltas):
        d = stack.deltas[name]
        if name in ("embed", "router"):
            deltas[name] = d
            continue
        if isinstance(d, PairedBinaryDelta):
            if not (name in row_par and tp > 1
                    and d.colsum.ndim == d.packed_pairs.ndim - 1):
                deltas[name] = d
                continue
            # A full-K colsum is wrong for a K shard: rebuild.
            d = BinaryDelta(packed=unpair_packed(d.packed_pairs),
                            scale=d.scale)
        k32, n = d.packed.shape[-2], d.packed.shape[-1]
        shards = None
        if name in row_par and tp > 1:
            shards = 1 if local else tp
            eligible = n % PAIR_BLOCK == 0 and k32 % shards == 0
        else:
            eligible = (n // tp if name in col_par and not local
                        else n) % PAIR_BLOCK == 0
        deltas[name] = _pair_by_matrix(d, shards) if eligible else d
        del d
    return stack._replace(deltas=deltas)


def _weight_nbytes(w) -> int:
    """Bytes of a base leaf, counted as JAX counts them: an
    ``Int8Weight`` as its int8 values plus fp32 scales, an ``Int4Weight``
    as its int32 words plus fp32 scales."""
    if isinstance(w, Int8Weight):
        return w.q.numel() + w.scale.numel() * 4
    if isinstance(w, Int4Weight):
        return w.packed.numel() * 4 + w.scale.numel() * 4
    return w.numel() * w.element_size()


def stack_nbytes(stack: TenantStack) -> Dict[str, float]:
    """Serving memory: shared base vs per-tenant increments. A tenant-
    stacked ``(T, ...)`` embed / lm_head is per-tenant; a shared 2-D one
    (compressed embeddings) is base, as JAX counts it."""
    def nbytes(t):
        return t.numel() * t.element_size()

    base = sum(_weight_nbytes(w) for n, w in stack.params["layers"].items()
               if n not in LAYER_EXTRA_NAMES)
    packed = sum(sum(nbytes(leaf) for leaf in d)
                 for d in stack.deltas.values())
    extras = nbytes(stack.params["final_norm"])
    extras += sum(nbytes(w) for n, w in stack.params["layers"].items()
                  if n in LAYER_EXTRA_NAMES)
    for name in ("embed", "lm_head"):
        w = stack.params.get(name)
        if w is None:
            continue
        if w.ndim == 3:
            extras += nbytes(w)
        else:
            base += nbytes(w)
    return {"base_bytes": float(base), "deltas_bytes": float(packed),
            "tenant_extras_bytes": float(extras),
            "per_tenant_bytes": float((packed + extras) / stack.num_tenants)}


def stack_to(stack: TenantStack, device) -> TenantStack:
    """Every tensor of a stack on ``device``, one leaf at a time."""
    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(move(v) for v in tree))
        return tree.to(device)
    return stack._replace(params=move(stack.params),
                          deltas=move(stack.deltas),
                          vocab_sizes=stack.vocab_sizes.to(device))


def load_stack_shard(cfg: ModelConfig, base_dir: str,
                     delta_paths: Sequence[str], mesh, *, dtype,
                     device="cuda", base_quant: Optional[str] = None
                     ) -> StackShard:
    """This rank's shard of ``stack_tenants`` over the HF checkpoint
    ``base_dir`` and the delta artifacts ``delta_paths``, read straight
    from the files: no rank builds the whole stack.

    The whole stack is first built from the headers alone, as meta
    tensors: the padded vocabulary and every tenant's size come from it,
    and a world the engine would refuse (``sharding.check_stack_tp``) is
    refused before any block is read. Then each rank reads its blocks
    (``load_hf_params(mesh=)``, ``load_delta(mesh=, vocab=)``: a tenant's
    embed and head rows past its own vocabulary are zeros, as
    :func:`stack_tenants` pads them), quantizes the base on its shards
    where ``base_quant`` says (``quantize_base(mesh=)``) and stacks them
    on ``device``. The host holds one checkpoint block at a time. The
    result, paired by ``to_pair_layout(local=True)``, equals
    ``shard_stack(to_pair_layout(whole, tp=tp))`` bit for bit."""
    from ..core.artifact import load_delta
    from ..models.hf_import import load_hf_params
    from ..parallel.collectives import axis_size
    from ..parallel.mesh import MODEL_AXIS
    from ..parallel.sharding import check_stack_tp
    from ..research.quantized_base import quantize_base

    _, mbase = load_hf_params(base_dir, cfg, dtype, device="meta")
    mtenants = [load_delta(p, device="meta", cfg=cfg)[0]
                for p in delta_paths]
    if base_quant is not None:
        mbase = quantize_base(mbase, base_quant)
    whole = stack_tenants(cfg, mbase, mtenants, device="meta")
    check_stack_tp(cfg, whole, axis_size(mesh, MODEL_AXIS))
    if "embed" in whole.deltas:
        vocab_sizes = [int(mbase["embed"].shape[0])] * len(mtenants)
    else:
        vocab_sizes = [int(c.extras["embed"].shape[0]) for c in mtenants]
    vmax = int(whole.params["embed"].shape[-2])
    del mbase, mtenants
    _, base = load_hf_params(base_dir, cfg, dtype, device, mesh=mesh)
    if base_quant is not None:
        base = quantize_base(base, base_quant, mesh)
    tenants = [load_delta(p, device, cfg=cfg, mesh=mesh, vocab=vmax)[0]
               for p in delta_paths]
    local = stack_tenants(cfg, base, tenants, device, vocab_sizes)
    return StackShard(local=local, whole=whole)
