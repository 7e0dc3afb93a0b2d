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
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

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


def _pad_vocab(arr: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    pad = target - arr.shape[axis]
    if pad == 0:
        return arr
    shape = list(arr.shape)
    shape[axis] = pad
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def _to_device(w, device):
    """A base leaf on ``device``: a tensor, or a quantized weight
    (``Int8Weight`` / ``Int4Weight``) moved field by field."""
    if isinstance(w, tuple):
        return type(w)(*(f.to(device) for f in w))
    return w.to(device)


def stack_tenants(cfg: ModelConfig, base_params: Params,
                  tenants: Sequence[CompressedModel],
                  device="cuda") -> TenantStack:
    """Build the serving stack on ``device`` from a base model and N
    compressed tenants (tensors are moved there as they are stacked)."""
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
        packed = torch.stack([c.deltas[name].packed.to(device)
                              for c in tenants], dim=axis)
        scale = torch.stack([c.deltas[name].scale.to(device, torch.float32)
                             for c in tenants], dim=axis)
        deltas[name] = BinaryDelta(packed=packed, scale=scale)

    compressed_embeds = "embed" in deltas
    if compressed_embeds:
        # compress_model made every tenant's deltas against the base's
        # vocabulary.
        vocab_sizes = [int(base_params["embed"].shape[0])] * t
    else:
        vocab_sizes = [int(c.extras["embed"].shape[0]) for c in tenants]
    vmax = max(vocab_sizes)
    params: Params = {
        "final_norm": torch.stack([c.extras["final_norm"].to(device)
                                   for c in tenants]),
        "layers": {
            name: torch.stack([c.extras[name].to(device) for c in tenants],
                              dim=1)
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
        params["embed"] = torch.stack(
            [_pad_vocab(c.extras["embed"].to(device), vmax, 0)
             for c in tenants])
        if all("lm_head" in c.extras for c in tenants):
            params["lm_head"] = torch.stack(
                [_pad_vocab(c.extras["lm_head"].to(device), vmax, 1)
                 for c in tenants])
        elif any("lm_head" in c.extras for c in tenants):
            raise ValueError("mixing tied and untied lm_head tenants")
    return TenantStack(params=params, deltas=deltas,
                       vocab_sizes=torch.tensor(vocab_sizes,
                                                dtype=torch.int32,
                                                device=device),
                       num_tenants=t)


def _pair(d: BinaryDelta, tp: int) -> PairedBinaryDelta:
    """:func:`pair_delta`; with ``tp > 1`` the colsum is per K shard,
    ``(*, tp, N)`` = ``2*popcount(shard) - K/tp`` (a row-parallel
    projection's model-axis shard holds K/tp rows)."""
    if tp == 1:
        return pair_delta(d)
    *lead, k32, n = d.packed.shape
    per_shard = d.packed.reshape(*lead, tp, k32 // tp, n)
    colsum = (2.0 * column_popcount(per_shard)
              - (k32 // tp) * 32).to(torch.float32)
    return PairedBinaryDelta(packed_pairs=repack_pairs(d.packed),
                             colsum=colsum,
                             scale=d.scale.to(torch.float32))


def _pair_by_layer(d: BinaryDelta, tp: int = 1) -> PairedBinaryDelta:
    """:func:`_pair` of a stacked delta one slice of its leading axis (a
    layer; the tenant of an lm_head delta) at a time into preallocated
    outputs, so the conversion's int64 transients stay one slice's size."""
    first = _pair(BinaryDelta(d.packed[0], d.scale[0]), tp)
    out = PairedBinaryDelta(*(torch.empty((d.packed.shape[0], *f.shape),
                                          dtype=f.dtype, device=f.device)
                              for f in first))
    for layer in range(d.packed.shape[0]):
        part = first if layer == 0 else _pair(
            BinaryDelta(d.packed[layer], d.scale[layer]), tp)
        for dst, src in zip(out, part):
            dst[layer] = src
    return out


def to_pair_layout(stack: TenantStack, *, tp: int = 1,
                   in_place: bool = False) -> TenantStack:
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
        if name in row_par and tp > 1:
            eligible = n % PAIR_BLOCK == 0 and k32 % tp == 0
        else:
            eligible = (n // tp if name in col_par else n) % PAIR_BLOCK == 0
        deltas[name] = (_pair_by_layer(d, tp if name in row_par else 1)
                        if eligible else d)
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
