"""Sharding rules for params, deltas and KV caches (port of
``bitdelta_tpu/parallel/sharding.py``).

Megatron-style tensor parallelism over the ``(data, model)`` mesh of
:mod:`.mesh`, with the tables of the JAX package under the same names:

  * column-parallel (shard N): q/k/v_proj, gate/up_proj — their outputs
    are head-/channel-sharded, consumed locally by the row-parallel
    partner;
  * row-parallel (shard K): o_proj, down_proj — their partial outputs
    are summed over the model axis (``collectives.psum`` in the model);
  * packed delta masks shard exactly like their base matrices: a K shard
    of a packed mask is a contiguous slice of int32 words (packing is
    LSB-first along K in 32-row blocks), so TP never repacks;
  * embed shards vocab rows, lm_head vocab columns (logits stay
    vocab-sharded until the caller gathers them);
  * the KV cache shards batch over "data" and KV heads over "model".

A spec is a tuple with one entry per leading dim, each an axis name or
None; dims past its end are replicated, so ``()`` replicates a whole
tensor (JAX's ``PartitionSpec()``). Spec trees mirror the value trees:
dicts, and NamedTuples (``BinaryDelta``, ``PairedBinaryDelta``,
``Int8Weight``, ``Int4Weight``) of specs.

Where JAX places a global array with ``device_put``, each rank here
keeps its own contiguous slice (:func:`shard_tree`) and
:func:`gather_tree` makes a tree whole again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..core.delta import BinaryDelta, PairedBinaryDelta
from ..models.config import ModelConfig
from ..research.quantized_base import INT4_GROUP, Int4Weight, Int8Weight
from .collectives import all_gather, axis_index, axis_size
from .mesh import DATA_AXIS, MODEL_AXIS

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_PARALLEL = ("o_proj", "down_proj")

# Mixtral expert stacks: Megatron TP inside each expert — w1/w3
# ``(L, E, D, I)`` shard the intermediate (column-parallel), w2 ``(L, E,
# I, D)`` contracts the sharded intermediate (row-parallel; one psum per
# MoE block). The router ``(L, D, E)`` is tiny and replicates.
EXPERT_COLUMN_PARALLEL = ("w1", "w3")
EXPERT_ROW_PARALLEL = ("w2",)

M = MODEL_AXIS


def local_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """``cfg`` with this rank's head counts (JAX's ``cfg_local`` of a
    ``shard_map`` body): the model functions run on a shard with them."""
    tp = axis_size(mesh, M)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    layers = {"attn_norm": (), "mlp_norm": ()}
    moe = bool(getattr(cfg, "num_experts", 0))
    for name in COLUMN_PARALLEL:
        if moe and name in ("gate_proj", "up_proj"):
            continue  # Mixtral has expert stacks instead of a dense MLP
        layers[name] = (None, None, M)
    for name in ROW_PARALLEL:
        if moe and name == "down_proj":
            continue
        layers[name] = (None, M, None)
    if moe:
        for name in EXPERT_COLUMN_PARALLEL:
            layers[name] = (None, None, None, M)
        for name in EXPERT_ROW_PARALLEL:
            layers[name] = (None, None, M, None)
        layers["router"] = ()
    specs = {"embed": (M, None), "final_norm": (), "layers": layers}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, M)
    return specs


def delta_specs(cfg: ModelConfig, tenant_stacked: bool = False,
                keys=None) -> Dict[str, Any]:
    """Specs for a deltas dict ``{proj: BinaryDelta}``.

    Single-tenant leaves: packed ``(L, K//32, N)``, scale ``(L,)``.
    Tenant-stacked (serving): packed ``(L, T, K//32, N)``, scale ``(L,
    T)``. With ``keys`` given, returns specs exactly for those names —
    how the ``"embed"`` / ``"lm_head"`` deltas of compressed embeddings
    (packed ``(D//32, V)``, no layer axis, vocab sharded) are included."""
    lead = (None, None) if tenant_stacked else (None,)
    out = {}
    for name in COLUMN_PARALLEL:
        out[name] = BinaryDelta(packed=(*lead, None, M), scale=lead)
    for name in ROW_PARALLEL:
        out[name] = BinaryDelta(packed=(*lead, M, None), scale=lead)
    if getattr(cfg, "num_experts", 0):
        # Expert deltas carry an E axis after the layer/tenant lead;
        # router deltas replicate; scales always replicate.
        for name in EXPERT_COLUMN_PARALLEL:
            out[name] = BinaryDelta(packed=(*lead, None, None, M),
                                    scale=(*lead, None))
        for name in EXPERT_ROW_PARALLEL:
            out[name] = BinaryDelta(packed=(*lead, None, M, None),
                                    scale=(*lead, None))
        out["router"] = BinaryDelta(packed=(*lead, None, None), scale=lead)
    elead = (None,) if tenant_stacked else ()
    for name in ("embed", "lm_head"):
        out[name] = BinaryDelta(packed=(*elead, None, M), scale=elead)
    if keys is None:
        return {k: v for k, v in out.items() if k not in ("embed", "lm_head")}
    return {k: out[k] for k in keys}


def extras_specs(cfg: ModelConfig, keys=None) -> Dict[str, Any]:
    specs = {"embed": (M, None), "final_norm": (), "attn_norm": (),
             "mlp_norm": (),
             # Qwen2-style attention biases (tiny — replicate).
             "q_bias": (), "k_bias": (), "v_bias": ()}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, M)
    if keys is not None:
        # Pass keys=extras.keys(): compressed embeddings drop embed /
        # lm_head, bias-less models have no q/k/v_bias.
        return {k: specs[k] for k in keys}
    return {k: v for k, v in specs.items()
            if k not in ("q_bias", "k_bias", "v_bias")}


def serving_delta_specs(deltas) -> Dict[str, Any]:
    """Specs for a serving (tenant-stacked) deltas dict whose leaves may
    be canonical ``BinaryDelta`` or pair-layout ``PairedBinaryDelta``
    (``stacking.to_pair_layout``).

    Pair words shard exactly like their canonical counterparts — a
    contiguous K shard (a multiple of 32 rows) is a contiguous slice of
    pair rows, and a contiguous N shard (a multiple of 256 columns) a
    contiguous slice of group-major pair columns — so no repack ever
    happens at shard boundaries. Row-parallel paired colsums carry a
    per-K-shard axis ``(L, T, tp, N)`` sharded on the model axis."""
    out = {}
    for name, d in deltas.items():
        paired = isinstance(d, PairedBinaryDelta)
        if name == "embed":
            # (T, D//32, V): packed along hidden, vocab-sharded.
            out[name] = BinaryDelta(packed=(None, None, M), scale=())
        elif name == "lm_head":
            out[name] = (PairedBinaryDelta(packed_pairs=(None, None, M),
                                           colsum=(None, M), scale=())
                         if paired else
                         BinaryDelta(packed=(None, None, M), scale=()))
        elif name in COLUMN_PARALLEL:
            out[name] = (PairedBinaryDelta(
                packed_pairs=(None, None, None, M),
                colsum=(None, None, M), scale=()) if paired
                else BinaryDelta(packed=(None, None, None, M), scale=()))
        elif name in ROW_PARALLEL:
            if paired:
                # colsum is per-K-shard when it has the extra axis.
                cspec = ((None, None, M, None) if d.colsum.ndim == 4
                         else ())
                out[name] = PairedBinaryDelta(
                    packed_pairs=(None, None, M, None), colsum=cspec,
                    scale=())
            else:
                out[name] = BinaryDelta(packed=(None, None, M, None),
                                        scale=())
        # Mixtral: tenant-stacked expert deltas ``(L, T, E, K//32, N)``
        # (canonical) / ``(L, T, E, K//16, N//2)`` (pair) shard like their
        # expert matrices; the router delta ``(L, T, D//32, E)`` replicates.
        elif name in EXPERT_COLUMN_PARALLEL:
            out[name] = (PairedBinaryDelta(
                packed_pairs=(None, None, None, None, M),
                colsum=(None, None, None, M), scale=()) if paired
                else BinaryDelta(packed=(None, None, None, None, M),
                                 scale=()))
        elif name in EXPERT_ROW_PARALLEL:
            if paired:
                cspec = ((None, None, None, M, None) if d.colsum.ndim == 5
                         else ())
                out[name] = PairedBinaryDelta(
                    packed_pairs=(None, None, None, M, None), colsum=cspec,
                    scale=())
            else:
                out[name] = BinaryDelta(packed=(None, None, None, M, None),
                                        scale=())
        elif name == "router":
            out[name] = BinaryDelta(packed=(), scale=())
        else:
            raise ValueError(f"no sharding rule for delta {name!r}")
    return out


def serving_param_specs(cfg: ModelConfig, params, tp: int = 1
                        ) -> Dict[str, Any]:
    """Specs for a TenantStack's serving params (serving/stacking.py):
    projections shard like :func:`param_specs`; tenant-stacked norms
    ``(L, T, D)`` / ``(T, D)`` replicate (tiny); per-tenant embeds ``(T,
    V, D)`` shard vocab rows and per-tenant heads ``(T, D, V)`` vocab
    columns on the model axis (shared 2-D ones — compressed embeddings —
    shard like the single-model specs).

    ``Int8Weight`` (W8): q shards like the dense matrix, the per-column
    scale with N. ``Int4Weight`` (W4): the packed nibbles shard like the
    dense matrix; the per-(K-group, column) scale shards with N
    (column-parallel) and by K group (row-parallel) when the groups
    divide the model axis (``K % (INT4_GROUP * tp) == 0``), else it
    replicates (and the engine refuses the world)."""
    layers: Dict[str, Any] = {}
    for name, w in params["layers"].items():
        if name in COLUMN_PARALLEL:
            qspec, sspec = (None, None, M), (None, M)
        elif name in ROW_PARALLEL:
            qspec, sspec = (None, M, None), ()
        elif name in EXPERT_COLUMN_PARALLEL:  # Mixtral (L, E, D, I)
            layers[name] = (None, None, None, M)
            continue
        elif name in EXPERT_ROW_PARALLEL:     # Mixtral (L, E, I, D)
            layers[name] = (None, None, M, None)
            continue
        else:
            # norms / attention biases / Mixtral router: replicate
            layers[name] = ()
            continue
        if isinstance(w, Int8Weight):
            layers[name] = Int8Weight(q=qspec, scale=sspec)
        elif isinstance(w, Int4Weight):
            if name in COLUMN_PARALLEL:
                i4_sspec = (None, None, M)
            elif tp > 1 and w.scale.shape[-2] % tp == 0:
                i4_sspec = (None, M, None)
            else:
                i4_sspec = ()
            layers[name] = Int4Weight(packed=qspec, scale=i4_sspec)
        else:
            layers[name] = qspec
    specs: Dict[str, Any] = {"final_norm": (), "layers": layers}
    embed = params["embed"]
    specs["embed"] = (None, M, None) if embed.ndim == 3 else (M, None)
    if "lm_head" in params:
        lm = params["lm_head"]
        specs["lm_head"] = (None, None, M) if lm.ndim == 3 else (None, M)
    return specs


def cache_spec():
    """KVCache k/v ``(L, B, S, KV, hd)``: batch on data, heads on model."""
    return (None, DATA_AXIS, None, M, None)


def cache_scale_spec():
    """int8-KV scales ``(L, B, S, KV)`` shard like k/v minus head_dim."""
    return (None, DATA_AXIS, None, M)


def batch_spec():
    return (DATA_AXIS, None)


def _is_spec(spec) -> bool:
    return isinstance(spec, tuple) and not hasattr(spec, "_fields")


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over a value tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, s) for v, s in zip(tree, specs)))
    if not _is_spec(specs):
        raise TypeError(f"spec {specs!r} for a {type(tree).__name__} leaf")
    return fn(tree, specs)


def block_of(shape, spec, mesh):
    """This rank's block of a tensor of ``shape`` under ``spec``: one
    ``(start, size)`` a dim. A checkpoint tensor's block comes from its
    leaf's spec without the stack dims (``models/hf_import.py``,
    ``core/artifact.py::load_delta``), read by
    ``core/artifact.py::StoredTensor.read``."""
    block = []
    for dim, n_dim in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            block.append((0, n_dim))
            continue
        n = axis_size(mesh, axis)
        if n_dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over the {axis} axis ({n})")
        size = n_dim // n
        block.append((axis_index(mesh, axis) * size, size))
    return block


def shard_tensor(x: torch.Tensor, spec, mesh, device=None) -> torch.Tensor:
    """This rank's contiguous block of ``x`` under ``spec``, on ``device``
    (default: ``x``'s): from a host tensor only the block is copied to
    the card."""
    for dim, (start, size) in enumerate(block_of(x.shape, spec, mesh)):
        if size != x.shape[dim]:
            x = x.narrow(dim, start, size)
    if device is not None:
        x = x.to(device)
    return x.contiguous()


def gather_tensor(x: torch.Tensor, spec, mesh, device=None) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``, on
    ``device`` (default: ``x``'s)."""
    for dim, axis in reversed(list(enumerate(spec))):
        if axis is not None:
            x = all_gather(x, mesh, axis, dim)
    return x if device is None else x.to(device)


def shard_tree(tree, specs, mesh, device=None):
    """Every leaf's local block (a new contiguous tensor per sharded leaf;
    the caller drops the whole tree to free it), on ``device`` if given:
    one leaf's block at a time crosses to it."""
    return _map(lambda x, s: shard_tensor(x, s, mesh, device), tree, specs)


def gather_tree(tree, specs, mesh, device=None, keep: bool = True):
    """Inverse of :func:`shard_tree` (every rank gets the whole tree, on
    ``device`` if given). ``keep=False``: the rank takes part in every
    leaf's gather and drops the leaf at once (None in its place), so it
    never holds more than one whole leaf (on the leaf's own device)."""
    def gather(x, spec):
        whole = gather_tensor(x, spec, mesh, device if keep else None)
        return whole if keep else None
    return _map(gather, tree, specs)


def shard_model(cfg: ModelConfig, params, mesh):
    return shard_tree(params, param_specs(cfg), mesh)


def shard_deltas(cfg: ModelConfig, deltas, mesh,
                 tenant_stacked: bool = False):
    return shard_tree(
        deltas, delta_specs(cfg, tenant_stacked, keys=deltas.keys()), mesh)


def shard_stack(cfg: ModelConfig, stack, mesh, device=None):
    """This rank's shard of a serving TenantStack (canonical or pair delta
    layout): packed tenant deltas shard like their base matrices;
    vocab_sizes replicate. ``device``: where the shard goes (default: the
    stack's own); a stack on the host then never reaches the card whole."""
    params = shard_tree(stack.params,
                        serving_param_specs(cfg, stack.params,
                                            tp=axis_size(mesh, M)), mesh,
                        device)
    deltas = shard_tree(stack.deltas, serving_delta_specs(stack.deltas),
                        mesh, device)
    vocab = (stack.vocab_sizes if device is None
             else stack.vocab_sizes.to(device))
    return stack._replace(params=params, deltas=deltas, vocab_sizes=vocab)


def check_stack_tp(cfg: ModelConfig, stack, tp: int) -> None:
    """Raise ``ValueError`` unless a serving stack (whole; its leaves may
    be meta tensors) splits over a model axis of ``tp``: the KV heads,
    query heads and padded vocabulary, and each W4 row-parallel K into
    whole 128-row groups a rank (JAX's mesh checks,
    ``engine.py:216-257``)."""
    if cfg.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} must "
                         f"be a multiple of the model axis ({tp})")
    if tp == 1:
        return
    if cfg.num_heads % tp:
        raise ValueError(
            f"num_heads {cfg.num_heads} must be a multiple of the "
            f"model axis ({tp}) for the per-rank decode path")
    vmax = int(stack.params["embed"].shape[-2])
    if vmax % tp:
        raise ValueError(
            f"padded vocab {vmax} must be a multiple of the model "
            f"axis ({tp}); re-pad the tenant stack")
    for name, w in stack.params["layers"].items():
        # Each rank's row-parallel int4 slice must hold whole groups
        # with their own scale rows.
        if (isinstance(w, Int4Weight) and name in ROW_PARALLEL
                and w.scale.shape[-2] % tp):
            raise ValueError(
                f"W4 + tp={tp}: {name}'s K="
                f"{w.scale.shape[-2] * INT4_GROUP} doesn't split into "
                f"whole {INT4_GROUP}-row groups per model shard; align "
                f"K to INT4_GROUP*tp")


def _pairs(a, b, path=()):
    """``(path, leaf of a, leaf of b)`` of two trees of one structure."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"{'/'.join(path) or 'tree'}: keys "
                             f"{sorted(a)} != {sorted(b)}")
        for k in sorted(a):
            yield from _pairs(a[k], b[k], path + (k,))
    elif isinstance(a, tuple):
        if type(a) is not type(b):
            raise ValueError(f"{'/'.join(path)}: {type(a).__name__} != "
                             f"{type(b).__name__}")
        names = getattr(a, "_fields", None) or map(str, range(len(a)))
        for f, x, y in zip(names, a, b):
            yield from _pairs(x, y, path + (f,))
    else:
        yield "/".join(path), a, b


def _canonical_shapes(d):
    """A delta as the canonical leaves of its shapes: a pair-layout one
    (``(*, K//16, N//2)`` words) as meta tensors of ``(*, K//32, N)``."""
    if not isinstance(d, PairedBinaryDelta):
        return d
    *lead, k16, n2 = d.packed_pairs.shape
    return BinaryDelta(packed=torch.empty((*lead, k16 // 2, n2 * 2),
                                          dtype=d.packed_pairs.dtype,
                                          device="meta"),
                       scale=d.scale)


def check_stack_shard(cfg: ModelConfig, local, whole, mesh) -> None:
    """Raise ``ValueError`` unless ``local`` (a rank's stack, loaded as a
    shard) has, leaf for leaf, the shapes and dtypes :func:`shard_stack`
    gives this rank of ``whole`` (the whole stack, e.g. as meta
    tensors). A delta ``local`` holds in the pair layout (an engine
    pairs a ``StackShard`` in place) is held by its canonical shapes."""
    want = shard_stack(cfg, whole, mesh)
    deltas = {n: _canonical_shapes(d) for n, d in local.deltas.items()}
    for path, got, exp in _pairs((local.params, deltas,
                                  local.vocab_sizes),
                                 (want.params, want.deltas,
                                  want.vocab_sizes)):
        if got.shape != exp.shape or got.dtype != exp.dtype:
            raise ValueError(
                f"loaded shard {path}: {tuple(got.shape)} {got.dtype}, the "
                f"whole stack's shard is {tuple(exp.shape)} {exp.dtype}")


def shard_cache(cache, mesh):
    """A KVCache's local block: batch rows on data, KV heads on model
    (int8-KV scales alongside; lengths with their rows)."""
    return cache._replace(
        k=shard_tensor(cache.k, cache_spec(), mesh),
        v=shard_tensor(cache.v, cache_spec(), mesh),
        length=shard_tensor(cache.length, (DATA_AXIS,), mesh),
        k_scale=(None if cache.k_scale is None
                 else shard_tensor(cache.k_scale, cache_scale_spec(), mesh)),
        v_scale=(None if cache.v_scale is None
                 else shard_tensor(cache.v_scale, cache_scale_spec(), mesh)))
