"""The serving path's smoke check, cheap enough to run before any bench
(port of ``bitdelta_tpu/utils/compiled_check.py``).

JAX's check compiles its Pallas serving kernels and holds a (1, 1)-mesh
engine against the single-device one. Here every kernel route of the
engine is held against the plain engine on the same device: a tiny
2-tenant world (compressed embeddings, fp32) greedy-decoded through
``Engine(kernel="cuda")`` and ``Engine(kernel="cuda_fused")`` must give
the tokens of ``Engine(kernel="torch")``, and the same over a W4 base.
On the card that launches every kernel row but the training path's
transposed binary matmul: k/v_proj's 128 columns do not pair, so those
deltas keep the canonical layout's kernels, and the W4 half's tenant
keeps its own dense head. On the CPU the routes take their kernels'
plain versions.

The (1, 1)-mesh half: each kernel route's engine on a ``make_mesh((1,
1))`` mesh must give the single-device engine's tokens (JAX's meshed
engine against its single-device one). :func:`check_engines` takes a
larger mesh too (``mesh=``, with every rank of it calling): then the
routes run tensor- and data-parallel, each rank its shard, against the
plain engine on one device, and the config needs KV heads that split
over the model axis (:func:`tp_check_config`).

The world (:func:`check_world`) is built apart from the engine runs
(:func:`check_engines`), so a test can hand the engines another world
of the same config, such as JAX's.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.compress import compress_model
from ..device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..parallel.collectives import axis_size, broadcast_object
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from ..research.quantized_base import quantize_base, roundtrip_base
from ..serving.engine import Engine, Request
from ..serving.stacking import stack_tenants


def check_config() -> ModelConfig:
    """JAX's world: vocab 512, hidden 256, 2 layers, 2 heads, 1 KV head,
    fp32."""
    return ModelConfig(vocab_size=512, hidden_size=256,
                       intermediate_size=512, num_layers=2,
                       num_heads=2, num_kv_heads=1,
                       max_seq_len=64, dtype="float32")


def tp_check_config() -> ModelConfig:
    """:func:`check_config` with 2 KV heads, the one change a model axis
    of 2 needs (the KV heads split over it)."""
    return dataclasses.replace(check_config(), num_kv_heads=2)


def check_world(cfg: ModelConfig, device="cuda") -> dict:
    """The base params: fp32, drawn from a torch generator on ``device``
    seeded 0."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    return llama.init_params(cfg, gen, torch.float32, device=device)


def _requests():
    return [Request(prompt_ids=[3, 1, 4, 1, 5], tenant_id=0,
                    max_new_tokens=4),
            Request(prompt_ids=[2, 7, 2], tenant_id=1, max_new_tokens=4)]


def _w4_requests():
    return [Request(prompt_ids=[3, 1, 4], tenant_id=0, max_new_tokens=4)]


def _generate(cfg, stack, kernel, requests, device, max_slots, mesh=None,
              kv_dtype=None):
    """Greedy tokens of one engine; over a mesh of several ranks rank 0
    runs ``generate`` while the others follow, and every rank returns
    rank 0's tokens."""
    eng = Engine(cfg, stack, max_slots=max_slots, max_seq=64,
                 prefill_buckets=(16,), kernel=kernel, device=device,
                 mesh=mesh, kv_dtype=kv_dtype)
    out = None
    if eng.rank != 0:
        eng.follow()
    else:
        try:
            out = [list(map(int, o)) for o in eng.generate(requests)]
        finally:
            eng.stop_followers()
    if mesh is not None and mesh.size() > 1:
        out = broadcast_object(out)
    return out


def check_engines(cfg: ModelConfig, base: dict, log=print, *,
                  device="cuda", mesh=None, kv_dtype=None,
                  want=None) -> dict:
    """Two tenants (every projection scaled by ``1.01 + 0.01 t``, embed
    and head by 1.01, compressed with their embeddings) greedy-decoded
    by each kernel route and by the plain engine; then one zero-delta
    tenant over ``quantize_base(base, "int4")``. With ``mesh`` each
    route (the W4 one too) also runs on it and must give the plain
    engine's tokens. ``kv_dtype``: the engines' cache (``"int8"``, or
    the compute dtype). ``want``: the result of an earlier call on the
    same world and cache; then the single-process engines do not run
    again, only the meshed ones (so a caller can count their kernel
    launches alone). Returns ``{"status": "ok", "tokens": ...,
    "w4_tokens": ...}`` or raises."""
    device = resolve_device(device)
    tenants = []
    for t in range(2):
        fine = dict(base)
        fine["layers"] = {k: (v * (1.01 + 0.01 * t) if v.ndim == 3 else v)
                          for k, v in base["layers"].items()}
        fine["embed"] = base["embed"] * 1.01
        fine["lm_head"] = base["lm_head"] * 1.01
        tenants.append(compress_model(base, fine, compress_embeddings=True))
    stack = stack_tenants(cfg, base, tenants, device=device)
    # W4 density path: the W4 base matmul must serve the plain engine's
    # greedy tokens over the same int4 base.
    qbase = quantize_base(base, "int4")
    deq = roundtrip_base(base, "int4", torch.float32)
    stack_w4 = stack_tenants(cfg, qbase, [compress_model(deq, deq)],
                             device=device)
    kv = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
    routes = " and ".join(llama.CARD_KERNELS)
    if want is None:
        tokens = _generate(cfg, stack, "torch", _requests(), device, 2, **kv)
        for kernel in llama.CARD_KERNELS:
            got = _generate(cfg, stack, kernel, _requests(), device, 2, **kv)
            if got != tokens:
                raise AssertionError(
                    f"{kernel} engine diverged from the plain engine: "
                    f"{got} != {tokens}")
        log(f"[compiled_check] {routes} serving paths ok: {tokens}")
        want4 = _generate(cfg, stack_w4, "torch", _w4_requests(), device, 1)
        got4 = _generate(cfg, stack_w4, "cuda", _w4_requests(), device, 1)
        if got4 != want4:
            raise AssertionError(
                f"W4 cuda engine diverged from the plain engine: "
                f"{got4} != {want4}")
        log(f"[compiled_check] W4 base kernel ok: {got4}")
        want = {"status": "ok", "tokens": tokens, "w4_tokens": got4}
    if mesh is not None:
        shape = (axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS))
        for kernel in llama.CARD_KERNELS:
            got = _generate(cfg, stack, kernel, _requests(), device,
                            2 * shape[0], mesh, **kv)
            if got != want["tokens"]:
                raise AssertionError(
                    f"{kernel} engine on mesh {shape} diverged from the "
                    f"single-device engine: {got} != {want['tokens']}")
        got4 = _generate(cfg, stack_w4, "cuda", _w4_requests(), device,
                         shape[0], mesh)
        if got4 != want["w4_tokens"]:
            raise AssertionError(
                f"W4 cuda engine on mesh {shape} diverged from the plain "
                f"engine: {got4} != {want['w4_tokens']}")
        log(f"[compiled_check] {routes} and W4 on mesh {shape} ok")
    return want


def serving_compiled_check(log=print, *, device="cuda") -> dict:
    """Build the check's world on ``device`` (the card unless the caller
    passes ``"cpu"``) and run :func:`check_engines` on it, with its
    (1, 1)-mesh half."""
    cfg = check_config()
    return check_engines(cfg, check_world(cfg, device), log, device=device,
                         mesh=make_mesh((1, 1), device=device))
