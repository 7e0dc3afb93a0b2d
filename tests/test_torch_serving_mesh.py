"""PyTorch port: the tensor- and data-parallel serving engine on CPU meshes
against JAX's single-device engine.

JAX's worlds (its own mesh tests' worlds: ``tests/test_serving_mesh.py``,
``test_mixtral.py::_tp_world``, ``test_research.py::_w4_world``) and its
single-device ``kernel="xla"`` engines' greedy tokens are computed in this
process; the port's stacks are carried across by ``convert.py``. Then a
gloo world of ranks (``tests/torch_mesh_worker.py``, one process each,
importing ``bitdelta_torch`` only) serves the same requests through
``Engine(mesh=)`` on each mesh and route: its tokens must equal JAX's,
exactly (fp32). Three worlds run: 8 ranks for ``(2, 4)``, 2 ranks for
``(1, 2)`` and ``(2, 1)``, 4 ranks for Mixtral at ``(2, 2)``.

The 2- and 4-rank worlds also load worlds written to disk (an HF
checkpoint by the port's exporter, in bf16 or fp32, and delta artifacts:
three tenants of different vocabularies, compressed embeddings, a
Mixtral, W8 and W4 bases): each rank reads its own blocks
(``stacking.load_stack_shard``), and its stack must equal the shard of
the whole stack read by one process, bit for bit, the pair layout
included; the engine built on those shards must give JAX's single-device
tokens; a padded vocabulary the model axis does not split and W4 groups
split across ranks are refused before any block is read.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bitdelta_torch.convert import stack_from_numpy, tree_from_numpy
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.models.mixtral import MixtralConfig
from tests.test_serving_mesh import _make_world, _run
from tests.torch_mesh_worker import spawn_world, write_checkpoint

LLAMA_REQS = [dict(prompt_ids=[3, 5, 7, 9, 11], tenant_id=0,
                   max_new_tokens=6),
              dict(prompt_ids=[2, 4, 6], tenant_id=1, max_new_tokens=6),
              dict(prompt_ids=[8, 8, 8, 8], tenant_id=0, max_new_tokens=4)]
KV_REQS = LLAMA_REQS[:2]
MIXTRAL_REQS = [dict(prompt_ids=[5, 11, 3, 7], tenant_id=t,
                     max_new_tokens=5) for t in range(2)]
W4_REQS = [dict(prompt_ids=[3, 9, 4], tenant_id=t, max_new_tokens=6)
           for t in range(2)]
VOCAB_REQS = [dict(prompt_ids=[3, 9, 4, 7], tenant_id=t, max_new_tokens=6)
              for t in range(3)]


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _port(stack):
    return stack_from_numpy(_np_tree(stack), "cpu")


def _jreqs(reqs):
    from bitdelta_tpu.serving.engine import Request

    return [Request(**r) for r in reqs]


def _ints(outs):
    return [list(map(int, o)) for o in outs]


def _llama_world(compress_embeddings):
    cfg, stack = _make_world(compress_embeddings=compress_embeddings)
    return (cfg, stack, _ints(_run(cfg, stack, None)),
            ModelConfig.from_dict(dataclasses.asdict(cfg)))


def _int8_tokens(cfg, stack):
    from bitdelta_tpu.serving.engine import Engine

    eng = Engine(cfg, stack, max_slots=4, max_seq=64, prefill_buckets=(16,),
                 kernel="xla", kv_dtype="int8")
    return _ints(eng.generate(_jreqs(KV_REQS)))


def _mixtral_world():
    from bitdelta_tpu.models import mixtral as mx
    from bitdelta_tpu.serving.engine import Engine
    from bitdelta_tpu.serving.stacking import stack_tenants
    from tests.test_mixtral import _finetune, _tp_world

    cfg, base = _tp_world()
    tenants = [mx.compress_mixtral(base, _finetune(base, 700 + t))
               for t in range(2)]
    stack = stack_tenants(cfg, base, tenants)
    want = Engine(cfg, stack, max_slots=2, max_seq=64, prefill_buckets=(16,),
                  kernel="xla", model=mx, compute_dtype=jnp.float32
                  ).generate(_jreqs(MIXTRAL_REQS))
    return (stack, _ints(want),
            MixtralConfig.from_dict(dataclasses.asdict(cfg)), base, tenants)


def _jax_tokens(cfg, base, tenants, reqs, model=None):
    from bitdelta_tpu.serving.engine import Engine
    from bitdelta_tpu.serving.stacking import stack_tenants

    kw = {} if model is None else {"model": model}
    stack = stack_tenants(cfg, base, tenants)
    return _ints(Engine(cfg, stack, max_slots=2, max_seq=64,
                        prefill_buckets=(16,), kernel="xla",
                        compute_dtype=jnp.float32, **kw
                        ).generate(_jreqs(reqs)))


def _w4_world(**sizes):
    from bitdelta_tpu.serving.stacking import stack_tenants
    from tests.test_research import _w4_world as jw4

    cfg, dense, qbase, _, tenants = jw4(**sizes)
    comps = [c for _, c in tenants]
    return (stack_tenants(cfg, qbase, comps),
            _jax_tokens(cfg, qbase, comps, W4_REQS),
            ModelConfig.from_dict(dataclasses.asdict(cfg)), dense, tenants)


def _write_tenants(root, name, cfg, tenants, base_quant=None):
    from bitdelta_torch.core.artifact import save_delta

    paths = []
    for t, comp in enumerate(tenants):
        path = str(root / f"{name}_{t}.safetensors")
        save_delta(path, tree_from_numpy(_np_tree(comp), "cpu"), cfg,
                   base_quant=base_quant)
        paths.append(path)
    return paths


def _vocab_finetune(cfg, base, seed, vocab):
    """A fine-tune of ``base`` with its own vocabulary of ``vocab`` rows
    (its embed and head cut from the base's and moved)."""
    from bitdelta_tpu.models import llama as jl

    key = jax.random.PRNGKey(seed)
    fine = dict(base)
    fine["layers"] = dict(base["layers"])
    for name in jl.PROJ_NAMES:
        key, sub = jax.random.split(key)
        fine["layers"][name] = base["layers"][name] + (
            0.05 * jax.random.normal(sub, base["layers"][name].shape))
    key, a, b = jax.random.split(key, 3)
    fine["embed"] = base["embed"][:vocab] + 0.02 * jax.random.normal(
        a, (vocab, cfg.hidden_size))
    fine["lm_head"] = base["lm_head"][:, :vocab] + 0.02 * jax.random.normal(
        b, (cfg.hidden_size, vocab))
    return fine


def _disk_worlds(root, mixtral, w4):
    """Worlds written under ``root`` for ``load_stack_shard``, and JAX's
    single-device tokens on the same weights: ``(worlds, wants)``."""
    import torch

    from bitdelta_tpu.core.compress import compress_model
    from bitdelta_tpu.models import config as cfgs
    from bitdelta_tpu.models import llama as jl
    from bitdelta_tpu.research.quantized_base import (quantize_base,
                                                      roundtrip_base)

    worlds, wants = {}, {}
    cfg = cfgs.tiny_test_config(vocab_size=128, hidden_size=256,
                                intermediate_size=1024, num_layers=2,
                                num_heads=4, num_kv_heads=4, dtype="float32")
    tcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    # bf16 values, so the bf16 checkpoint holds the fp32 base exactly.
    base = jax.tree.map(lambda x: x.astype(jnp.bfloat16).astype(jnp.float32),
                        jl.init_params(cfg, jax.random.PRNGKey(3),
                                       jnp.float32, scale=0.25))
    bf16_dir = write_checkpoint(root / "bf16", tcfg, _np_tree(base),
                                torch.bfloat16)
    vocabs = {t: compress_model(base, _vocab_finetune(cfg, base, 300 + v, v))
              for t, v in enumerate((128, 120, 100, 126))}
    paths = _write_tenants(root, "vocab", tcfg, vocabs.values())
    worlds["disk_vocab"] = dict(cfg=tcfg, base_dir=bf16_dir,
                                deltas=paths[:3])
    wants["disk_vocab"] = _jax_tokens(cfg, base, [vocabs[t] for t in range(3)],
                                      VOCAB_REQS)
    # Padded to 126 rows, which a model axis of 4 does not split.
    worlds["disk_vocab126"] = dict(cfg=tcfg, base_dir=bf16_dir,
                                   deltas=[paths[3], paths[2]])

    ce = [compress_model(base, _vocab_finetune(cfg, base, 400 + t, 128),
                         compress_embeddings=True) for t in range(2)]
    worlds["disk_ce"] = dict(cfg=tcfg, base_dir=write_checkpoint(
        root / "ce", tcfg, _np_tree(base), torch.float32, files=1),
        deltas=_write_tenants(root, "ce", tcfg, ce))
    wants["disk_ce"] = _jax_tokens(cfg, base, ce, W4_REQS)

    mcfg, mbase, mtenants = mixtral
    worlds["disk_mixtral"] = dict(
        cfg=mcfg, base_dir=write_checkpoint(root / "mixtral", mcfg,
                                            _np_tree(mbase), torch.float32),
        deltas=_write_tenants(root, "mixtral", mcfg, mtenants),
        model="mixtral")

    for name, (wcfg, dense, tenants) in w4.items():
        jcfg = cfgs.tiny_test_config(**{
            f: getattr(wcfg, f) for f in ("vocab_size", "hidden_size",
                                          "intermediate_size", "num_layers",
                                          "num_heads", "num_kv_heads",
                                          "dtype")})
        ckpt = write_checkpoint(root / name, wcfg, _np_tree(dense),
                                torch.float32)
        worlds[name] = dict(cfg=wcfg, base_dir=ckpt, base_quant="int4",
                            deltas=_write_tenants(root, name, wcfg,
                                                  [c for _, c in tenants],
                                                  "int4"))
        if name == "disk_w4":
            deq8 = roundtrip_base(dense, "int8", jnp.float32)
            w8 = [compress_model(deq8, fine) for fine, _ in tenants]
            worlds["disk_w8"] = dict(cfg=wcfg, base_dir=ckpt,
                                     base_quant="int8",
                                     deltas=_write_tenants(root, "w8", wcfg,
                                                           w8, "int8"))
            wants["disk_w8"] = _jax_tokens(jcfg, quantize_base(dense, "int8"),
                                           w8, W4_REQS)
    return worlds, wants


def _engine_case(cid, world, mesh, kernel, reqs, max_slots, kv_dtype=None):
    return dict(kind="engine", id=cid, world=world, mesh=mesh, kernel=kernel,
                requests=reqs, max_slots=max_slots, kv_dtype=kv_dtype)


# (case id, world, mesh, kernel, kv_dtype): llama on every mesh and route.
LLAMA_CASES = [(f"llama_ce{int(ce)}_{dp}x{tp}_{k}", f"llama{int(ce)}",
                (dp, tp), k)
               for dp, tp in ((2, 4), (1, 2), (2, 1))
               for ce in (False, True) for k in ("torch", "cuda")]
LLAMA_CASES.append(("llama_ce0_2x4_cuda_fused", "llama0", (2, 4),
                    "cuda_fused"))
INT8_CASES = [(f"int8_{dp}x{tp}_cuda", "llama0", (dp, tp), "cuda")
              for dp, tp in ((2, 4), (1, 2))]
MIXTRAL_CASES = [(f"mixtral_{dp}x{tp}_{k}", "mixtral", (dp, tp), k)
                 for dp, tp in ((2, 2), (1, 2)) for k in ("torch", "cuda")]
W4_CASES = [(f"w4_1x2_{k}", "w4", (1, 2), k) for k in ("torch", "cuda")]
ALL_CASES = LLAMA_CASES + INT8_CASES + MIXTRAL_CASES + W4_CASES
# Worlds written to disk, each rank loading its own shard.
DISK_REQS = {"disk_vocab": VOCAB_REQS, "disk_ce": W4_REQS,
             "disk_mixtral": MIXTRAL_REQS, "disk_w4": W4_REQS,
             "disk_w8": W4_REQS}
DISK_ENGINE_CASES = [("disk_vocab_1x2_cuda", "disk_vocab", (1, 2), "cuda"),
                     ("disk_vocab_2x2_torch", "disk_vocab", (2, 2), "torch"),
                     ("disk_ce_1x2_cuda", "disk_ce", (1, 2), "cuda"),
                     ("disk_mixtral_2x2_cuda", "disk_mixtral", (2, 2),
                      "cuda"),
                     ("disk_w4_1x2_cuda", "disk_w4", (1, 2), "cuda"),
                     ("disk_w8_1x2_cuda", "disk_w8", (1, 2), "cuda")]
DISK_LOAD_CASES = [(f"load_{w[5:]}_{dp}x{tp}", w, (dp, tp))
                   for w, meshes in (("disk_vocab", ((1, 2), (2, 2), (1, 4))),
                                     ("disk_ce", ((1, 2), (1, 4))),
                                     ("disk_mixtral", ((1, 2), (2, 2))),
                                     ("disk_w4", ((1, 2), (2, 2))),
                                     ("disk_w8", ((1, 2), (2, 2))))
                   for dp, tp in meshes]
DISK_REFUSALS = [("vocab126_1x4", "disk_vocab126", (1, 4)),
                 ("disk_w4_misaligned", "disk_w4_misaligned", (1, 2))]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """JAX's references, then the three rank worlds: ``{case id: (got,
    want)}`` for the engine cases, ``{case id: message}`` for refusals."""
    worlds, wants = {}, {}
    for ce in (False, True):
        jcfg, jstack, want, cfg = _llama_world(ce)
        worlds[f"llama{int(ce)}"] = dict(cfg=cfg, stack=_port(jstack))
        wants[f"llama{int(ce)}"] = want
        if not ce:
            wants["int8"] = _int8_tokens(jcfg, jstack)
    stack, want, cfg, mbase, mtenants = _mixtral_world()
    worlds["mixtral"] = dict(cfg=cfg, stack=_port(stack), model="mixtral")
    wants["mixtral"] = wants["disk_mixtral"] = want
    mixtral = (cfg, mbase, mtenants)
    stack, want, cfg, dense, tenants = _w4_world(hidden_size=256,
                                                 intermediate_size=512)
    worlds["w4"] = dict(cfg=cfg, stack=_port(stack))
    wants["w4"] = wants["disk_w4"] = want
    w4 = {"disk_w4": (cfg, dense, tenants)}
    stack, _, cfg, dense, tenants = _w4_world()   # o_proj K = 128: one group
    worlds["w4_misaligned"] = dict(cfg=cfg, stack=_port(stack))
    w4["disk_w4_misaligned"] = (cfg, dense, tenants)
    disk, disk_wants = _disk_worlds(tmp_path_factory.mktemp("disk"),
                                    mixtral, w4)
    worlds.update(disk)
    wants.update(disk_wants)

    by_size = {8: [], 2: [], 4: []}
    for cid, world, mesh, kernel in ALL_CASES:
        if cid.startswith("int8"):
            case = _engine_case(cid, world, mesh, kernel, KV_REQS, 4, "int8")
        elif world == "mixtral":
            case = _engine_case(cid, world, mesh, kernel, MIXTRAL_REQS, 2)
        elif world == "w4":
            case = _engine_case(cid, world, mesh, kernel, W4_REQS, 2)
        else:
            case = _engine_case(cid, world, mesh, kernel, LLAMA_REQS, 4)
        by_size[mesh[0] * mesh[1]].append(case)
    by_size[8].append(dict(kind="refuse", id="max_slots_3", world="llama0",
                           mesh=(2, 4), kernel="torch", max_slots=3))
    by_size[2].append(dict(kind="refuse", id="w4_misaligned",
                           world="w4_misaligned", mesh=(1, 2),
                           kernel="cuda", max_slots=2))
    for cid, world, mesh, kernel in DISK_ENGINE_CASES:
        by_size[mesh[0] * mesh[1]].append(_engine_case(
            cid, world, mesh, kernel, DISK_REQS[world], 2))
    for cid, world, mesh in DISK_LOAD_CASES:
        by_size[mesh[0] * mesh[1]].append(dict(
            kind="shard_load", id=cid, world=world, mesh=mesh))
    for cid, world, mesh in DISK_REFUSALS:
        by_size[mesh[0] * mesh[1]].append(dict(
            kind="refuse", id=cid, world=world, mesh=mesh, kernel="cuda",
            max_slots=2))
    results, every_rank = {}, {}
    for size, cases in by_size.items():
        need = {c["world"] for c in cases}
        job = dict(worlds={k: v for k, v in worlds.items() if k in need},
                   cases=cases)
        ranks = spawn_world(job, size, tmp_path_factory.mktemp(f"w{size}"))
        results.update(ranks[0])
        for cid, _, _ in DISK_LOAD_CASES:
            if cid in ranks[0]:
                every_rank[cid] = [r[cid] for r in ranks
                                   if r[cid] is not None]
    out = {}
    for cid, world, _, _ in ALL_CASES + DISK_ENGINE_CASES:
        key = "int8" if cid.startswith("int8") else world
        out[cid] = (results[cid], wants[key])
    for cid in ("max_slots_3", "w4_misaligned") + tuple(
            c[0] for c in DISK_REFUSALS):
        out[cid] = results[cid]
    out.update(every_rank)
    return out


@pytest.mark.parametrize("cid", [c[0] for c in ALL_CASES])
def test_mesh_engine_matches_jax_single_device(mesh_run, cid):
    got, want = mesh_run[cid]
    assert got == want


def test_mesh_worlds_serve_distinct_tenants(mesh_run):
    # The tokens differ between tenants, so a mixed-up tenant would show.
    for cid in ("mixtral_2x2_torch", "w4_1x2_cuda"):
        _, want = mesh_run[cid]
        assert want[0] != want[1]


def test_mesh_engine_refuses_max_slots_off_the_data_axis(mesh_run):
    assert mesh_run["max_slots_3"] == (
        "max_slots 3 must be a multiple of the data axis (2)")


def test_mesh_engine_refuses_w4_groups_split_across_ranks(mesh_run):
    assert "INT4_GROUP" in mesh_run["w4_misaligned"]
    assert "o_proj" in mesh_run["w4_misaligned"]


@pytest.mark.parametrize("cid", [c[0] for c in DISK_ENGINE_CASES])
def test_mesh_engine_on_shards_loaded_from_disk_matches_jax(mesh_run, cid):
    """Each rank builds its stack from its own blocks of the checkpoint
    and the artifacts; the meshed engine's tokens are JAX's single-device
    engine's on the same weights."""
    got, want = mesh_run[cid]
    assert got == want


@pytest.mark.parametrize("cid", [c[0] for c in DISK_LOAD_CASES])
def test_loaded_shard_is_the_whole_stacks_shard_bit_for_bit(mesh_run, cid):
    """Every rank's ``load_stack_shard``, paired for its model axis,
    against ``shard_stack(to_pair_layout(whole, tp=tp))`` of the stack
    one process reads whole: every leaf, the quantized base's and the
    pair layout's included, equal in dtype and every bit."""
    mesh = next(m for c, _, m in DISK_LOAD_CASES if c == cid)
    results = mesh_run[cid]
    assert len(results) == mesh[0] * mesh[1]
    for r in results:
        assert r["leaves"] > 0 and r["differ"] == []


@pytest.mark.parametrize("cid", [c[0] for c in DISK_LOAD_CASES])
def test_engine_pairs_a_loaded_shard_in_place(mesh_run, cid):
    """``Engine(mesh=)`` on a ``StackShard`` pairs the loaded shard in
    place, so a rank never holds its canonical and its paired deltas
    together: afterwards the ``StackShard`` itself holds the whole
    stack's paired shard, bit for bit, and a second engine built on it
    passes the shape check and shares the first one's deltas."""
    for r in mesh_run[cid]:
        assert r["in_place"]["leaves"] > 0 and r["in_place"]["differ"] == []
        assert r["shared"]


def test_mesh_vocab_tenants_differ(mesh_run):
    # Three vocabularies (128, 120, 100): each tenant's tokens its own.
    _, want = mesh_run["disk_vocab_1x2_cuda"]
    assert len({tuple(w) for w in want}) == 3


def test_loader_refuses_a_padded_vocab_the_model_axis_does_not_split(
        mesh_run):
    assert mesh_run["vocab126_1x4"] == (
        "padded vocab 126 must be a multiple of the model axis (4); "
        "re-pad the tenant stack")


def test_loader_refuses_w4_groups_split_across_ranks(mesh_run):
    assert "INT4_GROUP" in mesh_run["disk_w4_misaligned"]
    assert "o_proj" in mesh_run["disk_w4_misaligned"]
