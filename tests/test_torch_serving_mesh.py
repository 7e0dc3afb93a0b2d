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
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bitdelta_torch.convert import stack_from_numpy
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.models.mixtral import MixtralConfig
from tests.test_serving_mesh import _make_world, _run
from tests.torch_mesh_worker import spawn_world

LLAMA_REQS = [dict(prompt_ids=[3, 5, 7, 9, 11], tenant_id=0,
                   max_new_tokens=6),
              dict(prompt_ids=[2, 4, 6], tenant_id=1, max_new_tokens=6),
              dict(prompt_ids=[8, 8, 8, 8], tenant_id=0, max_new_tokens=4)]
KV_REQS = LLAMA_REQS[:2]
MIXTRAL_REQS = [dict(prompt_ids=[5, 11, 3, 7], tenant_id=t,
                     max_new_tokens=5) for t in range(2)]
W4_REQS = [dict(prompt_ids=[3, 9, 4], tenant_id=t, max_new_tokens=6)
           for t in range(2)]


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
            MixtralConfig.from_dict(dataclasses.asdict(cfg)))


def _w4_world(**sizes):
    from bitdelta_tpu.serving.engine import Engine
    from bitdelta_tpu.serving.stacking import stack_tenants
    from tests.test_research import _w4_world as jw4

    cfg, _, qbase, _, tenants = jw4(**sizes)
    stack = stack_tenants(cfg, qbase, [c for _, c in tenants])
    want = Engine(cfg, stack, max_slots=2, max_seq=64, prefill_buckets=(16,),
                  kernel="xla", compute_dtype=jnp.float32
                  ).generate(_jreqs(W4_REQS))
    return (stack, _ints(want),
            ModelConfig.from_dict(dataclasses.asdict(cfg)))


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
    stack, want, cfg = _mixtral_world()
    worlds["mixtral"] = dict(cfg=cfg, stack=_port(stack), model="mixtral")
    wants["mixtral"] = want
    stack, want, cfg = _w4_world(hidden_size=256, intermediate_size=512)
    worlds["w4"] = dict(cfg=cfg, stack=_port(stack))
    wants["w4"] = want
    stack, _, cfg = _w4_world()          # o_proj K = 128: one group
    worlds["w4_misaligned"] = dict(cfg=cfg, stack=_port(stack))

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
    results = {}
    for size, cases in by_size.items():
        need = {c["world"] for c in cases}
        job = dict(worlds={k: v for k, v in worlds.items() if k in need},
                   cases=cases)
        results.update(spawn_world(job, size,
                                   tmp_path_factory.mktemp(f"w{size}"))[0])
    out = {}
    for cid, world, _, _ in ALL_CASES:
        key = "int8" if cid.startswith("int8") else world
        out[cid] = (results[cid], wants[key])
    out["max_slots_3"] = results["max_slots_3"]
    out["w4_misaligned"] = results["w4_misaligned"]
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
