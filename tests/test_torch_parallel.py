"""PyTorch port: ``parallel/{mesh,collectives,sharding}.py``,
``to_pair_layout(tp=)``, the models' ``tp_group`` branches and the
engine's leader / follower replay, against the JAX package on the CPU.

Spec tables, shard shapes, word alignment and the pair layout's per-shard
colsums are checked in this process (a rank's view of a mesh is its
shape, axis names and coordinate, which :class:`_Rank` stands in for).
The sharded forward / decode logits and the replay run on a 4-rank gloo
world (``tests/torch_mesh_worker.py``) against JAX's single-device model
and the port's single-device engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bitdelta_tpu.models import config as jcfgs
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.parallel import sharding as jsh
from bitdelta_torch.cli import args as cli_args
from bitdelta_torch.convert import (params_from_numpy, stack_from_numpy,
                                    tree_from_numpy)
from bitdelta_torch.core.delta import PairedBinaryDelta
from bitdelta_torch.models import llama
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.ops.packing import pack_signs, unpack_signs
from bitdelta_torch.parallel import collectives, mesh as pmesh
from bitdelta_torch.parallel import sharding as psh
from bitdelta_torch.serving import stacking as tst
from bitdelta_torch.serving.engine import Engine
from tests.torch_mesh_worker import replay_script, spawn_world


class _Rank:
    """One rank's view of a ``(data, model)`` mesh: what the sharding
    functions read of a DeviceMesh."""

    mesh_dim_names = (pmesh.DATA_AXIS, pmesh.MODEL_AXIS)

    def __init__(self, shape, coord):
        self.shape, self._coord = tuple(shape), tuple(coord)

    def get_local_rank(self, axis):
        return self._coord[self.mesh_dim_names.index(axis)]


def _ranks(shape):
    return [_Rank(shape, (d, m)) for d in range(shape[0])
            for m in range(shape[1])]


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _tcfg(cfg):
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def _plain(tree):
    """A spec tree with JAX's PartitionSpecs and NamedTuples as plain
    tuples and (class name, fields)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, P):
        return tuple(tree)
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(_plain(v) for v in tree))
    return tuple(tree)


def _sharding_cfg():
    # tests/test_sharding.py's config.
    return jcfgs.tiny_test_config(vocab_size=256, hidden_size=128,
                                  intermediate_size=256, num_layers=2,
                                  num_heads=8, num_kv_heads=4)


def _mesh_world(compress_embeddings=False):
    # tests/test_serving_mesh.py's world (K and N split 4 ways).
    from tests.test_serving_mesh import _make_world

    return _make_world(compress_embeddings=compress_embeddings)


def _mixtral_cfg():
    from tests.test_mixtral import _tp_world

    return _tp_world()


@pytest.fixture(scope="module")
def stacks():
    """JAX serving stacks and their port copies: llama with and without
    compressed embeddings, Mixtral, W8 and W4 bases."""
    from bitdelta_tpu.core.compress import compress_model
    from bitdelta_tpu.models import mixtral as mx
    from bitdelta_tpu.research.quantized_base import quantize_base
    from bitdelta_tpu.serving.stacking import stack_tenants
    from tests.test_mixtral import _finetune

    out = {}
    for ce in (False, True):
        cfg, stack = _mesh_world(ce)
        out[f"llama{int(ce)}"] = (cfg, stack)
    mcfg, mbase = _mixtral_cfg()
    out["mixtral"] = (mcfg, stack_tenants(
        mcfg, mbase, [mx.compress_mixtral(mbase, _finetune(mbase, 5))]))
    cfg, _ = out["llama0"]
    base = jl.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    for quant in ("int8", "int4"):
        qbase = quantize_base(base, quant)
        out[quant] = (cfg, stack_tenants(cfg, qbase,
                                         [compress_model(base, base)]))
    return {k: (cfg, st, stack_from_numpy(_np_tree(st), "cpu"))
            for k, (cfg, st) in out.items()}


# ---------------------------------------------------------------------------
# Spec tables
# ---------------------------------------------------------------------------

def _tables(stacks):
    from bitdelta_tpu.serving.stacking import to_pair_layout as jpair

    cfg = _sharding_cfg()
    tied = dataclasses.replace(cfg, tie_word_embeddings=True)
    from bitdelta_torch.models.mixtral import MixtralConfig

    mcfg, _ = _mixtral_cfg()
    tmcfg = MixtralConfig.from_dict(dataclasses.asdict(mcfg))
    tables = {
        "param_specs": [(psh.param_specs(_tcfg(c)), jsh.param_specs(c))
                        for c in (cfg, tied)],
        "param_specs_mixtral": [(psh.param_specs(tmcfg),
                                 jsh.param_specs(mcfg))],
        "delta_specs": [
            (psh.delta_specs(_tcfg(cfg), ts, keys=keys),
             jsh.delta_specs(cfg, ts, keys=keys))
            for ts in (False, True)
            for keys in (None, ("q_proj", "down_proj", "embed", "lm_head"))],
        "delta_specs_mixtral": [(psh.delta_specs(tmcfg, ts),
                                 jsh.delta_specs(mcfg, ts))
                                for ts in (False, True)],
        "extras_specs": [(psh.extras_specs(_tcfg(cfg), keys),
                          jsh.extras_specs(cfg, keys))
                         for keys in (None, ("embed", "final_norm",
                                             "q_bias", "v_bias"))],
        "cache_specs": [((psh.cache_spec(), psh.cache_scale_spec(),
                          psh.batch_spec()),
                         (jsh.cache_spec(), jsh.cache_scale_spec(),
                          jsh.batch_spec()))],
        "serving_delta_specs": [],
        "serving_param_specs": [],
    }
    for key, (jcfg, jstack, tstack) in stacks.items():
        for tp in (1, 2):
            jp = jpair(jstack, tp=tp).deltas
            tp_ = tst.to_pair_layout(tstack, tp=tp).deltas
            tables["serving_delta_specs"].append(
                (psh.serving_delta_specs(tp_), jsh.serving_delta_specs(jp)))
            tables["serving_param_specs"].append(
                (psh.serving_param_specs(cfg, tstack.params, tp=tp),
                 jsh.serving_param_specs(jcfg, jstack.params, tp=tp)))
        tables["serving_delta_specs"].append(
            (psh.serving_delta_specs(tstack.deltas),
             jsh.serving_delta_specs(jstack.deltas)))
    return tables


TABLES = ("param_specs", "param_specs_mixtral", "delta_specs",
          "delta_specs_mixtral", "extras_specs", "cache_specs",
          "serving_delta_specs", "serving_param_specs")


@pytest.fixture(scope="module")
def tables(stacks):
    return _tables(stacks)


@pytest.mark.parametrize("table", TABLES)
def test_spec_tables_equal_jax(tables, table):
    assert tables[table]
    for got, want in tables[table]:
        assert _plain(got) == _plain(want)


def test_axis_names_and_table_names_match_jax():
    from bitdelta_tpu.parallel import mesh as jmesh

    assert (pmesh.DATA_AXIS, pmesh.MODEL_AXIS) == (jmesh.DATA_AXIS,
                                                   jmesh.MODEL_AXIS)
    for name in ("COLUMN_PARALLEL", "ROW_PARALLEL", "EXPERT_COLUMN_PARALLEL",
                 "EXPERT_ROW_PARALLEL"):
        assert getattr(psh, name) == getattr(jsh, name)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

def test_local_shard_shapes():
    cfg = _tcfg(_sharding_cfg())
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    sp = psh.shard_model(cfg, params, _Rank((1, 8), (0, 3)))
    assert tuple(sp["layers"]["q_proj"].shape) == (
        cfg.num_layers, cfg.hidden_size, cfg.q_dim // 8)
    assert tuple(sp["layers"]["o_proj"].shape) == (
        cfg.num_layers, cfg.q_dim // 8, cfg.hidden_size)
    assert tuple(sp["embed"].shape) == (cfg.vocab_size // 8, cfg.hidden_size)
    assert tuple(sp["lm_head"].shape) == (cfg.hidden_size,
                                          cfg.vocab_size // 8)


def test_serving_stack_and_cache_shard_shapes(stacks):
    jcfg, _, tstack = stacks["llama0"]
    cfg = _tcfg(jcfg)
    rank = _Rank((2, 4), (1, 2))
    local = psh.shard_stack(cfg, tst.to_pair_layout(tstack, tp=4), rank)
    gate = tstack.params["layers"]["gate_proj"]
    assert local.params["layers"]["gate_proj"].shape[-1] == gate.shape[-1] // 4
    # gate_proj pairs on its local N (256); q_proj (local N 64) stays
    # canonical; down_proj's colsum is its own K shard's.
    g = local.deltas["gate_proj"]
    assert isinstance(g, PairedBinaryDelta)
    assert g.packed_pairs.shape[-1] * 2 == gate.shape[-1] // 4
    assert not isinstance(local.deltas["q_proj"], PairedBinaryDelta)
    assert tuple(local.deltas["down_proj"].colsum.shape) == (
        cfg.num_layers, tstack.num_tenants, 1, cfg.hidden_size)
    assert local.params["embed"].shape[-2] == cfg.vocab_size // 4
    cache = llama.init_cache(cfg, 4, 16, torch.float32, "cpu",
                             kv_dtype="int8")
    lc = psh.shard_cache(cache, rank)
    assert lc.k.shape[1] == 2 and lc.k.shape[3] == cfg.num_kv_heads // 4
    assert tuple(lc.k_scale.shape) == (cfg.num_layers, 2, 16,
                                       cfg.num_kv_heads // 4)
    assert tuple(lc.length.shape) == (2,)
    for t in (*local.params["layers"].values(), *local.deltas["down_proj"]):
        assert t.is_contiguous()


def test_row_parallel_words_are_contiguous_k_slices():
    """tests/test_sharding.py::test_packed_delta_k_sharding_is_word_aligned
    on the port: shard 0 of down_proj's words is a local repack of the
    first K/4 rows, bit-exact, and equals JAX's shard 0."""
    from bitdelta_tpu.core.compress import compress_model
    from bitdelta_tpu.parallel import mesh as jmesh

    jcfg = _sharding_cfg()
    base = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    fine = dict(base)
    fine["layers"] = {k: v + 0.02 * jax.random.normal(
        jax.random.PRNGKey(i), v.shape) if k in jl.PROJ_NAMES else v
        for i, (k, v) in enumerate(base["layers"].items())}
    jdeltas = compress_model(base, fine).deltas
    deltas = params_from_numpy(_np_tree(jdeltas), "cpu")
    cfg = _tcfg(jcfg)
    down = psh.shard_deltas(cfg, deltas, _Rank((1, 4), (0, 0)))["down_proj"]
    k = cfg.intermediate_size
    assert tuple(down.packed.shape) == (cfg.num_layers, k // 32 // 4,
                                        cfg.hidden_size)
    full = unpack_signs(deltas["down_proj"].packed)
    np.testing.assert_array_equal(down.packed.numpy(),
                                  pack_signs(full[:, : k // 4]).numpy())
    jmesh4 = jmesh.make_mesh((1, 4), devices=jax.devices()[:4])
    jdown = jsh.shard_deltas(jcfg, jdeltas, jmesh4)["down_proj"]
    shard0 = [s.data for s in jdown.packed.addressable_shards
              if s.index[1].start in (0, None)][0]
    np.testing.assert_array_equal(down.packed.numpy(), np.asarray(shard0))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_shards_reassemble_every_leaf(stacks, shape):
    jcfg, _, tstack = stacks["llama1"]
    cfg = _tcfg(jcfg)
    full = tst.to_pair_layout(tstack, tp=shape[1])
    specs = (psh.serving_param_specs(cfg, full.params, tp=shape[1]),
             psh.serving_delta_specs(full.deltas))
    trees = (full.params, full.deltas)
    blocks = [tuple(psh.shard_tree(t, sp, r) for t, sp in zip(trees, specs))
              for r in _ranks(shape)]
    dp, tp = shape

    def whole_from(parts, spec):
        """Ranks' blocks (data major) put back together under spec."""
        grid = [parts[d * tp:(d + 1) * tp] for d in range(dp)]
        if pmesh.MODEL_AXIS in spec:
            rows = [torch.cat(r, spec.index(pmesh.MODEL_AXIS)) for r in grid]
        else:
            assert all(torch.equal(r[0], x) for r in grid for x in r)
            rows = [r[0] for r in grid]
        if pmesh.DATA_AXIS in spec:
            return torch.cat(rows, spec.index(pmesh.DATA_AXIS))
        assert all(torch.equal(rows[0], x) for x in rows)
        return rows[0]

    def check(whole, parts, spec):
        if isinstance(whole, dict):
            for k in whole:
                check(whole[k], [p[k] for p in parts], spec[k])
        elif hasattr(whole, "_fields"):
            for i in range(len(whole)):
                check(whole[i], [p[i] for p in parts], spec[i])
        else:
            assert torch.equal(whole_from(parts, spec), whole)
            assert all(p.is_contiguous() for p in parts)
    for i in range(2):
        check(trees[i], [b[i] for b in blocks], specs[i])


def test_shard_stack_to_a_device_moves_only_the_blocks(stacks):
    """``shard_stack(device=)``, as a meshed engine calls it on a stack
    left on the host: every leaf's block lands on ``device`` (the meta
    device here, the card there) with the shape and dtype of the block
    kept on the stack's own device, and vocab_sizes goes along."""
    jcfg, _, tstack = stacks["llama0"]
    cfg = _tcfg(jcfg)
    full = tst.to_pair_layout(tstack, tp=4)
    rank = _Rank((2, 4), (1, 2))
    here = psh.shard_stack(cfg, full, rank)
    there = psh.shard_stack(cfg, full, rank, device="meta")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, tuple):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    a = leaves((here.params, here.deltas))
    b = leaves((there.params, there.deltas))
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert y.device.type == "meta" and x.device.type == "cpu"
        assert y.shape == x.shape and y.dtype == x.dtype
    assert there.vocab_sizes.device.type == "meta"
    assert here.vocab_sizes is full.vocab_sizes


# ---------------------------------------------------------------------------
# Pair layout under TP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("source", ["canonical", "paired"])
def test_to_pair_layout_tp_matches_jax(stacks, tp, source):
    """tests/test_pallas_kernels.py:409-412 on the port: from canonical
    stacks and from stacks paired at tp=1 (a full-K colsum the conversion
    must rebuild), words and per-shard colsums bit-exact with JAX's."""
    from bitdelta_tpu.serving.stacking import to_pair_layout as jpair

    for key in ("llama0", "mixtral"):
        _, jstack, tstack = stacks[key]
        if source == "paired":
            jstack, tstack = jpair(jstack, tp=1), tst.to_pair_layout(tstack)
        want = jpair(jstack, tp=tp)
        got = tst.to_pair_layout(tstack, tp=tp)
        assert sorted(got.deltas) == sorted(want.deltas)
        for name, w in want.deltas.items():
            g = got.deltas[name]
            assert type(g).__name__ == type(w).__name__, name
            for gf, wf in zip(g, w):
                np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
        for name in ("o_proj", "down_proj", "w2"):
            if name in got.deltas and isinstance(got.deltas[name],
                                                 PairedBinaryDelta):
                d = got.deltas[name]
                assert d.colsum.shape[-2] == tp
                assert d.colsum.ndim == d.packed_pairs.ndim


def test_to_pair_layout_at_tp1_is_unchanged(stacks):
    _, _, tstack = stacks["llama1"]
    a = tst.to_pair_layout(tstack)
    b = tst.to_pair_layout(tstack, tp=1)
    for name in a.deltas:
        for x, y in zip(a.deltas[name], b.deltas[name]):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The (T, 1, N) colsum of a row-parallel pair shard
# ---------------------------------------------------------------------------

def _fresh_pair(d):
    """The pair layout a single device builds from this rank's local
    canonical words: its colsum is ``(T, N)`` over the local K rows."""
    from bitdelta_torch.core.delta import BinaryDelta, pair_delta
    from bitdelta_torch.ops.packing import unpair_packed

    return pair_delta(BinaryDelta(unpair_packed(d.packed_pairs), d.scale))


@pytest.mark.parametrize("kernel", ["cuda", "cuda_fused"])
@pytest.mark.parametrize("name", ["o_proj", "down_proj"])
def test_row_parallel_pair_shard_colsum_is_squeezed(stacks, kernel, name):
    """A rank's row-parallel pair delta carries its K shard's colsum as
    ``(T, 1, N)``; the decode projection must hand rows 1 / 10 ``(T, N)``
    (their wrappers refuse anything else) and compute exactly what one
    device computes on the local K rows."""
    jcfg, _, tstack = stacks["llama0"]
    cfg = _tcfg(jcfg)
    for coord in range(2):
        local = psh.shard_stack(cfg, tst.to_pair_layout(tstack, tp=2),
                                _Rank((1, 2), (0, coord)))
        d = llama._layer_delta(local.deltas[name], 1)
        assert tuple(d.colsum.shape) == (tstack.num_tenants, 1,
                                         cfg.hidden_size)
        fresh = _fresh_pair(d)
        assert torch.equal(d.colsum[:, 0], fresh.colsum)
        w = local.params["layers"][name][1]
        x = torch.randn((3, 1, w.shape[0]),
                        generator=torch.Generator().manual_seed(coord))
        tids = torch.tensor([1, 0, 1])
        got = llama._proj(x, w, d, tids, torch.float32, kernel)
        want = llama._proj(x, w, fresh, tids, torch.float32, kernel)
        assert torch.equal(got, want)


def test_routed_expert_pair_shard_colsum_is_squeezed():
    """The same for Mixtral's routed w2 delta, (tenant, expert) flattened:
    ``(T*E, 1, N)`` goes to row 1 as ``(T*E, N)``."""
    from bitdelta_torch.models import mixtral

    cfg = mixtral.MixtralConfig(vocab_size=64, hidden_size=256,
                                intermediate_size=256, num_layers=1,
                                num_heads=2, num_kv_heads=2, max_seq_len=64,
                                num_experts=2, experts_per_token=1,
                                dtype="float32")
    gen = torch.Generator().manual_seed(0)
    base = mixtral.init_params(cfg, gen, device="cpu")
    tenants = []
    for _ in range(2):
        fine = dict(base)
        fine["layers"] = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
                          for k, v in base["layers"].items()}
        tenants.append(mixtral.compress_mixtral(base, fine))
    stack = tst.stack_tenants(cfg, base, tenants, device="cpu")
    local = psh.shard_stack(cfg, tst.to_pair_layout(stack, tp=2),
                            _Rank((1, 2), (0, 1)))
    d = llama._layer_delta(local.deltas["w2"], 0)
    assert tuple(d.colsum.shape) == (2, cfg.num_experts, 1, cfg.hidden_size)
    flat = mixtral._flatten_stack(d, 2)
    ids = torch.tensor([0, 3, 1])
    x = torch.randn((3, cfg.intermediate_size // 2), generator=gen)
    got = mixtral._routed_expert_delta(x, flat, ids, torch.float32, "cuda")
    want = mixtral._routed_expert_delta(x, _fresh_pair(flat), ids,
                                        torch.float32, "cuda")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Mesh, collectives, CLI
# ---------------------------------------------------------------------------

def test_make_mesh_refuses_more_ranks_than_the_world():
    with pytest.raises(ValueError, match="needs 9 devices"):
        pmesh.make_mesh((3, 3), device="cpu")
    mesh = pmesh.make_mesh((1, 1), device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert collectives.axis_size(mesh, "model") == 1


def test_collectives_are_no_ops_without_an_axis():
    x = torch.arange(6.0).reshape(2, 3)
    assert collectives.psum(x, None) is x
    assert collectives.all_gather(x, None, "model", -1) is x
    assert collectives.axis_index(None, "data") == 0


def test_parse_mesh():
    assert cli_args.parse_mesh("2,4") == (2, 4)
    assert cli_args.parse_mesh("1,1") == (1, 1)
    assert cli_args.parse_mesh(None) is None


# ---------------------------------------------------------------------------
# On a 4-rank gloo world
# ---------------------------------------------------------------------------

LOGIT_CASES = [((2, 2), "torch"), ((2, 2), "cuda"), ((1, 4), "torch"),
               ((1, 4), "cuda")]


@pytest.fixture(scope="module")
def world4(stacks, tmp_path_factory):
    """Sharded forward / decode logits on (2, 2) and (1, 4) against JAX's
    single-device ones (fp32; tests/test_sharding.py's world), and the
    replay at (2, 2) against the port's single-device engine."""
    from bitdelta_tpu.core.compress import compress_model, student_params

    jcfg = _sharding_cfg()
    base = jl.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    fine = dict(base)
    key = jax.random.PRNGKey(50)
    fine["layers"] = dict(base["layers"])
    for name in jl.PROJ_NAMES:
        key, sub = jax.random.split(key)
        fine["layers"][name] = base["layers"][name] + 0.02 * (
            jax.random.normal(sub, base["layers"][name].shape))
    comp = compress_model(base, fine)
    sp = student_params(base, comp)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (4, 12), dtype=np.int64)
    nxt = rng.integers(0, jcfg.vocab_size, (4, 1), dtype=np.int64)
    kw = dict(deltas=comp.deltas, compute_dtype=jnp.float32)
    want_fwd = np.asarray(jl.forward(jcfg, sp, jnp.asarray(toks), **kw))
    _, jcache = jl.forward(jcfg, sp, jnp.asarray(toks), return_cache=True,
                           cache_max_seq=16, **kw)
    want_dec, _ = jl.decode_step(jcfg, sp, jnp.asarray(nxt, jnp.int32),
                                 jcache, **kw)
    mcfg, mstack = stacks["llama0"][0], stacks["llama0"][2]
    worlds = {
        "model": dict(cfg=_tcfg(jcfg), params=tree_from_numpy(
            _np_tree(sp), "cpu"), deltas=tree_from_numpy(
                _np_tree(comp.deltas), "cpu")),
        "serve": dict(cfg=_tcfg(mcfg), stack=mstack)}
    cases = [dict(kind="logits", id=f"logits_{m[0]}x{m[1]}_{k}",
                  world="model", mesh=m, kernel=k,
                  tokens=torch.from_numpy(toks), next=torch.from_numpy(nxt))
             for m, k in LOGIT_CASES]
    cases.append(dict(kind="replay", id="replay", world="serve",
                      mesh=(2, 2), kernel="cuda", max_slots=4))
    cases += [dict(kind="roundtrip", id=f"roundtrip_{m[0]}x{m[1]}",
                   world="serve", mesh=m) for m in ((2, 2), (1, 4))]
    ranks = spawn_world(dict(worlds=worlds, cases=cases), 4,
                        tmp_path_factory.mktemp("world4"))
    single = Engine(_tcfg(mcfg), mstack, max_slots=4, max_seq=64,
                    prefill_buckets=(16,), kernel="cuda", device="cpu")
    return dict(ranks=ranks, want_fwd=want_fwd,
                want_dec=np.asarray(want_dec),
                want_replay=replay_script(single),
                single_state=single)


@pytest.mark.parametrize("mesh,kernel", LOGIT_CASES)
def test_sharded_forward_and_decode_match_jax(world4, mesh, kernel):
    got = world4["ranks"][0][f"logits_{mesh[0]}x{mesh[1]}_{kernel}"]
    np.testing.assert_allclose(got["forward"].numpy(), world4["want_fwd"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["decode"].numpy(), world4["want_dec"],
                               rtol=1e-5, atol=1e-5)
    # Every rank gathers the same logits.
    for r in world4["ranks"][1:]:
        assert torch.equal(r[f"logits_{mesh[0]}x{mesh[1]}_{kernel}"]
                           ["forward"], got["forward"])


def test_followers_replay_the_leaders_calls(world4):
    lead = world4["ranks"][0]["replay"]
    want = world4["want_replay"]
    for key in ("warmed", "pumped", "refused", "cancelled", "steps",
                "generated"):
        assert lead[key] == want[key], key
    assert lead["refused"] == "empty prompt"
    for r in world4["ranks"][1:]:
        assert r["replay"]["state"] == lead["state"]
    single = world4["single_state"]
    assert lead["state"]["slots"] == [
        (s.active, list(s.generated), s.tenant_id, s.epoch)
        for s in single.slots]


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_gather_tree_undoes_shard_stack_on_every_rank(world4, mesh):
    assert all(r[f"roundtrip_{mesh[0]}x{mesh[1]}"] is True
               for r in world4["ranks"])
