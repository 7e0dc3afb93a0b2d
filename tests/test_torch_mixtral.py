"""PyTorch port: Mixtral (the MoE decoder, its W8 expert base, expert
stacking, the artifact, the engine's ``model=`` hook and mean-expert
compression) against the JAX package on the CPU.

A tiny Mixtral (hidden 64, intermediate 256, 2 layers, 4 experts, top-2):
w1/w3 (N = 256) pair, while w2 (N = 64), the router and the attention
projections stay canonical, so a ``kernel="cuda"`` decode walks both
tenant delta kernels (their plain versions on CPU tensors) in one step.

Tolerances: compression and W8 quantization are bit-exact, except the
delta scales, fp32 means summed in different orders (rtol 1e-6, as
tests/test_torch_delta_artifact.py); artifacts cross both ways
bit-exact. Logits in fp32 agree to 2e-5 of the logit scale: against JAX
``kernel="xla"`` the port runs the same plain arithmetic, and against
JAX ``kernel="pallas"`` (interpret mode) the same x grids, with sums in
other orders (row 7's plain version sums the bit-plane products over the
whole K in int64, JAX per K block in fp32). Greedy tokens are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.models import mixtral as jmx
from bitdelta_tpu.research import quantized_base as jqb
from bitdelta_tpu.serving.stacking import stack_tenants as jstack
from bitdelta_tpu.serving.stacking import to_pair_layout as jpair
from bitdelta_torch.convert import params_from_numpy, stack_from_numpy, \
    to_numpy
from bitdelta_torch.core.delta import BinaryDelta, PairedBinaryDelta
from bitdelta_torch.models import mixtral as tmx
from bitdelta_torch.research import quantized_base as tqb
from bitdelta_torch.serving import stacking as tst

LOGIT_TOL = 2e-5
SCALE_RTOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _jcfg():
    return jmx.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=64, num_experts=4,
        experts_per_token=2, dtype="float32")


def _tcfg(cfg):
    return tmx.MixtralConfig.from_dict(dataclasses.asdict(cfg))


def _finetune(base, seed):
    """base + seeded numpy noise on every layer tensor and extra."""
    rng = np.random.default_rng(seed)
    fine = {k: v for k, v in base.items() if k != "layers"}
    fine["layers"] = {}
    for name, w in base["layers"].items():
        fine["layers"][name] = (w + 0.01 * rng.standard_normal(w.shape)
                                ).astype(np.float32)
    for name in ("embed", "lm_head", "final_norm"):
        fine[name] = (base[name] + 0.01 * rng.standard_normal(
            base[name].shape)).astype(np.float32)
    return fine


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.fixture(scope="module")
def world():
    cfg = _jcfg()
    base = _np_tree(jmx.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    fines = [_finetune(base, 100 + t) for t in range(2)]
    jtenants = [jmx.compress_mixtral(_jtree(base), _jtree(f)) for f in fines]
    stack = jstack(cfg, _jtree(base), jtenants)
    tstack = stack_from_numpy(_np_tree(stack), "cpu")
    return cfg, base, fines, jtenants, stack, tstack


def _assert_compressed_match(got, want):
    for name, d in want.deltas.items():
        np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                      np.array(d.packed))
        np.testing.assert_allclose(got.deltas[name].scale.numpy(),
                                   np.array(d.scale), rtol=SCALE_RTOL)
    _assert_tree_equal(got.extras, want.extras)


def test_compress_mixtral_matches_jax(world):
    cfg, base, fines, jtenants, _, _ = world
    got = tmx.compress_mixtral(params_from_numpy(base, "cpu"),
                               params_from_numpy(fines[0], "cpu"))
    assert sorted(got.deltas) == sorted(tmx.MOE_PARTS)
    # Expert deltas keep the expert axis.
    assert tuple(got.deltas["w1"].packed.shape) == (
        cfg.num_layers, cfg.num_experts, cfg.hidden_size // 32,
        cfg.intermediate_size)
    assert tuple(got.deltas["w2"].scale.shape) == (cfg.num_layers,
                                                   cfg.num_experts)
    _assert_compressed_match(got, jtenants[0])
    # With compressed embeddings the embed / head become deltas as well,
    # and the extras keep only the norms.
    got = tmx.compress_mixtral(params_from_numpy(base, "cpu"),
                               params_from_numpy(fines[0], "cpu"),
                               compress_embeddings=True)
    want = jmx.compress_mixtral(_jtree(base), _jtree(fines[0]),
                                compress_embeddings=True)
    assert sorted(got.deltas) == sorted(tmx.MOE_PARTS + ("embed", "lm_head"))
    assert "embed" not in got.extras and "lm_head" not in got.extras
    _assert_compressed_match(got, want)


def test_quantize_mixtral_base_matches_jax(world):
    cfg, base, _, _, _, _ = world
    want = jqb.quantize_mixtral_base_projections(_jtree(base))
    got = tqb.quantize_mixtral_base_projections(params_from_numpy(base, "cpu"))
    for name in tmx.ATTN_PROJS + tmx.EXPERT_MATS:
        assert isinstance(got["layers"][name], tqb.Int8Weight)
    assert isinstance(got["layers"]["router"], torch.Tensor)
    assert tuple(got["layers"]["w1"].scale.shape) == (
        cfg.num_layers, cfg.num_experts, cfg.intermediate_size)
    _assert_tree_equal(got, want)
    _assert_tree_equal(tqb.dequantize_base_projections(got, torch.float32),
                       jqb.dequantize_base_projections(want, jnp.float32))
    with_router = tqb.quantize_mixtral_base_projections(
        params_from_numpy(base, "cpu"), include_router=True)
    _assert_tree_equal(with_router["layers"]["router"],
                       jqb.quantize_mixtral_base_projections(
                           _jtree(base), include_router=True)
                       ["layers"]["router"])


def test_convert_carries_a_jax_mixtral_w8_tree(world):
    # Rank-4 expert stacks and Int8Weight leaves with (L, E, N) scales
    # cross as they stand.
    cfg, base, _, _, _, _ = world
    jq = _np_tree(jqb.quantize_mixtral_base_projections(_jtree(base)))
    got = params_from_numpy(jq, "cpu")
    assert isinstance(got["layers"]["w2"], tqb.Int8Weight)
    assert got["layers"]["w2"].q.dtype == torch.int8
    assert tuple(got["layers"]["w2"].q.shape) == (
        cfg.num_layers, cfg.num_experts, cfg.intermediate_size,
        cfg.hidden_size)
    _assert_tree_equal(got, jq)


def test_stack_and_pair_layout_match_jax(world):
    cfg, base, fines, jtenants, stack, _ = world
    tenants = [tmx.compress_mixtral(params_from_numpy(base, "cpu"),
                                    params_from_numpy(f, "cpu"))
               for f in fines]
    got = tst.stack_tenants(_tcfg(cfg), params_from_numpy(base, "cpu"),
                            tenants, device="cpu")
    # The tenant axis follows the layer axis; experts keep theirs.
    assert tuple(got.deltas["w1"].packed.shape) == (
        cfg.num_layers, 2, cfg.num_experts, cfg.hidden_size // 32,
        cfg.intermediate_size)
    _assert_tree_equal(got.params, stack.params)
    for name, d in stack.deltas.items():
        np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                      np.array(d.packed))
    paired = tst.to_pair_layout(got)
    for name in ("w1", "w3"):
        assert isinstance(paired.deltas[name], PairedBinaryDelta)
    for name in ("w2", "router") + tmx.ATTN_PROJS:
        assert isinstance(paired.deltas[name], BinaryDelta)
    want = jpair(stack)
    for name in ("w1", "w3"):
        np.testing.assert_array_equal(
            paired.deltas[name].packed_pairs.numpy(),
            np.array(want.deltas[name].packed_pairs))
        np.testing.assert_array_equal(paired.deltas[name].colsum.numpy(),
                                      np.array(want.deltas[name].colsum))
    # in_place replaces the entries of the stack's own dict.
    canon = dict(got.deltas)
    inplace = tst.to_pair_layout(got, in_place=True)
    assert inplace.deltas is got.deltas
    assert isinstance(got.deltas["w1"], PairedBinaryDelta)
    assert got.deltas["w2"] is canon["w2"]


def test_pair_layout_keeps_router_and_embed_canonical_by_name():
    # A router over 256 experts has N = 256, which would pair by shape;
    # JAX keeps "router" and "embed" canonical by name.
    rng = np.random.default_rng(3)
    packed = torch.from_numpy(rng.integers(-2**31, 2**31 - 1,
                                           (2, 3, 4, 256), dtype=np.int32))
    scale = torch.from_numpy(rng.uniform(size=(2, 3)).astype(np.float32))
    stack = tst.TenantStack(
        params={}, deltas={n: BinaryDelta(packed, scale)
                           for n in ("router", "embed", "q_proj")},
        vocab_sizes=torch.zeros(3, dtype=torch.int32), num_tenants=3)
    paired = tst.to_pair_layout(stack)
    assert paired.deltas["router"] is stack.deltas["router"]
    assert paired.deltas["embed"] is stack.deltas["embed"]
    assert isinstance(paired.deltas["q_proj"], PairedBinaryDelta)


def test_artifact_crosses_both_ways_with_a_mixtral_config(world, tmp_path):
    from bitdelta_tpu.core import artifact as jart
    from bitdelta_torch.core import artifact as tart

    cfg, _, _, jtenants, _, _ = world
    tcfg = _tcfg(cfg)
    comp = params_from_numpy(_np_tree(jtenants[1]), "cpu")
    path = str(tmp_path / "port.safetensors")
    tart.save_delta(path, comp, tcfg)
    back, jcfg_back = jart.load_delta(path)
    assert isinstance(jcfg_back, jmx.MixtralConfig) and jcfg_back == cfg
    _assert_tree_equal(comp.deltas, _np_tree(back.deltas))
    _assert_tree_equal(comp.extras, _np_tree(back.extras))
    path = str(tmp_path / "jax.safetensors")
    jart.save_delta(path, jtenants[1], cfg)
    got, tcfg_back = tart.load_delta(path, device="cpu")
    assert isinstance(tcfg_back, tmx.MixtralConfig) and tcfg_back == tcfg
    assert tcfg_back.num_experts == 4
    _assert_tree_equal(got.deltas, _np_tree(jtenants[1].deltas))
    _assert_tree_equal(got.extras, _np_tree(jtenants[1].extras))


def _inputs():
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, 256, (3, 12)).astype(np.int32)
    lengths = np.asarray([12, 9, 5], np.int32)
    ids = np.asarray([1, 0, 1], np.int32)
    nxt = rng.integers(1, 256, (3, 1)).astype(np.int32)
    return tokens, lengths, ids, nxt


def _run_jax(cfg, stack, kernel):
    from jax.experimental.pallas import tpu as pltpu

    tokens, lengths, ids, nxt = _inputs()
    with pltpu.force_tpu_interpret_mode():
        logits, cache = jmx.forward(
            cfg, stack.params, jnp.asarray(tokens),
            lengths=jnp.asarray(lengths), deltas=stack.deltas,
            tenant_ids=jnp.asarray(ids), compute_dtype=jnp.float32,
            return_cache=True, cache_max_seq=16, kernel=kernel)
        step, _ = jmx.decode_step(cfg, stack.params, jnp.asarray(nxt), cache,
                                  deltas=stack.deltas,
                                  tenant_ids=jnp.asarray(ids),
                                  compute_dtype=jnp.float32, kernel=kernel)
    return np.array(logits), np.array(step)


def _run_torch(cfg, tstack, kernel):
    tokens, lengths, ids, nxt = _inputs()
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    tcfg = _tcfg(cfg)
    logits, cache = tmx.forward(
        tcfg, tstack.params, t(tokens).long(), lengths=t(lengths),
        deltas=tstack.deltas, tenant_ids=t(ids).long(),
        compute_dtype=torch.float32, return_cache=True, cache_max_seq=16,
        kernel=kernel)
    step, cache2 = tmx.decode_step(tcfg, tstack.params, t(nxt).long(), cache,
                                   deltas=tstack.deltas,
                                   tenant_ids=t(ids).long(),
                                   compute_dtype=torch.float32, kernel=kernel)
    assert cache2.length.tolist() == (lengths + 1).tolist()
    return to_numpy(logits), to_numpy(step)


def _close(got, want):
    tol = LOGIT_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("layout,jkernel,tkernel",
                         [("canonical", "xla", "torch"),
                          ("canonical", "pallas", "cuda"),
                          ("paired", "pallas", "cuda")])
def test_forward_and_decode_match_jax(world, layout, jkernel, tkernel):
    # "cuda" on CPU tensors walks the kernel branches with the kernels'
    # plain versions: row 7 (canonical attention, w2, and w1/w3 in the
    # canonical layout) and row 1 (w1/w3 paired), as JAX's "pallas".
    cfg, _, _, _, stack, tstack = world
    if layout == "paired":
        stack, tstack = jpair(stack), tst.to_pair_layout(tstack)
    want_logits, want_step = _run_jax(cfg, stack, jkernel)
    got_logits, got_step = _run_torch(cfg, tstack, tkernel)
    for row, n in enumerate(_inputs()[1]):
        _close(got_logits[row, :n], want_logits[row, :n])
    _close(got_step, want_step)


def test_kernel_decode_takes_row_7_and_row_1_branches(world, monkeypatch):
    # One canonical decode step calls row 7 at the 4 attention
    # projections and the 3 routed expert matrices of every layer; in the
    # pair layout w1/w3 move to row 1.
    from bitdelta_torch.ops import binary_gemm as tbg

    cfg, _, _, _, _, tstack = world
    calls = {"row7": 0, "row1": 0}
    row7, row1 = tbg.tenant_delta_matmul, tbg.tenant_delta_matmul_pair

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tbg, "tenant_delta_matmul", count("row7", row7))
    monkeypatch.setattr(tbg, "tenant_delta_matmul_pair", count("row1", row1))
    tokens, lengths, ids, nxt = _inputs()
    tcfg = _tcfg(cfg)
    cache = tmx.forward(tcfg, tstack.params, torch.from_numpy(tokens).long(),
                        lengths=torch.from_numpy(lengths),
                        deltas=tstack.deltas,
                        tenant_ids=torch.from_numpy(ids).long(),
                        return_cache=True, cache_max_seq=16,
                        kernel="cuda")[1]
    assert calls == {"row7": 0, "row1": 0}
    for stk, want in ((tstack, {"row7": 14, "row1": 0}),
                      (tst.to_pair_layout(tstack), {"row7": 10, "row1": 4})):
        calls.update(row7=0, row1=0)
        tmx.decode_step(tcfg, stk.params, torch.from_numpy(nxt).long(), cache,
                        deltas=stk.deltas,
                        tenant_ids=torch.from_numpy(ids).long(),
                        kernel="cuda")
        assert calls == want


def test_routed_decode_matches_dense_fusion(world):
    # The routed expert-delta decode against each row's tenant fused
    # densely into its base (no routing code shared with the path under
    # test).
    from bitdelta_torch.core.delta import dequantize_delta

    cfg, base, fines, _, _, tstack = world
    tcfg = _tcfg(cfg)
    tokens, lengths, ids, nxt = _inputs()
    tb = params_from_numpy(base, "cpu")
    t = lambda a: torch.as_tensor(np.asarray(a)).long()  # noqa: E731
    for kernel in ("torch", "cuda"):
        cache = tmx.forward(tcfg, tstack.params, t(tokens), lengths=t(lengths),
                            deltas=tstack.deltas, tenant_ids=t(ids),
                            compute_dtype=torch.float32, return_cache=True,
                            cache_max_seq=16, kernel=kernel)[1]
        got, _ = tmx.decode_step(tcfg, tstack.params, t(nxt), cache,
                                 deltas=tstack.deltas, tenant_ids=t(ids),
                                 compute_dtype=torch.float32, kernel=kernel)
        for row in range(3):
            tid = int(ids[row])
            comp = tmx.compress_mixtral(tb, params_from_numpy(fines[tid],
                                                              "cpu"))
            p = tmx.mixtral_student_params(tb, comp)
            p["layers"] = {name: (w + dequantize_delta(comp.deltas[name])
                                  if name in comp.deltas else w)
                           for name, w in p["layers"].items()}
            cache1 = tmx.forward(tcfg, p, t(tokens[row:row + 1]),
                                 lengths=t(lengths[row:row + 1]),
                                 compute_dtype=torch.float32,
                                 return_cache=True, cache_max_seq=16)[1]
            want, _ = tmx.decode_step(tcfg, p, t(nxt[row:row + 1]), cache1,
                                      compute_dtype=torch.float32)
            # The kernel branches put x on a 14- or 12-bit grid first.
            tol = (LOGIT_TOL if kernel == "torch" else 2e-3) * float(
                want.abs().max())
            np.testing.assert_allclose(got[row].numpy(), want[0].numpy(),
                                       rtol=0, atol=tol)


def test_route_breaks_ties_toward_the_lower_index():
    logits = torch.tensor([[0.5, 2.0, 0.5, 2.0, 1.0],
                           [1.0, 1.0, 1.0, 1.0, 1.0]])
    vals, idx = tmx._route(logits, 3)
    assert idx.tolist() == [[1, 3, 4], [0, 1, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert idx.tolist() == np.array(ji).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.array(jv))


def _requests(cls):
    prompts = [[5, 11, 3, 7], [9, 4], [1, 2, 3, 4, 5, 6]]
    return [cls(prompt_ids=prompts[i], tenant_id=i % 2, max_new_tokens=5 + i)
            for i in range(3)]


def test_engine_greedy_matches_jax(world):
    from bitdelta_tpu.serving.engine import Engine as JEngine
    from bitdelta_tpu.serving.engine import Request as JRequest
    from bitdelta_torch.serving.engine import Engine, Request

    cfg, _, _, _, stack, tstack = world
    want = JEngine(cfg, stack, max_slots=2, max_seq=64,
                   prefill_buckets=(16,), kernel="xla", model=jmx,
                   decode_chunk=4).generate(_requests(JRequest))
    kw = dict(max_slots=2, max_seq=64, prefill_buckets=(16,), decode_chunk=4,
              device="cpu", model=tmx)
    got = Engine(_tcfg(cfg), tstack, kernel="torch", **kw).generate(
        _requests(Request))
    assert got == want
    assert [len(g) for g in got] == [5, 6, 7]
    # kernel="cuda" (pair layout for w1/w3, rows 1 and 7 on the CPU
    # through their plain versions) serves the same greedy tokens here.
    got = Engine(_tcfg(cfg), tstack, kernel="cuda", **kw).generate(
        _requests(Request))
    assert got == want


def test_engine_w8_base_matches_dequantized_dense(world):
    from bitdelta_torch.serving.engine import Engine, Request

    cfg, base, fines, _, _, _ = world
    tcfg = _tcfg(cfg)
    qbase = tqb.quantize_mixtral_base_projections(
        params_from_numpy(base, "cpu"))
    deq = tqb.dequantize_base_projections(qbase, torch.float32)
    # Deltas against the dequantized base: the W8 + W1 recipe.
    tenants = [tmx.compress_mixtral(deq, params_from_numpy(f, "cpu"))
               for f in fines]
    outs = {}
    for label, b in (("dense", deq), ("int8", qbase)):
        stack = tst.stack_tenants(tcfg, b, tenants, device="cpu")
        eng = Engine(tcfg, stack, max_slots=2, max_seq=64,
                     prefill_buckets=(16,), kernel="torch", device="cpu",
                     model=tmx)
        outs[label] = eng.generate(
            [Request(prompt_ids=[3, 9, 4], tenant_id=t, max_new_tokens=6)
             for t in range(2)])
    assert outs["dense"] == outs["int8"]
    assert outs["dense"][0] != outs["dense"][1]


def test_engine_rejects_an_int8_cache_for_mixtral(world):
    from bitdelta_torch.serving.engine import Engine

    cfg, _, _, _, _, tstack = world
    with pytest.raises(ValueError, match="llama family only"):
        Engine(_tcfg(cfg), tstack, max_slots=2, max_seq=64, device="cpu",
               model=tmx, kv_dtype="int8")


def test_mean_expert_compression_matches_jax():
    from bitdelta_tpu.research import mixtral_moe as jmoe
    from bitdelta_torch.research import mixtral_moe as tmoe

    rng = np.random.default_rng(9)
    e, k, i, m = 4, 64, 96, 5
    ws = [(rng.standard_normal(shape).astype(np.float32) * 0.1)[None]
          + 0.01 * rng.standard_normal((e,) + shape).astype(np.float32)
          for shape in ((k, i), (k, i), (i, k))]
    jffn = jmoe.compress_moe_ffn(*map(jnp.asarray, ws))
    tffn = tmoe.compress_moe_ffn(*map(torch.from_numpy, ws))
    for jf, tf in zip(jffn, tffn):
        np.testing.assert_array_equal(tf.mean_w.numpy(), np.array(jf.mean_w))
        np.testing.assert_array_equal(tf.delta.packed.numpy(),
                                      np.array(jf.delta.packed))
        np.testing.assert_allclose(tf.delta.scale.numpy(),
                                   np.array(jf.delta.scale),
                                   rtol=SCALE_RTOL)
    x = rng.standard_normal((m, k)).astype(np.float32)
    logits = rng.standard_normal((m, e)).astype(np.float32)
    want = np.array(jmoe.moe_ffn_apply(jnp.asarray(x), jffn,
                                       jnp.asarray(logits), top_k=2,
                                       compute_dtype=jnp.float32))
    got = tmoe.moe_ffn_apply(torch.from_numpy(x), tffn,
                             torch.from_numpy(logits), top_k=2,
                             compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    assert tmoe.moe_compression_ratio(torch.from_numpy(ws[0]), tffn.w1) == \
        pytest.approx(jmoe.moe_compression_ratio(jnp.asarray(ws[0]),
                                                 jffn.w1))
