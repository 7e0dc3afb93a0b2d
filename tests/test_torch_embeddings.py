"""PyTorch port: compressed embeddings (``compress_embeddings=True``),
dense fusion and perplexity against the JAX package on the CPU.

A tiny llama (vocab 256, so the lm_head delta pairs; hidden 64;
intermediate 256, so gate/up pair), tied and untied, three fine-tunes.

Tolerances: packed words are bit-exact; scales too where a test says so,
else rtol 1e-6 (an fp32 mean summed in another order, as
tests/test_torch_delta_artifact.py). Dense fusion, artifacts, stacking
and byte counts are exact. Logits in fp32 are held at the 2e-3 of
tests/test_torch_model.py (the kernel routes put x on the pair and
canonical kernels' grids; the plain route agrees far closer). Greedy
tokens are equal. Perplexities agree to 1e-4 relative: the same fp32
arithmetic, with sums in other orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.core import artifact as jart
from bitdelta_tpu.core import compress as jcomp
from bitdelta_tpu.core import delta as jdelta
from bitdelta_tpu.eval import ppl as jppl
from bitdelta_tpu.models import config as jcfg
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.serving import stacking as jst
from bitdelta_tpu.serving.engine import Engine as JEngine
from bitdelta_tpu.serving.engine import Request as JRequest
from bitdelta_torch.convert import params_from_numpy, stack_from_numpy
from bitdelta_torch.convert import to_numpy
from bitdelta_torch.core import artifact as tart
from bitdelta_torch.core import compress as tcomp
from bitdelta_torch.core import delta as tdelta
from bitdelta_torch.eval import ppl as tppl
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.serving import stacking as tst
from bitdelta_torch.serving.engine import Engine, Request

LOGIT_TOL = 2e-3
SCALE_RTOL = 1e-6
PPL_RTOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _cfg(tied):
    return jcfg.tiny_test_config(vocab_size=256, hidden_size=64,
                                 intermediate_size=256, num_layers=2,
                                 num_heads=4, num_kv_heads=2,
                                 dtype="float32", tie_word_embeddings=tied)


def _tcfg(cfg):
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def _finetune(base, seed):
    """base + seeded numpy noise on every tensor."""
    rng = np.random.default_rng(seed)

    def noisy(w, scale=0.01):
        return (w + scale * rng.standard_normal(w.shape)).astype(np.float32)

    fine = {k: noisy(v) for k, v in base.items() if k != "layers"}
    fine["layers"] = {k: noisy(v) for k, v in base["layers"].items()}
    return fine


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
        got = to_numpy(got)
        assert got.shape == np.shape(want)
        np.testing.assert_array_equal(got, np.array(want))


@pytest.fixture(scope="module", params=["untied", "tied"])
def world(request):
    cfg = _cfg(request.param == "tied")
    base = _np_tree(jl.init_params(cfg, jax.random.PRNGKey(7), jnp.float32,
                                   scale=0.25))
    fines = [_finetune(base, 200 + t) for t in range(3)]
    jtenants = [jcomp.compress_model(_jtree(base), _jtree(f),
                                     compress_embeddings=True)
                for f in fines]
    stack = jst.stack_tenants(cfg, _jtree(base), jtenants)
    return {"cfg": cfg, "base": base, "fines": fines, "jtenants": jtenants,
            "stack": stack, "pair": jst.to_pair_layout(stack),
            "tbase": params_from_numpy(base, "cpu"),
            "ttenants": [params_from_numpy(_np_tree(c), "cpu")
                         for c in jtenants], "cache": {}}


def _tstack(world, layout):
    return stack_from_numpy(_np_tree(world[layout]), "cpu")


# ---------------------------------------------------------------------------
# Compression, stacking, artifacts
# ---------------------------------------------------------------------------

def test_compress_embeddings_matches_jax(world):
    cfg = world["cfg"]
    for fine, want in zip(world["fines"], world["jtenants"]):
        got = tcomp.compress_model(world["tbase"],
                                   params_from_numpy(fine, "cpu"),
                                   compress_embeddings=True)
        names = jl.PROJ_NAMES + (("embed",) if cfg.tie_word_embeddings
                                 else ("embed", "lm_head"))
        assert list(got.deltas) == list(want.deltas) == list(names)
        assert "embed" not in got.extras and "lm_head" not in got.extras
        # The embed delta is packed along D: (D/32, V), a 0-d scale.
        assert tuple(got.deltas["embed"].packed.shape) == (
            cfg.hidden_size // 32, cfg.vocab_size)
        assert got.deltas["embed"].scale.ndim == 0
        for name, d in want.deltas.items():
            np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                          np.array(d.packed))
            np.testing.assert_allclose(got.deltas[name].scale.numpy(),
                                       np.array(d.scale), rtol=SCALE_RTOL)
        _assert_tree_equal(got.extras, want.extras)


def test_compress_embeddings_refuses_what_jax_refuses(world):
    base, fine = world["tbase"], params_from_numpy(world["fines"][0], "cpu")
    grown = dict(fine, embed=torch.cat([fine["embed"], fine["embed"][:3]]))
    with pytest.raises(ValueError, match="share the base vocab"):
        tcomp.compress_model(base, grown, compress_embeddings=True)
    if "lm_head" in base:
        untied = {k: v for k, v in fine.items() if k != "lm_head"}
    else:
        untied = dict(fine, lm_head=fine["embed"].T.contiguous())
    with pytest.raises(ValueError, match="tied lm_head"):
        tcomp.compress_model(base, untied, compress_embeddings=True)


def test_stack_and_pair_layout_match_jax(world):
    cfg = world["cfg"]
    got = tst.stack_tenants(_tcfg(cfg), world["tbase"], world["ttenants"],
                            device="cpu")
    want = world["stack"]
    _assert_tree_equal(got.params, want.params)
    _assert_tree_equal(got.deltas, want.deltas)
    _assert_tree_equal(got.vocab_sizes, want.vocab_sizes)
    # The shared base embed / head, tenant-first embed / head deltas.
    assert got.params["embed"].ndim == 2
    assert tuple(got.deltas["embed"].packed.shape) == (
        3, cfg.hidden_size // 32, cfg.vocab_size)
    paired = tst.to_pair_layout(got)
    _assert_tree_equal(paired.deltas, world["pair"].deltas)
    # embed stays canonical by name; a compressed lm_head pairs (V = 256).
    assert isinstance(paired.deltas["embed"], tdelta.BinaryDelta)
    if not cfg.tie_word_embeddings:
        assert isinstance(paired.deltas["lm_head"],
                          tdelta.PairedBinaryDelta)
        assert tuple(paired.deltas["lm_head"].colsum.shape) == (
            3, cfg.vocab_size)
    in_place = tst.to_pair_layout(got, in_place=True)
    _assert_tree_equal(in_place.deltas, world["pair"].deltas)


@pytest.mark.parametrize("layout", ["stack", "pair"])
def test_stack_nbytes_matches_jax(world, layout):
    # A shared 2-D embed / head is base, as JAX counts it.
    got = tst.stack_nbytes(_tstack(world, layout))
    assert got == jst.stack_nbytes(world[layout])
    embed = world["base"]["embed"]
    assert got["base_bytes"] >= embed.size * embed.dtype.itemsize


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_cross_both_ways(world, writer, tmp_path):
    cfg, path = world["cfg"], str(tmp_path / "delta.safetensors")
    comp = world["jtenants"][0]
    tcomp_ = world["ttenants"][0]
    if writer == "jax":
        jart.save_delta(path, comp, cfg)
        got, got_cfg = tart.load_delta(path, device="cpu")
        assert got_cfg == _tcfg(cfg)
        _assert_tree_equal(got, comp)
    else:
        tart.save_delta(path, tcomp_, _tcfg(cfg))
        got, got_cfg = jart.load_delta(path)
        assert got_cfg == cfg
        _assert_tree_equal(tcomp_, got)


# ---------------------------------------------------------------------------
# Forward, decode, engine
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(61)
    tokens = rng.integers(1, 256, (3, 12)).astype(np.int32)
    lengths = np.asarray([12, 8, 5], np.int32)
    ids = np.asarray([1, 2, 0], np.int32)
    nxt = rng.integers(1, 256, (3, 1)).astype(np.int32)
    return tokens, lengths, ids, nxt


def _jax_run(world, layout):
    if layout not in world["cache"]:
        cfg, stack = world["cfg"], world[layout]
        tokens, lengths, ids, nxt = _inputs()
        logits, cache = jl.forward(
            cfg, stack.params, jnp.asarray(tokens),
            lengths=jnp.asarray(lengths), deltas=stack.deltas,
            tenant_ids=jnp.asarray(ids), compute_dtype=jnp.float32,
            return_cache=True, cache_max_seq=16, kernel="xla")
        step, _ = jl.decode_step(cfg, stack.params, jnp.asarray(nxt), cache,
                                 deltas=stack.deltas,
                                 tenant_ids=jnp.asarray(ids),
                                 compute_dtype=jnp.float32, kernel="xla")
        world["cache"][layout] = (np.array(logits), np.array(step))
    return world["cache"][layout]


@pytest.mark.parametrize("kernel", ["torch", "cuda", "cuda_fused"])
@pytest.mark.parametrize("layout", ["stack", "pair"])
def test_forward_and_decode_match_jax(world, layout, kernel):
    want_pre, want_step = _jax_run(world, layout)
    tstack = _tstack(world, layout)
    tcfg = _tcfg(world["cfg"])
    tokens, lengths, ids, nxt = _inputs()
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    logits, cache = tl.forward(
        tcfg, tstack.params, t(tokens).long(), lengths=t(lengths),
        deltas=tstack.deltas, tenant_ids=t(ids).long(),
        compute_dtype=torch.float32, return_cache=True, cache_max_seq=16,
        kernel=kernel)
    step, _ = tl.decode_step(tcfg, tstack.params, t(nxt).long(), cache,
                             deltas=tstack.deltas, tenant_ids=t(ids).long(),
                             compute_dtype=torch.float32, kernel=kernel)
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(to_numpy(logits)[row, :n],
                                   want_pre[row, :n], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    np.testing.assert_allclose(to_numpy(step), want_step, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_single_tenant_forward_matches_jax(world):
    # One compressed model over its student params: the (D/32, V) embed
    # and head deltas without a tenant axis.
    cfg, comp = world["cfg"], world["jtenants"][1]
    tokens = np.random.default_rng(62).integers(0, 256, (2, 10))
    want = jl.forward(cfg, jcomp.student_params(_jtree(world["base"]), comp),
                      jnp.asarray(tokens, jnp.int32), deltas=comp.deltas,
                      compute_dtype=jnp.float32)
    tc = world["ttenants"][1]
    got = tl.forward(_tcfg(cfg), tcomp.student_params(world["tbase"], tc),
                     torch.from_numpy(tokens).long(), deltas=tc.deltas,
                     compute_dtype=torch.float32)
    np.testing.assert_allclose(to_numpy(got), np.array(want), rtol=1e-5,
                               atol=1e-5)


def _requests(cls):
    prompts = [[5, 6, 7], [9, 3], [1, 2, 3, 4, 5], [40, 41]]
    return [cls(prompt_ids=p, tenant_id=i % 3, max_new_tokens=5 + i)
            for i, p in enumerate(prompts)]


def test_engine_greedy_matches_jax(world):
    cfg = world["cfg"]
    want = JEngine(cfg, world["stack"], max_slots=2, max_seq=48,
                   prefill_buckets=(16,), kernel="xla",
                   decode_chunk=4).generate(_requests(JRequest))
    tstack = _tstack(world, "stack")
    eng = Engine(_tcfg(cfg), tstack, max_slots=2, max_seq=48,
                 prefill_buckets=(16,), kernel="torch", decode_chunk=4,
                 device="cpu")
    np.testing.assert_array_equal(eng.stack.vocab_sizes.numpy(),
                                  [cfg.vocab_size] * 3)
    assert eng.generate(_requests(Request)) == want
    # The kernel routes on the pair layout: the fused route's plain
    # versions repeat the unfused route's sums, so greedy tokens agree.
    fused = Engine(_tcfg(cfg), tstack, max_slots=2, max_seq=48,
                   prefill_buckets=(16,), kernel="cuda_fused",
                   decode_chunk=4, device="cpu").generate(_requests(Request))
    unfused = Engine(_tcfg(cfg), tstack, max_slots=2, max_seq=48,
                     prefill_buckets=(16,), kernel="cuda",
                     decode_chunk=4, device="cpu").generate(
                         _requests(Request))
    assert fused == unfused


# ---------------------------------------------------------------------------
# Dense fusion and the compression accounting
# ---------------------------------------------------------------------------

def test_fuse_compressed_matches_jax_exactly(world):
    for tc, jc in zip(world["ttenants"], world["jtenants"]):
        got = tcomp.fuse_compressed(world["tbase"], tc)
        want = jcomp.fuse_compressed(_jtree(world["base"]), jc)
        _assert_tree_equal(got, want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_apply_delta_matches_jax_exactly(dtype):
    rng = np.random.default_rng(63)
    base = jnp.asarray(rng.standard_normal((2, 64, 48)), dtype)
    fine = base + jnp.asarray(0.01 * rng.standard_normal(base.shape), dtype)
    d = jdelta.quantize_delta(base, fine)
    got = tdelta.apply_delta(params_from_numpy(np.array(base), "cpu"),
                             params_from_numpy(_np_tree(d), "cpu"))
    want = jdelta.apply_delta(base, d)
    assert got.dtype == params_from_numpy(np.array(base), "cpu").dtype
    _assert_tree_equal(got, want)


def test_compression_accounting_matches_jax(world):
    jc, tc = world["jtenants"][0], world["ttenants"][0]
    for name, d in jc.deltas.items():
        assert tdelta.delta_nbytes(tc.deltas[name]) == jdelta.delta_nbytes(d)
    assert tdelta.compression_ratio(
        world["tbase"]["layers"]["q_proj"], tc.deltas["q_proj"]) == \
        jdelta.compression_ratio(jnp.asarray(world["base"]["layers"]
                                             ["q_proj"]), jc.deltas["q_proj"])
    assert tcomp.compressed_nbytes(tc) == jcomp.compressed_nbytes(jc)
    assert tcomp.delta_compression_stats(world["tbase"], tc) == \
        jcomp.delta_compression_stats(_jtree(world["base"]), jc)


# ---------------------------------------------------------------------------
# Perplexity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,ctx,win", [(100, 16, 8), (1600, 1024, 512),
                                             (24, 16, 8), (23, 16, 8),
                                             (57, 4, 10)])
def test_window_starts_match_jax(seq_len, ctx, win):
    assert tppl.window_starts(seq_len, ctx, win) == jppl.window_starts(
        seq_len, ctx, win)


@pytest.mark.parametrize("batch_windows", [1, 2])
def test_eval_ppl_matches_jax(world, batch_windows):
    cfg, comp, tc = world["cfg"], world["jtenants"][2], world["ttenants"][2]
    tokens = np.random.default_rng(64).integers(0, 256, (53,))
    kw = dict(context_size=16, window_size=8, batch_windows=batch_windows)
    jbase = _jtree(world["base"])
    # Dense fused weights, then the same tenant through its deltas.
    want_dense = jppl.eval_ppl(cfg, jcomp.fuse_compressed(jbase, comp),
                               tokens, compute_dtype=jnp.float32, **kw)
    got_dense = tppl.eval_ppl(_tcfg(cfg),
                              tcomp.fuse_compressed(world["tbase"], tc),
                              tokens, compute_dtype=torch.float32, **kw)
    want_d = jppl.eval_ppl(cfg, jcomp.student_params(jbase, comp), tokens,
                           deltas=comp.deltas, compute_dtype=jnp.float32,
                           **kw)
    got_d = tppl.eval_ppl(_tcfg(cfg), tcomp.student_params(world["tbase"],
                                                           tc),
                          tokens, deltas=tc.deltas,
                          compute_dtype=torch.float32, **kw)
    assert abs(got_dense - want_dense) <= PPL_RTOL * want_dense
    assert abs(got_d - want_d) <= PPL_RTOL * want_d
    with pytest.raises(ValueError, match="corpus too short"):
        tppl.eval_ppl(_tcfg(cfg), world["tbase"], tokens[:20], **kw)


def test_tokenize_corpus_joins_like_jax():
    def tok(text):
        return {"input_ids": [ord(c) for c in text]}

    texts = ["ab", "", "cd e"]
    np.testing.assert_array_equal(tppl.tokenize_corpus(tok, texts),
                                  jppl.tokenize_corpus(tok, texts))


# ---------------------------------------------------------------------------
# Mixtral
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_mixtral_compressed_embeddings_match_jax(kernel):
    from bitdelta_tpu.models import mixtral as jmx
    from bitdelta_torch.models import mixtral as tmx

    cfg = jmx.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=64, num_experts=4,
        experts_per_token=2, dtype="float32")
    base = _np_tree(jmx.init_params(cfg, jax.random.PRNGKey(3), jnp.float32))
    fines = [_finetune(base, 300 + t) for t in range(2)]
    jten = [jmx.compress_mixtral(_jtree(base), _jtree(f),
                                 compress_embeddings=True) for f in fines]
    for f, want in zip(fines, jten):
        got = tmx.compress_mixtral(params_from_numpy(base, "cpu"),
                                   params_from_numpy(f, "cpu"),
                                   compress_embeddings=True)
        for name, d in want.deltas.items():
            np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                          np.array(d.packed))
    stack = jst.stack_tenants(cfg, _jtree(base), jten)
    tstack = stack_from_numpy(_np_tree(stack), "cpu")
    tcfg = tmx.MixtralConfig.from_dict(dataclasses.asdict(cfg))
    tokens = np.random.default_rng(65).integers(1, 256, (2, 9))
    ids = np.asarray([1, 0])
    nxt = np.asarray([[17], [5]])
    logits, cache = jmx.forward(cfg, stack.params, jnp.asarray(tokens),
                                deltas=stack.deltas,
                                tenant_ids=jnp.asarray(ids),
                                compute_dtype=jnp.float32,
                                return_cache=True, cache_max_seq=16)
    want, _ = jmx.decode_step(cfg, stack.params, jnp.asarray(nxt), cache,
                              deltas=stack.deltas,
                              tenant_ids=jnp.asarray(ids),
                              compute_dtype=jnp.float32)
    t = lambda a: torch.as_tensor(np.asarray(a)).long()  # noqa: E731
    got_pre, tcache = tmx.forward(tcfg, tstack.params, t(tokens),
                                  deltas=tstack.deltas, tenant_ids=t(ids),
                                  compute_dtype=torch.float32,
                                  return_cache=True, cache_max_seq=16,
                                  kernel=kernel)
    got, _ = tmx.decode_step(tcfg, tstack.params, t(nxt), tcache,
                             deltas=tstack.deltas, tenant_ids=t(ids),
                             compute_dtype=torch.float32, kernel=kernel)
    scale = float(np.abs(np.array(want)).max())
    np.testing.assert_allclose(to_numpy(got_pre), np.array(logits),
                               rtol=0, atol=LOGIT_TOL * scale)
    np.testing.assert_allclose(to_numpy(got), np.array(want), rtol=0,
                               atol=LOGIT_TOL * scale)
