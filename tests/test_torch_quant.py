"""PyTorch port: density serving — the W8 / W4 quantized base, the int8 KV
cache and the GPTQ / bnb layer imports — against the JAX package.

Quantization, nibble packing, ``quantize_kv``, ``roundtrip_base``, the
GPTQ / bnb conversions, ``stack_nbytes`` and the artifacts are held
bit-exact. The W4 base matmul (plain version and the ``kernel="cuda"``
dispatch, which on CPU tensors runs the plain version) agrees with JAX to
1e-5 (fp32 sums over the groups taken in another order). Prefill and
decode logits of W4 and W8 stacks, with the bf16 and the int8 cache,
agree with JAX ``kernel="xla"`` to the 2e-3 of tests/test_torch_model.py
(the pair kernel's 12-bit activation grid), and the engines' greedy
tokens are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.models import config as jcfg
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.models import quant_import as jqi
from bitdelta_tpu.ops import kv_quant as jkv
from bitdelta_tpu.research import quantized_base as jq
from bitdelta_tpu.serving import stacking as jst
from bitdelta_torch.convert import (params_from_numpy, stack_from_numpy,
                                    tensor_from_numpy, to_numpy)
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models import quant_import as tqi
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.ops import int4 as ti
from bitdelta_torch.ops import kv_quant as tkv
from bitdelta_torch.research import quantized_base as tq
from bitdelta_torch.serving import stacking as tst

TOL = 2e-3


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _both(a, dtype):
    """The same values for both packages: a JAX array of ``dtype`` and its
    torch twin on the CPU (bf16 bit-exact)."""
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _equal(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want, np.float32)
                                  if want.dtype == jnp.bfloat16
                                  else np.asarray(want))


# ---------------------------------------------------------------------------
# Bit-exact conversions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_weight_matches_jax(mode, dtype):
    rng = np.random.default_rng(0)
    jw, tw = _both(rng.standard_normal((2, 256, 96)) * 0.05, dtype)
    jw = jw.at[:, :128, 0].set(0.0)        # an all-zero group hits the clamp
    tw[:, :128, 0] = 0.0
    jquant, tquant = ((jq.quantize_int8, tq.quantize_int8) if mode == "int8"
                      else (jq.quantize_int4, tq.quantize_int4))
    jdeq, tdeq = ((jq.dequantize_int8, tq.dequantize_int8) if mode == "int8"
                  else (jq.dequantize_int4, tq.dequantize_int4))
    want, got = jquant(jw), tquant(tw)
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, str(w.dtype))
        _equal(g, w)
    _equal(tdeq(got, torch.float32), jdeq(want, jnp.float32))
    _equal(tdeq(got, torch.bfloat16), jdeq(want, jnp.bfloat16))


def test_nibble_packing_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, (3, 64, 40)).astype(np.int32)
    q[:, 7::8, :5] = -3                    # top nibble negative: word < 0
    want = np.asarray(jq._pack_nibbles(jnp.asarray(q)))
    got = tq._pack_nibbles(torch.from_numpy(q)).numpy()
    assert (want < 0).any() and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tq._unpack_nibbles(torch.from_numpy(got)).numpy(),
        np.asarray(jq._unpack_nibbles(jnp.asarray(want))))
    np.testing.assert_array_equal(
        tq._unpack_nibbles(torch.from_numpy(got)).numpy(), q)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_kv_matches_jax(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal((2, 9, 4, 32)) * 3.0, dtype)
    jx = jx.at[0, 0, 0].set(0.0)
    tx[0, 0, 0] = 0.0
    jqv, js = jkv.quantize_kv(jx)
    tqv, ts = tkv.quantize_kv(tx)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    _equal(tqv, jqv)
    _equal(ts, js)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16,
                                                  torch.bfloat16)):
        _equal(tkv.dequantize_kv(tqv, ts, td), jkv.dequantize_kv(jqv, js, jd))


@pytest.mark.parametrize("recipe", ["quantize_base_with_delta",
                                    "quantize_int4_base_with_delta"])
def test_base_with_delta_recipes_match_jax(recipe):
    # The quantized base and the 1-bit delta against its dequantized
    # values: words bit-exact, the delta's mean-|diff| scale to 1e-6 (fp32
    # means summed in another order, as tests/test_torch_delta_artifact.py).
    rng = np.random.default_rng(9)
    base = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    fine = base + (0.01 * rng.standard_normal(base.shape)).astype(np.float32)
    jqb, jd = getattr(jq, recipe)(jnp.asarray(base), jnp.asarray(fine))
    tqb, td = getattr(tq, recipe)(torch.from_numpy(base),
                                  torch.from_numpy(fine))
    for g, w in zip(tqb, jqb):
        _equal(g, w)
    _equal(td.packed, jd.packed)
    np.testing.assert_allclose(td.scale.numpy(), np.asarray(jd.scale),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantized_matmuls_match_jax(dtype):
    # int8_matmul, int4_matmul and int8_delta_linear with x of ``dtype``
    # and fp32 compute (JAX's CPU backend has no bf16 x bf16 -> fp32
    # dot): the same operands, fp32 sums in another order (1e-5 relative
    # to the largest output; one bf16 ulp of it for a bf16 result).
    from bitdelta_tpu.core.delta import quantize_delta as jquantize_delta
    from bitdelta_torch.core.delta import BinaryDelta

    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((256, 96)) * 0.05).astype(np.float32)
    jx, tx = _both(rng.standard_normal((2, 5, 256)), dtype)
    w8, w4 = jq.quantize_int8(jnp.asarray(w)), jq.quantize_int4(jnp.asarray(w))
    tw8, tw4 = (params_from_numpy(_np_tree(a), "cpu") for a in (w8, w4))
    d = jquantize_delta(jnp.asarray(w), jnp.asarray(
        w + 0.01 * rng.standard_normal(w.shape).astype(np.float32)))
    td = BinaryDelta(torch.from_numpy(np.array(d.packed)),
                     torch.from_numpy(np.array(d.scale)))
    f32, tf32 = jnp.float32, torch.float32
    pairs = [(jq.int8_matmul(jx, w8, f32), tq.int8_matmul(tx, tw8, tf32)),
             (jq.int4_matmul(jx, w4, f32), tq.int4_matmul(tx, tw4, tf32)),
             (jq.int8_delta_linear(jx, w8, d, f32),
              tq.int8_delta_linear(tx, tw8, td, tf32))]
    for want, got in pairs:
        want = np.asarray(want, np.float32)
        assert got.dtype == tdt and got.shape == want.shape
        rel = 1e-5 if dtype == jnp.float32 else 2.0 ** -7
        np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                                   atol=rel * np.abs(want).max())


def _dense_params(cfg, seed=0):
    return _np_tree(jl.init_params(cfg, jax.random.PRNGKey(seed),
                                   jnp.float32))


def _cfg(**kw):
    base = dict(vocab_size=64, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32")
    base.update(kw)
    return jcfg.tiny_test_config(**base)


def _tcfg(cfg):
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_and_roundtrip_base_match_jax(mode):
    params = _dense_params(_cfg())
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_numpy(params, "cpu")
    want_q = jq.quantize_base(jparams, mode)
    got_q = tq.quantize_base(tparams, mode)
    for name in jl.PROJ_NAMES:
        g, w = got_q["layers"][name], want_q["layers"][name]
        assert type(g).__name__ == type(w).__name__
        for gf, wf in zip(g, w):
            _equal(gf, wf)
    for dt, tdt in ((None, None), (jnp.float32, torch.float32)):
        want = jq.roundtrip_base(jparams, mode, dt)
        got = tq.roundtrip_base(tparams, mode, tdt)
        for name in jl.PROJ_NAMES:
            assert got["layers"][name].dtype == (tdt or torch.bfloat16)
            _equal(got["layers"][name], want["layers"][name])
        _equal(got["embed"], want["embed"])
    with pytest.raises(ValueError):
        tq.quantize_base(tparams, "int3")


# ---------------------------------------------------------------------------
# GPTQ / bnb layer import (fabricated layers, as tests/test_quant_import.py)
# ---------------------------------------------------------------------------

def _pack_gptq(q):
    """(K, N) unsigned nibbles -> (K//8, N) int32, LSB-first."""
    k, n = q.shape
    u = q.astype(np.uint32).reshape(k // 8, 8, n)
    shifts = np.arange(8, dtype=np.uint32) * 4
    return np.bitwise_or.reduce(u << shifts[:, None], axis=1).view(np.int32)


def _pack_gptq_zeros(z, shift=True):
    """(G, N) zero nibbles -> (G, N//8); the legacy format stores
    ``zero - 1``, gptq_v2 the zero itself."""
    g, n = z.shape
    u = (z.astype(np.uint32) - (1 if shift else 0)).reshape(g, n // 8, 8)
    shifts = np.arange(8, dtype=np.uint32) * 4
    return np.bitwise_or.reduce(u << shifts, axis=2).view(np.int32)


def _random_gptq_layer(rng, k, n, group, sym, fmt="gptq"):
    q = rng.integers(0, 16, (k, n)).astype(np.int32)
    g = k // group
    zeros = (np.full((g, n), 8, np.int32) if sym
             else rng.integers(1, 16, (g, n)).astype(np.int32))
    scales = (0.01 + 0.1 * rng.random((g, n))).astype(np.float16)
    return (_pack_gptq(q), _pack_gptq_zeros(zeros, shift=fmt == "gptq"),
            scales)


@pytest.mark.parametrize("fmt", ["gptq", "gptq_v2"])
@pytest.mark.parametrize("sym", [True, False])
def test_gptq_conversions_match_jax(fmt, sym):
    rng = np.random.default_rng(3)
    qw, qz, sc = _random_gptq_layer(rng, 128, 32, 16, sym, fmt)
    for axis, arr in ((0, qw), (1, qz)):
        np.testing.assert_array_equal(tqi.unpack_gptq_nibbles(arr, axis),
                                      jqi.unpack_gptq_nibbles(arr, axis))
    g_perm = rng.permutation(np.arange(128) // 16)
    for g_idx in (None, np.arange(128) // 16, g_perm):
        np.testing.assert_array_equal(
            tqi.dequantize_gptq(qw, qz, sc, g_idx, fmt),
            jqi.dequantize_gptq(qw, qz, sc, g_idx, fmt))
        assert (tqi.gptq_is_symmetric(qz, g_idx, 128, fmt)
                == jqi.gptq_is_symmetric(qz, g_idx, 128, fmt))
    if sym:
        want = jqi.int4_from_gptq(qw, qz, sc, checkpoint_format=fmt)
        got = tqi.int4_from_gptq(qw, qz, sc, checkpoint_format=fmt,
                                 device="cpu")
        assert isinstance(got, tq.Int4Weight)
        _equal(got.packed, want.packed)
        _equal(got.scale, want.scale)
        # Lossless: the port's dequantizer gives the GPTQ dequant exactly.
        np.testing.assert_array_equal(
            tq.dequantize_int4(got).numpy(),
            tqi.dequantize_gptq(qw, qz, sc, None, fmt))
    else:
        with pytest.raises(ValueError):
            tqi.int4_from_gptq(qw, qz, sc, checkpoint_format=fmt,
                               device="cpu")


def test_int8_from_bnb_matches_jax():
    rng = np.random.default_rng(4)
    cb = rng.integers(-127, 128, (48, 64)).astype(np.int8)   # (out, in)
    scb = (rng.random(48) * 3).astype(np.float32)
    want = jqi.int8_from_bnb(cb, scb)
    got = tqi.int8_from_bnb(cb, scb, device="cpu")
    assert isinstance(got, tq.Int8Weight)
    _equal(got.q, want.q)
    _equal(got.scale, want.scale)


# ---------------------------------------------------------------------------
# The base-matmul dispatch
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch):
    calls = []
    real = tl.w4_matmul

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tl, "w4_matmul", counted)
    return calls


def test_base_matmul_cuda_takes_the_w4_kernel_branch(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(5)
    k, n = 256, 384                        # N not a multiple of the tile
    w = jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32)
    jw = jq.quantize_int4(w)
    x = rng.standard_normal((8, k)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jl._base_matmul(jnp.asarray(x), jw, jnp.float32,
                                          kernel="pallas"))
    tw = params_from_numpy(_np_tree(jw), "cpu")
    calls = _count_calls(monkeypatch)
    before = ti.w4_matmul.launches
    got = tl._base_matmul(torch.from_numpy(x), tw, torch.float32,
                          kernel="cuda")
    assert calls == [(8, k)]               # the row-8 branch was taken
    assert ti.w4_matmul.launches == before  # and launched nothing on the CPU
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # 3-D x and the default kernel take int4_matmul.
    tl._base_matmul(torch.from_numpy(x)[None], tw, torch.float32,
                    kernel="cuda")
    tl._base_matmul(torch.from_numpy(x), tw, torch.float32)
    assert len(calls) == 1


def test_base_matmul_group16_takes_int4_matmul(monkeypatch):
    # An imported GPTQ layer with 16-row groups at a decode shape: the
    # kernel takes 128-row groups only, so the dispatch keeps int4_matmul
    # (JAX's Pallas kernel would fail its assert; compare with its XLA
    # path).
    rng = np.random.default_rng(6)
    w = jnp.asarray(rng.standard_normal((256, 128)) * 0.05, jnp.float32)
    jw = jq.quantize_int4(w, group=16)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    want = np.asarray(jl._base_matmul(jnp.asarray(x), jw, jnp.float32,
                                      kernel="xla"))
    calls = _count_calls(monkeypatch)
    got = tl._base_matmul(torch.from_numpy(x),
                          params_from_numpy(_np_tree(jw), "cpu"),
                          torch.float32, kernel="cuda")
    assert calls == []
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_base_matmul_int8_matches_jax():
    rng = np.random.default_rng(7)
    jw = jq.quantize_int8(jnp.asarray(rng.standard_normal((256, 96)) * 0.05,
                                      jnp.float32))
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jl._base_matmul(jnp.asarray(x), jw, jdt))
        got = tl._base_matmul(torch.from_numpy(x),
                              params_from_numpy(_np_tree(jw), "cpu"), tdt,
                              kernel="cuda")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The model and the engine over a quantized base
# ---------------------------------------------------------------------------

def _quant_world(mode, paired=True):
    """A JAX stack over a ``mode``-quantized base with three tenants
    compressed (by the port, bit-exact with JAX) against the dequantized
    base, and its port twin on the CPU."""
    from bitdelta_tpu.core.compress import CompressedModel as JCompressed
    from bitdelta_tpu.core.delta import BinaryDelta as JDelta
    from bitdelta_torch.core.compress import compress_model

    cfg = _cfg(sliding_window=6)
    rng = np.random.default_rng(0)
    base = _dense_params(cfg)
    jbase = jax.tree.map(jnp.asarray, base)
    deq = _np_tree(jq.roundtrip_base(jbase, mode, jnp.float32))
    tenants = []
    for _ in range(3):
        fine = dict(base)
        fine["layers"] = dict(base["layers"])
        for name in jl.PROJ_NAMES + ("attn_norm",):
            w = base["layers"][name]
            fine["layers"][name] = (w + 0.01 * rng.standard_normal(w.shape)
                                    ).astype(np.float32)
        fine["lm_head"] = (base["lm_head"] + 0.01 * rng.standard_normal(
            base["lm_head"].shape)).astype(np.float32)
        comp = compress_model(params_from_numpy(deq, "cpu"),
                              params_from_numpy(fine, "cpu"))
        tenants.append(JCompressed(
            deltas={n: JDelta(jnp.asarray(d.packed.numpy()),
                              jnp.asarray(d.scale.numpy()))
                    for n, d in comp.deltas.items()},
            extras={n: jnp.asarray(x.numpy())
                    for n, x in comp.extras.items()}))
    stack = jst.stack_tenants(cfg, jq.quantize_base(jbase, mode), tenants)
    if paired:
        stack = jst.to_pair_layout(stack)
    return cfg, stack, stack_from_numpy(_np_tree(stack), "cpu"), tenants


@pytest.fixture(scope="module", params=["int4", "int8"])
def qworld(request):
    return (request.param,) + _quant_world(request.param) + ({},)


def _inputs(bsz):
    rng = np.random.default_rng(bsz)
    tokens = rng.integers(1, 64, (bsz, 16)).astype(np.int32)
    lengths = np.asarray([16, 11, 7][:bsz], np.int32)
    ids = np.asarray([2, 0, 1][:bsz], np.int32)
    nxt = rng.integers(1, 64, (bsz, 1)).astype(np.int32)
    return tokens, lengths, ids, nxt


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("kernel", ["torch", "cuda"])
@pytest.mark.parametrize("bsz", [3, 1])
def test_quantized_base_forward_and_decode_match_jax(qworld, kv, kernel,
                                                     bsz, monkeypatch):
    mode, cfg, stack, tstack, _, jax_results = qworld
    tokens, lengths, ids, nxt = _inputs(bsz)
    kv_quant = kv == "int8"
    key = (bsz, kv)
    if key not in jax_results:
        logits, cache = jl.forward(
            cfg, stack.params, jnp.asarray(tokens),
            lengths=jnp.asarray(lengths), deltas=stack.deltas,
            tenant_ids=jnp.asarray(ids), compute_dtype=jnp.float32,
            return_cache=True, cache_max_seq=24, kernel="xla",
            kv_quant=kv_quant)
        step, _ = jl.decode_step(cfg, stack.params, jnp.asarray(nxt), cache,
                                 deltas=stack.deltas,
                                 tenant_ids=jnp.asarray(ids),
                                 compute_dtype=jnp.float32, kernel="xla")
        jax_results[key] = (np.array(logits), np.array(step))
    want_logits, want_step = jax_results[key]
    calls = _count_calls(monkeypatch)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    tcfg = _tcfg(cfg)
    logits, cache = tl.forward(
        tcfg, tstack.params, t(tokens).long(), lengths=t(lengths),
        deltas=tstack.deltas, tenant_ids=t(ids).long(),
        compute_dtype=torch.float32, return_cache=True, cache_max_seq=24,
        kernel=kernel, kv_quant=kv_quant)
    assert cache.quantized == kv_quant
    assert cache.k.dtype == (torch.int8 if kv_quant else torch.float32)
    assert not calls                       # prefill never takes the kernel
    step, cache2 = tl.decode_step(tcfg, tstack.params, t(nxt).long(), cache,
                                  deltas=tstack.deltas,
                                  tenant_ids=t(ids).long(),
                                  compute_dtype=torch.float32, kernel=kernel)
    # Decode under "cuda" over a W4 base: every projection's base matmul
    # takes the W4 kernel branch (7 per layer).
    want_calls = 7 * cfg.num_layers if (kernel == "cuda"
                                        and mode == "int4") else 0
    assert len(calls) == want_calls
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(to_numpy(logits)[row, :n],
                                   want_logits[row, :n], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_numpy(step), want_step, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache2.length.numpy(), lengths + 1)


def test_init_cache_kv_dtypes():
    cfg = _tcfg(_cfg())
    cache = tl.init_cache(cfg, 2, 8, torch.float32, "cpu", kv_dtype="int8")
    assert cache.k.dtype == torch.int8 and cache.quantized
    assert tuple(cache.k_scale.shape) == (2, 2, 8, 2)
    for kv in (None, "bf16", "bfloat16"):
        c = tl.init_cache(cfg, 2, 8, torch.float32, "cpu", kv_dtype=kv)
        assert c.k.dtype == torch.float32 and not c.quantized
    with pytest.raises(ValueError):
        tl.init_cache(cfg, 2, 8, torch.float32, "cpu", kv_dtype="fp8")


def _requests(cls):
    prompts = [[5, 6, 7], [9, 3], [1, 2, 3, 4, 5], [40, 41]]
    return [cls(prompt_ids=prompts[i], tenant_id=i % 3,
                max_new_tokens=6 + i) for i in range(4)]


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_engine_w4_int8_kv_greedy_matches_jax(kernel, capsys):
    from bitdelta_tpu.serving.engine import Engine as JEngine
    from bitdelta_tpu.serving.engine import Request as JRequest
    from bitdelta_torch.serving.engine import Engine, Request

    cfg, stack, tstack, _ = _quant_world("int4", paired=False)
    want = JEngine(cfg, stack, max_slots=2, max_seq=64,
                   prefill_buckets=(16,), kernel="xla", decode_chunk=4,
                   kv_dtype="int8").generate(_requests(JRequest))
    capsys.readouterr()
    eng = Engine(_tcfg(cfg), tstack, max_slots=2, max_seq=64,
                 prefill_buckets=(16,), kernel=kernel, decode_chunk=4,
                 device="cpu", kv_dtype="int8")
    assert ("kv_dtype=int8 with kernel='torch'" in capsys.readouterr().out
            ) == (kernel == "torch")
    assert eng.cache.k.dtype == torch.int8 and eng.cache.quantized
    assert eng.generate(_requests(Request)) == want
    with pytest.raises(ValueError):
        Engine(_tcfg(cfg), tstack, device="cpu", kv_dtype="int4")


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_stack_nbytes_and_stacking_match_jax(mode):
    cfg, stack, tstack, tenants = _quant_world(mode, paired=False)
    assert tst.stack_nbytes(tstack) == jst.stack_nbytes(stack)
    # stack_tenants over the port's quantized base gives JAX's stack.
    params = _dense_params(cfg)
    tbase = tq.quantize_base(params_from_numpy(params, "cpu"), mode)
    got = tst.stack_tenants(_tcfg(cfg), tbase,
                            [params_from_numpy(_np_tree(c), "cpu")
                             for c in tenants], device="cpu")
    for name in jl.PROJ_NAMES:
        w = stack.params["layers"][name]
        assert type(got.params["layers"][name]).__name__ == type(w).__name__
        for gf, wf in zip(got.params["layers"][name], w):
            _equal(gf, wf)
    assert tst.stack_nbytes(got) == jst.stack_nbytes(stack)


# ---------------------------------------------------------------------------
# Interchange
# ---------------------------------------------------------------------------

def test_artifact_base_quant_crosses_both_ways(tmp_path):
    from bitdelta_tpu.core import artifact as jart
    from bitdelta_torch.core import artifact as tart

    _, _, _, tenants = _quant_world("int4", paired=False)
    comp = tenants[0]
    cfg = _cfg(sliding_window=6)
    jpath = str(tmp_path / "jax.safetensors")
    jart.save_delta(jpath, comp, cfg, base_quant="int4")
    got, got_cfg, meta = tart.load_delta(jpath, device="cpu",
                                         return_meta=True)
    assert meta["base_quant"] == "int4" and got_cfg == _tcfg(cfg)
    for name, d in comp.deltas.items():
        _equal(got.deltas[name].packed, d.packed)
        _equal(got.deltas[name].scale, d.scale)
    tpath = str(tmp_path / "torch.safetensors")
    tart.save_delta(tpath, got, got_cfg, base_quant="int8")
    back, back_cfg, meta = jart.load_delta(tpath, return_meta=True)
    assert meta["base_quant"] == "int8" and back_cfg == cfg
    for name, d in comp.deltas.items():
        np.testing.assert_array_equal(np.asarray(back.deltas[name].packed),
                                      np.asarray(d.packed))
    assert len(tart.load_delta(tpath, device="cpu")) == 2


def test_convert_matches_tuples_by_class_name():
    # JAX's Int4Weight and BinaryDelta share the fields (packed, scale):
    # each must arrive as its own class.
    from bitdelta_tpu.core.delta import BinaryDelta as JDelta
    from bitdelta_torch.core.delta import BinaryDelta

    rng = np.random.default_rng(8)
    w4 = jq.quantize_int4(jnp.asarray(rng.standard_normal((128, 16)),
                                      jnp.float32))
    w8 = jq.quantize_int8(jnp.asarray(rng.standard_normal((128, 16)),
                                      jnp.float32))
    delta = JDelta(w4.packed, jnp.float32(0.5))
    got = params_from_numpy(_np_tree({"a": w4, "b": w8, "c": delta}), "cpu")
    assert type(got["a"]) is tq.Int4Weight
    assert type(got["b"]) is tq.Int8Weight
    assert type(got["c"]) is BinaryDelta
    _equal(got["a"].packed, w4.packed)
    assert type(to_numpy(got["a"])) is tq.Int4Weight


def test_top_level_exports():
    import bitdelta_torch

    assert bitdelta_torch.Int4Weight is tq.Int4Weight
    assert bitdelta_torch.Int8Weight is tq.Int8Weight
    assert bitdelta_torch.quantize_base is tq.quantize_base
    assert bitdelta_torch.roundtrip_base is tq.roundtrip_base
