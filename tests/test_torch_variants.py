"""PyTorch port: the delta-fidelity variants (``research/variants.py``)
against the JAX package on the CPU.

Tolerances:
* sign planes (``packed``, ``plus``, ``minus``) are bit-exact, and so are
  the quantile positions: ``binary_median``'s scale and the ternary
  threshold, here and in the two tests above 2^24 elements;
* sums over a matrix in another order than XLA's (the ternary scale,
  the column scales, the 1-bit scale of ``"binary"``) agree within
  1e-6 relative;
* LoRA is held by ``a @ b`` (the SVD's factors are unique only up to
  signs) within 1e-5 of the delta's largest element on an exact low-rank
  delta with small noise, and by its reconstruction error's norm within
  1e-5 relative on a random delta (1e-5 of the delta's norm at full
  rank, where the error is rounding);
* a dequantize / apply of a delta carried across from JAX is bit-exact;
  ``column_delta_linear`` agrees within 2e-5 (fp32) and 1e-2 relative to
  the output scale (bf16 compute);
* fused models: each matrix within 1e-6 of its fine-tune's largest
  element (2e-5 for LoRA);
* perplexities within 1e-4 relative of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.ops.packing import pack_signs_np
from bitdelta_tpu.research import variants as jv
from bitdelta_torch.convert import params_from_numpy, to_numpy
from bitdelta_torch.research import variants as tv

SCALE_RTOL = 1e-6


def _pair(k=64, n=48, seed=0, eps=0.05):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((k, n)).astype(np.float32)
    fine = base + eps * rng.standard_normal((k, n)).astype(np.float32)
    return base, fine


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(jtuple):
    return params_from_numpy(jax.tree.map(np.asarray, jtuple), "cpu")


# ---------------------------------------------------------------------------
# The quantile positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_quantile_matches_jnp(seed):
    """Linear quantiles and the midpoint median, bit-exact over sizes
    from 1 to a few thousand, q in [0, 1] (XLA's fused multiply-add of
    the interpolation included)."""
    rng = np.random.default_rng(seed)
    lin = jax.jit(lambda a, q: jnp.quantile(a, q))
    med = jax.jit(jnp.median)
    sizes = [1, 2] + [int(s) for s in rng.integers(3, 3000, 6)]
    for size in sizes:
        mag = np.abs(rng.standard_normal(size).astype(np.float32))
        for q in (0.0, 0.5, 1.0, float(rng.random()), float(rng.random())):
            got = tv._quantile(_t(mag), q, "linear")
            assert got.dtype == torch.float32
            assert got.item() == float(lin(jnp.asarray(mag), q)), (size, q)
        assert (tv._quantile(_t(mag), 0.5, "midpoint").item()
                == float(med(jnp.asarray(mag)))), size


def test_quantile_nan_rule():
    a = np.arange(10, dtype=np.float32)
    a[3] = np.nan
    assert np.isnan(float(jnp.median(jnp.asarray(a))))
    assert torch.isnan(tv._quantile(_t(a), 0.5, "midpoint"))
    assert torch.isnan(tv._quantile(_t(a), 0.2, "linear"))
    with pytest.raises(ValueError, match="quantile method"):
        tv._quantile(_t(a), 0.5, "nearest")


def _distinct_delta(k, n, seed):
    """A (k, n) fp32 delta whose magnitudes are k*n distinct fp32 values
    (consecutive floats from 1.0 on, shuffled, random signs), so that
    the two middle elements differ."""
    rng = np.random.default_rng(seed)
    bits = np.int32(np.float32(1.0).view(np.int32)) + rng.permutation(
        k * n).astype(np.int32)
    mag = bits.view(np.float32)
    sign = np.where(rng.random(k * n) < 0.5, -1.0, 1.0).astype(np.float32)
    return (mag * sign).reshape(k, n)


# (4096, 4112): 16,842,752 elements, above 2^24: n - 1 rounds in fp32.
BIG = (4096, 4112)


@pytest.fixture(scope="module")
def big_delta():
    return _distinct_delta(*BIG, seed=0)


@pytest.fixture(scope="module")
def big_positions(big_delta):
    """JAX's positions over |big_delta|: ``jnp.median`` and the ternary
    thresholds at fractions 0.5 and 0.3 (one ``jnp.quantile`` call, one
    sort). The planes and scales follow from them, and are held against
    numpy below; ``quantize_ternary`` itself is held against JAX's at the
    small sizes."""
    mag = jnp.asarray(np.abs(big_delta))
    q = jnp.asarray([1.0 - 0.5, 1.0 - 0.3], jnp.float32)
    got = np.asarray(jnp.quantile(mag, q))
    return {"median": float(jnp.median(mag)), 0.5: got[0], 0.3: got[1]}


def test_binary_median_position_above_2_24(big_delta, big_positions):
    diff = big_delta
    base = np.zeros(BIG, np.float32)
    got = tv.quantize_ternary(_t(base), _t(diff), binary_median=True)
    assert got.scale.item() == big_positions["median"]
    # jnp.median took the upper middle element; torch.median takes the
    # lower one, and neither is the midpoint of the two.
    mid = diff.size // 2
    part = np.partition(np.abs(diff).ravel(), (mid - 1, mid))
    lower, upper = part[mid - 1], part[mid]
    assert lower != upper
    assert got.scale.item() == upper
    assert torch.median(_t(np.abs(diff))).item() == lower
    np.testing.assert_array_equal(got.plus.numpy(), pack_signs_np(diff >= 0))
    np.testing.assert_array_equal(got.minus.numpy(), pack_signs_np(diff < 0))


@pytest.mark.parametrize("fraction", [0.5, 0.3])
def test_ternary_position_above_2_24(fraction, big_delta, big_positions):
    diff = big_delta
    base = np.zeros(BIG, np.float32)
    thresh = tv._quantile(_t(np.abs(diff)), 1.0 - fraction, "linear")
    assert thresh.item() == big_positions[fraction]
    got = tv.quantize_ternary(_t(base), _t(diff), fraction=fraction)
    mag = np.abs(diff)
    keep = mag >= big_positions[fraction]
    np.testing.assert_array_equal(got.plus.numpy(),
                                  pack_signs_np(keep & (diff >= 0)))
    np.testing.assert_array_equal(got.minus.numpy(),
                                  pack_signs_np(keep & (diff < 0)))
    want = mag.sum(where=keep, dtype=np.float64) / max(keep.sum(), 1)
    np.testing.assert_allclose(got.scale.item(), want, rtol=SCALE_RTOL)


# ---------------------------------------------------------------------------
# Ternary and binary_median
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction", [0.5, 0.3, 0.1, 1.0])
def test_quantize_ternary_matches_jax(fraction):
    base, fine = _pair(seed=3)
    want = jv.quantize_ternary(jnp.asarray(base), jnp.asarray(fine),
                               fraction=fraction)
    got = tv.quantize_ternary(_t(base), _t(fine), fraction=fraction)
    np.testing.assert_array_equal(got.plus.numpy(), np.asarray(want.plus))
    np.testing.assert_array_equal(got.minus.numpy(), np.asarray(want.minus))
    assert got.scale.dtype == torch.float32 and got.scale.ndim == 0
    np.testing.assert_allclose(got.scale.item(), float(want.scale),
                               rtol=SCALE_RTOL)


def test_quantize_binary_median_matches_jax():
    base, fine = _pair(seed=4, k=96, n=40)
    want = jv.quantize_ternary(jnp.asarray(base), jnp.asarray(fine),
                               binary_median=True)
    got = tv.quantize_ternary(_t(base), _t(fine), binary_median=True)
    assert got.scale.item() == float(want.scale)
    np.testing.assert_array_equal(got.plus.numpy(), np.asarray(want.plus))
    np.testing.assert_array_equal(got.minus.numpy(), np.asarray(want.minus))
    assert (tv.dequantize_ternary(got) != 0).all()


def test_dequantize_apply_ternary_match_jax():
    base, fine = _pair(seed=5)
    jd = jv.quantize_ternary(jnp.asarray(base), jnp.asarray(fine),
                             fraction=0.4)
    td = _carry(jd)
    assert isinstance(td, tv.TernaryDelta)
    np.testing.assert_array_equal(tv.dequantize_ternary(td).numpy(),
                                  np.asarray(jv.dequantize_ternary(jd)))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tv.apply_ternary(_t(base).to(dtype), td)
        want = jv.apply_ternary(jnp.asarray(base, jdtype), jd)
        assert got.dtype == dtype
        np.testing.assert_array_equal(to_numpy(got),
                                      np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def test_lora_exact_low_rank_matches_jax():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((64, 48)).astype(np.float32)
    a = rng.standard_normal((64, 4)).astype(np.float32)
    b = rng.standard_normal((4, 48)).astype(np.float32)
    low = a @ b
    fine = base + low + 1e-4 * rng.standard_normal((64, 48)).astype(
        np.float32)
    want = jv.quantize_lora(jnp.asarray(base), jnp.asarray(fine), rank=4)
    got = tv.quantize_lora(_t(base), _t(fine), rank=4)
    assert got.a.shape == (64, 4) and got.b.shape == (4, 48)
    tol = 1e-5 * np.abs(low).max()
    np.testing.assert_allclose(tv.dequantize_lora(got).numpy(),
                               np.asarray(jv.dequantize_lora(want)),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(tv.apply_lora(_t(base), got).numpy(),
                               np.asarray(jv.apply_lora(jnp.asarray(base),
                                                        want)),
                               rtol=0, atol=tol)
    assert tv.lora_nbytes(got) == jv.lora_nbytes(want)


@pytest.mark.parametrize("rank", [1, 8, 16, 64])
def test_lora_random_delta_error_norm_matches_jax(rank):
    base, fine = _pair(seed=2)
    want = jv.quantize_lora(jnp.asarray(base), jnp.asarray(fine), rank=rank)
    got = tv.quantize_lora(_t(base), _t(fine), rank=rank)
    diff = fine - base
    err_t = np.linalg.norm(tv.dequantize_lora(got).numpy() - diff)
    err_j = np.linalg.norm(np.asarray(jv.dequantize_lora(want)) - diff)
    # Full rank reconstructs to rounding: there the norms are compared
    # against the delta's own.
    np.testing.assert_allclose(err_t, err_j, rtol=1e-5,
                               atol=1e-5 * np.linalg.norm(diff))
    assert err_t < np.linalg.norm(diff)
    # A delta carried across dequantizes as JAX's does.
    carried = _carry(want)
    assert isinstance(carried, tv.LoRADelta)
    np.testing.assert_allclose(tv.dequantize_lora(carried).numpy(),
                               np.asarray(jv.dequantize_lora(want)),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Per-column scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_sign", ["positive", "balance"])
def test_quantize_column_matches_jax(zero_sign):
    rng = np.random.default_rng(0)
    base = rng.standard_normal((256, 128)).astype(np.float32)
    col_mag = (0.002 + 0.05 * rng.random(128)).astype(np.float32)
    fine = base + rng.standard_normal((256, 128)).astype(np.float32) * col_mag
    fine[:5, :7] = base[:5, :7]                  # exact zeros of the delta
    want = jv.quantize_column(jnp.asarray(base), jnp.asarray(fine),
                              zero_sign=zero_sign)
    got = tv.quantize_column(_t(base), _t(fine), zero_sign=zero_sign)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    assert got.scale.shape == (128,)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=SCALE_RTOL)


def test_dequantize_apply_column_match_jax():
    base, fine = _pair(seed=6, k=96, n=64)
    jd = jv.quantize_column(jnp.asarray(base), jnp.asarray(fine))
    td = _carry(jd)
    assert isinstance(td, tv.ColumnScaleDelta)
    np.testing.assert_array_equal(tv.dequantize_column(td).numpy(),
                                  np.asarray(jv.dequantize_column(jd)))
    np.testing.assert_array_equal(tv.apply_column(_t(base), td).numpy(),
                                  np.asarray(jv.apply_column(
                                      jnp.asarray(base), jd)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_column_delta_linear_matches_jax(compute):
    base, fine = _pair(seed=7, k=128, n=96)
    jd = jv.quantize_column(jnp.asarray(base), jnp.asarray(fine))
    td = _carry(jd)
    x = np.random.default_rng(8).standard_normal((5, 128)).astype(np.float32)
    want = np.asarray(jv.column_delta_linear(
        jnp.asarray(x), jnp.asarray(base), jd,
        compute_dtype=getattr(jnp, compute)))
    got = tv.column_delta_linear(_t(x), _t(base), td,
                                 compute_dtype=getattr(torch, compute))
    assert got.dtype == torch.float32 and got.shape == (5, 96)
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        # ... and equal to x @ the densely fused matrix.
        fused = tv.apply_column(_t(base), td).numpy()
        np.testing.assert_allclose(got.numpy(), x @ fused, rtol=2e-5,
                                   atol=2e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


def test_column_never_worse_than_global_scale():
    from bitdelta_torch.core.delta import dequantize_delta, quantize_delta

    rng = np.random.default_rng(0)
    base = rng.standard_normal((256, 128)).astype(np.float32)
    col_mag = (0.002 + 0.05 * rng.random(128)).astype(np.float32)
    diff = rng.standard_normal((256, 128)).astype(np.float32) * col_mag
    d_glob = quantize_delta(_t(base), _t(base + diff))
    d_col = tv.quantize_column(_t(base), _t(base + diff))
    assert torch.equal(d_col.packed, d_glob.packed)
    err_glob = np.linalg.norm(dequantize_delta(d_glob).numpy() - diff)
    err_col = np.linalg.norm(tv.dequantize_column(d_col).numpy() - diff)
    assert err_col < err_glob * 0.9


# ---------------------------------------------------------------------------
# fuse_variant_model
# ---------------------------------------------------------------------------

KINDS = [("binary", {}), ("binary_median", {}),
         ("ternary", {"fraction": 0.3}), ("lora", {"rank": 2}),
         ("column", {})]


def _llama_world():
    from bitdelta_tpu.models import llama as jl
    from bitdelta_tpu.models.config import ModelConfig

    cfg = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                      num_layers=2, num_heads=2, num_kv_heads=1,
                      max_seq_len=32)
    base = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return base, ("q_proj", "o_proj", "gate_proj", "down_proj")


def _mixtral_world():
    from bitdelta_tpu.models import mixtral as jmx

    cfg = jmx.MixtralConfig(vocab_size=128, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2,
                            num_kv_heads=1, max_seq_len=32, num_experts=2,
                            experts_per_token=1)
    base = jmx.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    return base, ("w1", "w2", "router", "q_proj")


@pytest.mark.parametrize("world", ["llama", "mixtral"])
@pytest.mark.parametrize("kind,kw", KINDS, ids=[k for k, _ in KINDS])
def test_fuse_variant_model_matches_jax(world, kind, kw):
    base, names = (_llama_world if world == "llama" else _mixtral_world)()
    fine = jax.tree.map(
        lambda v: v + 0.01 * jax.random.normal(jax.random.PRNGKey(2),
                                               v.shape), base)
    want = jax.tree.map(np.asarray,
                        jv.fuse_variant_model(base, fine, kind, **kw))
    tbase = params_from_numpy(jax.tree.map(np.asarray, base), "cpu")
    tfine = params_from_numpy(jax.tree.map(np.asarray, fine), "cpu")
    got = to_numpy(tv.fuse_variant_model(tbase, tfine, kind, **kw))
    tol = 2e-5 if kind == "lora" else 1e-6
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name, w in want["layers"].items():
        assert got["layers"][name].shape == w.shape
        fine_w = np.asarray(fine["layers"][name])
        np.testing.assert_allclose(got["layers"][name], w, rtol=0,
                                   atol=tol * np.abs(fine_w).max(),
                                   err_msg=name)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[name], want[name])
    base_np = jax.tree.map(np.asarray, base)
    fine_np = jax.tree.map(np.asarray, fine)
    for name in names:
        err_f = np.abs(got["layers"][name] - fine_np["layers"][name]).mean()
        err_b = np.abs(base_np["layers"][name]
                       - fine_np["layers"][name]).mean()
        assert err_f < err_b, (kind, name, err_f, err_b)


def test_fuse_variant_model_rejects_unknown_kwargs_and_kinds():
    base, _ = _llama_world()
    tbase = params_from_numpy(jax.tree.map(np.asarray, base), "cpu")
    tfine = {k: v for k, v in tbase.items()}
    with pytest.raises(TypeError, match="binary_median takes no"):
        tv.fuse_variant_model(tbase, tfine, "binary_median", fraction=0.3)
    with pytest.raises(ValueError, match="unknown variant kind"):
        tv.fuse_variant_model(tbase, tfine, "quaternary")


def test_fuse_variant_model_ablation_ladder():
    """The orderings of the reference's ablation workflow, on JAX's
    fine-tune of tests/test_research.py: every variant's PPL below the
    base's; full-rank LoRA the fine-tune's; per-column scales never
    behind the one coeff; each PPL within 1e-4 of JAX's."""
    import pathlib
    import sys

    from bitdelta_tpu.eval.ppl import eval_ppl as jeval
    from bitdelta_tpu.eval.ppl import tokenize_corpus
    from bitdelta_tpu.models import config as cfgs
    from bitdelta_tpu.models import llama as jl
    from bitdelta_tpu.serving.server import ByteTokenizer
    from bitdelta_torch.eval.ppl import eval_ppl
    from bitdelta_torch.models.config import ModelConfig

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_vocab_growth import MULTILINGUAL_TEXTS, _finetune_on_corpus

    tok = ByteTokenizer()
    ids = tokenize_corpus(tok, MULTILINGUAL_TEXTS)
    jcfg = cfgs.tiny_test_config(vocab_size=tok.vocab_size + 2,
                                 hidden_size=64, intermediate_size=128,
                                 num_layers=2, num_heads=4, num_kv_heads=2,
                                 dtype="float32")
    cfg = ModelConfig(**{f: getattr(jcfg, f)
                         for f in jcfg.__dataclass_fields__})
    jbase = jl.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32,
                           scale=0.25)
    jfine = _finetune_on_corpus(jcfg, jbase, ids, steps=40, lr=1e-3)
    base = params_from_numpy(jax.tree.map(np.asarray, jbase), "cpu")
    fine = params_from_numpy(jax.tree.map(np.asarray, jfine), "cpu")

    kw = dict(context_size=64, window_size=32, compute_dtype=torch.float32)
    ppl_base = eval_ppl(cfg, base, ids, **kw)
    ppl_fine = eval_ppl(cfg, fine, ids, **kw)
    assert ppl_fine < ppl_base
    ppls = {}
    for kind, vkw in [("binary", {}), ("binary_median", {}),
                      ("ternary", dict(fraction=0.5)),
                      ("lora", dict(rank=8)), ("column", {})]:
        ppls[kind] = eval_ppl(cfg, tv.fuse_variant_model(base, fine, kind,
                                                         **vkw), ids, **kw)
        assert ppls[kind] < ppl_base, (kind, ppls[kind], ppl_base)
    full = tv.fuse_variant_model(base, fine, "lora", rank=64)
    np.testing.assert_allclose(eval_ppl(cfg, full, ids, **kw), ppl_fine,
                               rtol=1e-4)
    assert ppls["column"] <= ppls["binary"] * 1.02, ppls
    jkw = dict(context_size=64, window_size=32, compute_dtype=jnp.float32)
    for kind in ("binary_median", "column"):
        want = jeval(jcfg, jv.fuse_variant_model(jbase, jfine, kind), ids,
                     **jkw)
        np.testing.assert_allclose(ppls[kind], want, rtol=1e-4,
                                   err_msg=kind)
