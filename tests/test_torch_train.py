"""PyTorch port: the scale-distillation path against the JAX package.

Calibration ids are compared bit-exact; the learning-rate schedule to
1e-6 of lr (optax evaluates it in fp32, where ``1 + cos`` loses digits
near the end of the schedule; the port in double). ``distill_scales``
runs on the tiny model of tests/test_distill_ppl.py in fp32 and is held
to JAX's own
``pallas``-vs-``xla`` tolerance there (rtol 1e-4 on losses and scales):
the port's plain path (``kernel="torch"``) against JAX ``"xla"``, and its
kernel path (``"cuda"``, which on CPU tensors runs the kernels' plain
versions behind the same autograd Functions) against JAX ``"pallas"`` in
interpret mode. Checkpoint resume is held to rtol 1e-6, as in JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bitdelta_tpu.core import artifact as jart
from bitdelta_tpu.core import compress as jcomp
from bitdelta_tpu.models import config as jcfg
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.train import data as jdata
from bitdelta_tpu.train import distill as jdistill
from bitdelta_torch.convert import params_from_numpy
from bitdelta_torch.core import artifact as tart
from bitdelta_torch.core import compress as tcomp
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.ops import binary_gemm as tbg
from bitdelta_torch.ops import flash_prefill as tfp
from bitdelta_torch.train import data as tdata
from bitdelta_torch.train import distill as tdistill

DISTILL_RTOL = 1e-4
RESUME_RTOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed):
    """The tiny model of tests/test_distill_ppl.py::_pair, every weight
    drawn with numpy (norms stay ones): base N(0, 0.2^2), fine-tune =
    base + N(0, 0.05^2) on each projection. Returns the JAX config,
    numpy base and fine-tune."""
    cfg = jcfg.tiny_test_config(num_layers=2, vocab_size=64, hidden_size=32,
                                intermediate_size=64, num_heads=2,
                                num_kv_heads=2)
    rng = np.random.default_rng(seed)
    like = _np_tree(jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))

    def draw(x, scale):
        return (scale * rng.standard_normal(x.shape)).astype(np.float32)

    base = {"embed": draw(like["embed"], 0.2),
            "lm_head": draw(like["lm_head"], 0.2),
            "final_norm": like["final_norm"],
            "layers": {n: draw(w, 0.2) if n in jl.PROJ_NAMES else w
                       for n, w in like["layers"].items()}}
    fine = dict(base)
    fine["layers"] = {n: w + draw(w, 0.05) if n in jl.PROJ_NAMES else w
                      for n, w in base["layers"].items()}
    return cfg, base, fine


def _tcfg(cfg):
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def _port_world(cfg, base, fine):
    """The same model for the port: params on the CPU and the JAX
    package's compression of it (bit-exact with the port's own,
    tests/test_torch_delta_artifact.py)."""
    comp = jcomp.compress_model(jax.tree.map(jnp.asarray, base),
                                jax.tree.map(jnp.asarray, fine))
    return (_tcfg(cfg), params_from_numpy(base, "cpu"),
            params_from_numpy(fine, "cpu"),
            params_from_numpy(_np_tree(comp), "cpu"), comp)


def _tdcfg(**kw):
    return tdistill.DistillConfig(**{"compute_dtype": "float32", **kw})


# ---------------------------------------------------------------------------
# Calibration data and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,steps,bsz,length,seed",
                         [(64, 3, 2, 32, 11), (32000, 2, 4, 128, 0),
                          (1000, 5, 1, 7, 123)])
def test_synthetic_batches_match_jax(vocab, steps, bsz, length, seed):
    got = tdata.synthetic_batches(vocab, steps, bsz, length, seed)
    want = jdata.synthetic_batches(vocab, steps, bsz, length, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


class _CharTokenizer:
    """Characters to ids, right-padded with 0 and truncated: the subset
    of a Hugging Face tokenizer's call that calibration uses."""

    vocab_size = 300

    def __call__(self, texts, padding, truncation, max_length):
        assert padding == "max_length" and truncation
        ids = [[min(ord(c), 299) for c in t][:max_length] for t in texts]
        return {"input_ids": [row + [0] * (max_length - len(row))
                              for row in ids]}


def test_calibration_from_texts_and_file_match_jax(tmp_path):
    tok = _CharTokenizer()
    texts = [f"calibration text number {i} " * (i + 1) for i in range(9)]
    np.testing.assert_array_equal(
        tdata.batches_from_texts(tok, texts, 4, 16),
        jdata.batches_from_texts(tok, texts, 4, 16))
    path = tmp_path / "corpus.txt"
    path.write_text("".join(texts) * 50)
    assert (tdata.texts_from_file(str(path), 5, 64)
            == jdata.texts_from_file(str(path), 5, 64))
    kw = dict(num_steps=3, batch_size=2, max_length=24,
              text_file=str(path))
    np.testing.assert_array_equal(tdata.get_calibration_batches(tok, **kw),
                                  jdata.get_calibration_batches(tok, **kw))
    with pytest.raises(ValueError):
        tdata.batches_from_texts(tok, texts[:1], 2, 16)


@pytest.mark.parametrize("vocab_size", [None, 77])
def test_synthetic_calibration_source_matches_jax(vocab_size):
    kw = dict(num_steps=4, batch_size=3, max_length=9,
              dataset_name="synthetic", vocab_size=vocab_size, seed=5)
    tok = _CharTokenizer()
    got = tdata.get_calibration_batches(tok, **kw)
    np.testing.assert_array_equal(got,
                                  jdata.get_calibration_batches(tok, **kw))
    assert got.max() < (vocab_size or tok.vocab_size)


@pytest.mark.parametrize("lr,steps", [(1e-4, 100), (1e-3, 7), (3e-3, 1)])
def test_cosine_lr_matches_optax(lr, steps):
    sched = optax.cosine_decay_schedule(lr, steps)
    for t in list(range(steps + 1)) + [steps + 3, 2 * steps + 5]:
        np.testing.assert_allclose(tdistill.cosine_lr(lr, steps, t),
                                   float(sched(t)), rtol=1e-6,
                                   atol=1e-6 * lr)
    # Unlike torch's CosineAnnealingLR, it stays at 0 past the end.
    assert tdistill.cosine_lr(lr, steps, steps + 1) == 0.0


def test_resolve_kernel():
    cpu = torch.device("cpu")
    assert tdistill.resolve_kernel("auto", cpu) == "torch"
    assert tdistill.resolve_kernel("auto", torch.device("cuda")) == "cuda"
    assert tdistill.resolve_kernel("cuda", cpu) == "cuda"
    with pytest.raises(ValueError):
        tdistill.resolve_kernel("pallas", cpu)


# ---------------------------------------------------------------------------
# Compression helpers of the slice
# ---------------------------------------------------------------------------

def test_student_params_and_scales_match_jax():
    cfg, base, fine = _pair(2)
    _, tbase, _, tc, comp = _port_world(cfg, base, fine)
    want = _np_tree(jcomp.student_params(jax.tree.map(jnp.asarray, base),
                                         comp))
    got = tcomp.student_params(tbase, tc)
    assert sorted(got) == sorted(want)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name in ("embed", "lm_head", "final_norm"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    for name, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(), w)
    scales = tcomp.get_scales(tc)
    new = {n: (s * 1.5).requires_grad_() for n, s in scales.items()}
    rebuilt = tcomp.with_scales(tc, new)
    for name, d in rebuilt.deltas.items():
        assert d.scale.dtype == torch.float32 and not d.scale.requires_grad
        assert d.packed is tc.deltas[name].packed
        np.testing.assert_array_equal(d.scale.numpy(),
                                      new[name].detach().numpy())


# ---------------------------------------------------------------------------
# distill_scales against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_kernel,port_kernel",
                         [("xla", "torch"), ("pallas", "cuda")])
def test_distill_scales_matches_jax(jax_kernel, port_kernel):
    from jax.experimental.pallas import tpu as pltpu

    cfg, base, fine = _pair(11)
    tcfg, tbase, tfine, tc, comp = _port_world(cfg, base, fine)
    one = tdata.synthetic_batches(cfg.vocab_size, 1, 2, 32, seed=11)[0]
    batches = np.repeat(one[None], 2, axis=0)
    jd = jdistill.DistillConfig(lr=1e-3, num_steps=2,
                                compute_dtype="float32", kernel=jax_kernel)
    with pltpu.force_tpu_interpret_mode():
        want, want_losses = jdistill.distill_scales(
            cfg, jax.tree.map(jnp.asarray, base),
            jax.tree.map(jnp.asarray, fine), comp, batches, jd)
    counts = (tbg.binary_matmul.launches, tbg.binary_matmul_t.launches,
              tfp.flash_prefill_attention.launches)
    got, got_losses = tdistill.distill_scales(
        tcfg, tbase, tfine, tc, batches,
        _tdcfg(lr=1e-3, num_steps=2, kernel=port_kernel))
    np.testing.assert_allclose(got_losses, want_losses, rtol=DISTILL_RTOL)
    for name, d in want.deltas.items():
        np.testing.assert_allclose(got.deltas[name].scale.numpy(),
                                   np.asarray(d.scale), rtol=DISTILL_RTOL)
        # The scales moved (the comparison is not of two untouched sets).
        assert not np.array_equal(got.deltas[name].scale.numpy(),
                                  np.asarray(comp.deltas[name].scale))
    # CPU tensors launch nothing.
    assert counts == (tbg.binary_matmul.launches,
                      tbg.binary_matmul_t.launches,
                      tfp.flash_prefill_attention.launches)


def test_distill_step_gradients_match_jax():
    # The first step's loss and scale gradients (kernel path) against
    # jax.value_and_grad of the JAX package's loss.
    cfg, base, fine = _pair(5)
    tcfg, tbase, tfine, tc, comp = _port_world(cfg, base, fine)
    batch = tdata.synthetic_batches(cfg.vocab_size, 1, 2, 16, seed=5)[0]
    sp = jcomp.student_params(jax.tree.map(jnp.asarray, base), comp)
    fj = jax.tree.map(jnp.asarray, fine)

    def loss_fn(scales):
        deltas = {n: comp.deltas[n]._replace(scale=s)
                  for n, s in scales.items()}
        s = jl.forward(cfg, sp, jnp.asarray(batch), deltas=deltas,
                       compute_dtype=jnp.float32)
        t = jl.forward(cfg, fj, jnp.asarray(batch),
                       compute_dtype=jnp.float32)
        return jnp.mean((t - s) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(jcomp.get_scales(comp))
    scales = {n: s.clone().requires_grad_()
              for n, s in tcomp.get_scales(tc).items()}
    dcfg = _tdcfg(lr=1e-3, num_steps=4, kernel="cuda")
    opt = tdistill.make_optimizer(scales, dcfg)
    step = tdistill.make_distill_step(tcfg, dcfg, tbase, tfine, tc, scales,
                                      opt)
    loss = step(torch.from_numpy(batch).long())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for name, g in want_grads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(scales[name].grad.numpy(), g,
                                   rtol=1e-4, atol=1e-4 * np.abs(g).max())


def test_distillation_reduces_logit_mse():
    # Mirrors tests/test_distill_ppl.py::test_distillation_reduces_logit_mse
    # on the port's kernel path.
    cfg, base, fine = _pair(3)
    tcfg, tbase, tfine, tc, _ = _port_world(cfg, base, fine)
    before = {n: s.clone() for n, s in tcomp.get_scales(tc).items()}
    one = tdata.synthetic_batches(cfg.vocab_size, 1, 4, 32, seed=3)[0]
    batches = np.repeat(one[None], 40, axis=0)
    calibrated, losses = tdistill.distill_scales(
        tcfg, tbase, tfine, tc, batches,
        _tdcfg(lr=1e-3, num_steps=40, kernel="cuda"))
    assert losses[-1] < 0.99 * losses[0], (losses[0], losses[-1])
    assert losses[-1] <= min(losses) * 1.01      # settled, not oscillating
    for name, d in calibrated.deltas.items():
        assert torch.isfinite(d.scale).all()
        assert d.scale.shape == tc.deltas[name].scale.shape
        # The caller's scales are untouched.
        assert torch.equal(tc.deltas[name].scale, before[name])
    # Calibrated scales track the teacher better on the trained batch.
    toks = torch.from_numpy(one).long()
    f32 = torch.float32
    t = tl.forward(tcfg, tfine, toks, compute_dtype=f32)
    sp = tcomp.student_params(tbase, tc)
    s0 = tl.forward(tcfg, sp, toks, deltas=tc.deltas, compute_dtype=f32)
    s1 = tl.forward(tcfg, sp, toks, deltas=calibrated.deltas,
                    compute_dtype=f32)
    assert torch.mean((t - s1) ** 2) < torch.mean((t - s0) ** 2)


def test_distill_checkpoint_resume_matches_uninterrupted(tmp_path):
    # Mirrors tests/test_distill_ppl.py: 6 steps straight against 3 steps
    # (checkpointed) and a resume with the full batch list.
    cfg, base, fine = _pair(17)
    tcfg, tbase, tfine, tc, _ = _port_world(cfg, base, fine)
    batches = tdata.synthetic_batches(cfg.vocab_size, 6, 2, 16, seed=17)
    dcfg = _tdcfg(lr=1e-3, num_steps=6, kernel="cuda")
    ref, losses_ref = tdistill.distill_scales(tcfg, tbase, tfine, tc,
                                              batches, dcfg)
    ckpt = str(tmp_path / "ck.safetensors")
    tdistill.distill_scales(tcfg, tbase, tfine, tc, batches[:3], dcfg,
                            checkpoint_path=ckpt, checkpoint_every=3)
    got, losses_got = tdistill.distill_scales(
        tcfg, tbase, tfine, tc, batches, dcfg, checkpoint_path=ckpt,
        checkpoint_every=3)
    assert len(losses_got) == 3
    np.testing.assert_allclose(losses_got, losses_ref[3:], rtol=RESUME_RTOL)
    for name, d in ref.deltas.items():
        np.testing.assert_allclose(got.deltas[name].scale.numpy(),
                                   d.scale.numpy(), rtol=RESUME_RTOL)


def test_distilled_artifact_loads_bit_exact_in_jax(tmp_path):
    cfg, base, fine = _pair(23)
    tcfg, tbase, tfine, tc, _ = _port_world(cfg, base, fine)
    batches = tdata.synthetic_batches(cfg.vocab_size, 2, 2, 16, seed=23)
    calibrated, _ = tdistill.distill_scales(
        tcfg, tbase, tfine, tc, batches,
        _tdcfg(lr=1e-3, num_steps=2, kernel="cuda"))
    path = str(tmp_path / "diff.safetensors")
    tart.save_delta(path, calibrated, tcfg)
    got, got_cfg = jart.load_delta(path)
    assert got_cfg == cfg
    for name, d in calibrated.deltas.items():
        np.testing.assert_array_equal(np.asarray(got.deltas[name].scale),
                                      d.scale.numpy())
        np.testing.assert_array_equal(np.asarray(got.deltas[name].packed),
                                      d.packed.numpy())
    back, _ = tart.load_delta(path, device="cpu")
    for name, d in calibrated.deltas.items():
        assert torch.equal(back.deltas[name].scale, d.scale)
