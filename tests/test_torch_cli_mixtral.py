"""Mixtral distillation and the Mixtral CLI pipeline of the port against
the JAX package on the CPU (fp32; the port's plain path, JAX's ``xla``).

``distill_scales(model=mixtral)`` on a tiny MoE (every attention, expert
and router scale trained) and the full pipeline, train -> serve -> eval,
over a tiny Mixtral checkpoint pair written with transformers'
``save_pretrained``, as ``tests/test_cli.py`` runs JAX's.

Tolerances: packed words bit-equal; scales and losses within
``DISTILL_RTOL`` (1e-4, ``tests/test_torch_train.py``'s); greedy served
tokens equal; PPL within 1e-4 relative (``eval_ppl(model=mixtral)``,
which no earlier test held against JAX).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_torch.convert import params_from_numpy
from bitdelta_torch.core.artifact import read_safetensors
from bitdelta_torch.models import mixtral as tmx
from bitdelta_torch.train import distill as tdistill
from bitdelta_tpu.models import mixtral as jmx
from bitdelta_tpu.train import distill as jdistill
from bitdelta_tpu.train import data as jdata

from test_torch_cli import PORT, _assert_artifacts, eval_ppl_cli, \
    serve_tokens

DISTILL_RTOL = 1e-4
PPL_RTOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_distill_scales_mixtral_matches_jax():
    cfg = jmx.MixtralConfig(vocab_size=64, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=64,
                            rms_norm_eps=1e-6, num_experts=4,
                            experts_per_token=2)
    base = _np_tree(jmx.init_params(cfg, jax.random.PRNGKey(0),
                                    jnp.float32))
    rng = np.random.default_rng(1)
    fine = dict(base)
    fine["layers"] = {
        n: (w + 0.02 * rng.standard_normal(w.shape).astype(np.float32)
            if n in jmx.MOE_PARTS else w)
        for n, w in base["layers"].items()}
    jbase = jax.tree.map(jnp.asarray, base)
    jfine = jax.tree.map(jnp.asarray, fine)
    comp = jmx.compress_mixtral(jbase, jfine)
    batches = jdata.synthetic_batches(cfg.vocab_size, 3, 2, 16, seed=3)

    jcomp, jlosses = jdistill.distill_scales(
        cfg, jbase, jfine, comp, batches,
        jdistill.DistillConfig(lr=1e-3, num_steps=3,
                               compute_dtype="float32", kernel="xla"),
        model=jmx)
    tcfg = tmx.MixtralConfig.from_dict(dataclasses.asdict(cfg))
    tcomp, tlosses = tdistill.distill_scales(
        tcfg, params_from_numpy(base, "cpu"), params_from_numpy(fine, "cpu"),
        params_from_numpy(_np_tree(comp), "cpu"), batches,
        tdistill.DistillConfig(lr=1e-3, num_steps=3,
                               compute_dtype="float32", kernel="torch"),
        model=tmx)
    np.testing.assert_allclose(tlosses, jlosses, rtol=DISTILL_RTOL)
    assert set(tcomp.deltas) == set(jmx.MOE_PARTS)
    for name, d in jcomp.deltas.items():
        before = np.asarray(comp.deltas[name].scale)
        got = tcomp.deltas[name].scale.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(d.scale),
                                   rtol=DISTILL_RTOL, err_msg=name)
        # Every scale moved: the gradient reached it.
        assert np.all(got != before), name


@pytest.fixture(scope="module")
def mixtral_pair(tmp_path_factory):
    from transformers import MixtralConfig, MixtralForCausalLM

    root = tmp_path_factory.mktemp("mixtral")
    torch.manual_seed(1)
    hf_cfg = MixtralConfig(vocab_size=320, hidden_size=64,
                           intermediate_size=96, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           num_local_experts=4, num_experts_per_tok=2,
                           max_position_embeddings=64, rms_norm_eps=1e-6,
                           tie_word_embeddings=False)
    model = MixtralForCausalLM(hf_cfg).eval()
    model.save_pretrained(root / "base", safe_serialization=True)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if any(k in name for k in ("proj", ".w1.", ".w2.", ".w3.",
                                       "gate")):
                p.add_(0.02 * torch.randn_like(p))
    model.save_pretrained(root / "fine", safe_serialization=True)
    (root / "corpus.txt").write_text(
        "sphinx of black quartz judge my vow. " * 40)
    base, fine = str(root / "base"), str(root / "fine")
    from bitdelta_torch.cli.train import main as t_train
    from bitdelta_tpu.cli.train import main as j_train

    common = ["--base_model", base, "--finetuned_model", fine,
              "--num_steps", "2", "--batch_size", "2", "--max_length", "16",
              "--dataset_name", "synthetic", "--dtype", "float32"]
    t_train(common + PORT + ["--save_dir", str(root / "port"), "--debug"])
    j_train(common + ["--kernel", "xla", "--save_dir", str(root / "jax")])
    return base, str(root)


def test_mixtral_train_cli_matches_jax(mixtral_pair):
    _, root = mixtral_pair
    for name, rtol in (("diff_untrained", 1e-6), ("diff", DISTILL_RTOL)):
        _assert_artifacts(os.path.join(root, "port", f"{name}.safetensors"),
                          os.path.join(root, "jax", f"{name}.safetensors"),
                          rtol)
    got, _ = read_safetensors(os.path.join(root, "port",
                                           "diff.safetensors"))
    assert {"deltas.w1.packed", "deltas.router.scale"} <= set(got)
    # --debug on Mixtral: the experts and the router join the stats.
    stats = open(os.path.join(root, "port", "corr_stddev.csv")).read()
    corr, std = (float(v) for v in stats.split()[1].split(","))
    assert 0 < corr <= 1 and std > 0
    assert len(json.load(open(os.path.join(root, "port",
                                           "train_loss.json")))) == 2


def test_mixtral_serve_cli_tokens_match_jax(mixtral_pair, capsys):
    from bitdelta_torch.cli.serve import main as t_serve
    from bitdelta_tpu.cli.serve import main as j_serve

    base, root = mixtral_pair
    arts = {"moe": os.path.join(root, "port", "diff.safetensors"),
            "jax_moe": os.path.join(root, "jax", "diff.safetensors")}
    got = serve_tokens(capsys, t_serve, base, arts, PORT)
    want = serve_tokens(capsys, j_serve, base, arts, ["--kernel", "xla"])
    assert set(got) == {"moe", "jax_moe"} and got == want


def test_mixtral_eval_cli_ppl_matches_jax(mixtral_pair, tmp_path):
    from bitdelta_torch.cli.eval_ppl import main as t_eval
    from bitdelta_tpu.cli.eval_ppl import main as j_eval

    base, root = mixtral_pair
    diff = os.path.join(root, "port", "diff.safetensors")
    corpus = os.path.join(root, "corpus.txt")
    got = eval_ppl_cli(t_eval, base, diff, corpus,
                       str(tmp_path / "t"), PORT)
    want = eval_ppl_cli(j_eval, base, diff, corpus, str(tmp_path / "j"), [])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


@pytest.mark.parametrize("flag", ("--quantize_base", "--save_full_model"))
def test_mixtral_train_cli_refuses_what_jax_refuses(mixtral_pair, tmp_path,
                                                    flag):
    from bitdelta_torch.cli.train import main

    base, root = mixtral_pair
    extra = [flag, "int8"] if flag == "--quantize_base" else [flag]
    with pytest.raises(SystemExit, match="not supported for Mixtral"):
        main(["--base_model", base, "--finetuned_model",
              os.path.join(root, "fine"), "--save_dir", str(tmp_path)]
             + PORT + extra)
