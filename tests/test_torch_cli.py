"""The port's CLIs (``bitdelta_torch.cli.{train,serve,eval_ppl}``) against
JAX's on the CPU, over a tiny Llama checkpoint pair written locally with
transformers' ``save_pretrained`` (fully offline: the byte-tokenizer
fallback and synthetic calibration). The port runs with ``--device cpu
--kernel torch``, JAX with ``--kernel xla``, both in fp32.

Tolerances:
* ``diff_untrained.safetensors``: packed words and extras bit-equal; the
  scales (``mean |fine - base|`` of each matrix, summed in another order
  by torch than by XLA) within rtol 1e-6, as
  ``tests/test_torch_delta_artifact.py`` holds ``quantize_delta``;
* ``diff.safetensors``: packed words bit-equal, scales and losses within
  ``DISTILL_RTOL`` (1e-4), the tolerance ``tests/test_torch_train.py``
  holds ``distill_scales`` to; a resumed run within rtol 1e-6 of the run
  without a break;
* ``corr_stddev.csv`` within 1e-6; served greedy tokens equal; PPL within
  1e-4 relative; the exported model's tensors bit-equal to JAX's export.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

DISTILL_RTOL = 1e-4
SCALE_RTOL = 1e-6
PPL_RTOL = 1e-4

TRAIN_ARGS = ["--num_steps", "3", "--batch_size", "2", "--max_length", "16",
              "--dataset_name", "synthetic", "--dtype", "float32"]
PORT = ["--device", "cpu", "--kernel", "torch"]


def write_pair(root, hidden_size=64, intermediate_size=128):
    """A tiny random HF Llama base and a perturbed fine-tune under
    ``root``, and a text corpus; returns ``(base, fine, root)``."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    cfg = LlamaConfig(vocab_size=320, hidden_size=hidden_size,
                      intermediate_size=intermediate_size,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128,
                      rms_norm_eps=1e-6, tie_word_embeddings=False)
    base = LlamaForCausalLM(cfg).eval()
    base.save_pretrained(root / "base", safe_serialization=True)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if "proj" in name:
                p.add_(0.02 * torch.randn_like(p))
    base.save_pretrained(root / "fine", safe_serialization=True)
    corpus = root / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog. " * 40)
    return str(root / "base"), str(root / "fine"), str(root)


@pytest.fixture(scope="module")
def hf_pair(tmp_path_factory):
    return write_pair(tmp_path_factory.mktemp("ckpts"))


@pytest.fixture(scope="module")
def trained(hf_pair):
    """The train CLI of each package on the same pair: ``(port dir, jax
    dir)``. The port's run also exports the calibrated model."""
    from bitdelta_torch.cli.train import main as t_train
    from bitdelta_tpu.cli.train import main as j_train

    base, fine, root = hf_pair
    pdir, jdir = os.path.join(root, "port"), os.path.join(root, "jax")
    common = ["--base_model", base, "--finetuned_model", fine] + TRAIN_ARGS
    t_train(common + PORT + ["--save_dir", pdir, "--debug",
                             "--save_full_model"])
    j_train(common + ["--kernel", "xla", "--save_dir", jdir, "--debug"])
    return pdir, jdir


def _read(path):
    from bitdelta_torch.core.artifact import read_safetensors

    return read_safetensors(path)


def _assert_artifacts(got_path, want_path, scale_rtol):
    got, gmeta = _read(got_path)
    want, wmeta = _read(want_path)
    assert set(got) == set(want)
    assert json.loads(gmeta["model_config"]) == json.loads(
        wmeta["model_config"])
    assert gmeta.get("base_quant") == wmeta.get("base_quant")
    for key in want:
        if key.endswith(".scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=scale_rtol,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_train_cli_diff_untrained_matches_jax(trained):
    pdir, jdir = trained
    _assert_artifacts(os.path.join(pdir, "diff_untrained.safetensors"),
                      os.path.join(jdir, "diff_untrained.safetensors"),
                      SCALE_RTOL)


def test_train_cli_diff_and_losses_match_jax(trained):
    pdir, jdir = trained
    _assert_artifacts(os.path.join(pdir, "diff.safetensors"),
                      os.path.join(jdir, "diff.safetensors"), DISTILL_RTOL)
    got = json.load(open(os.path.join(pdir, "train_loss.json")))
    want = json.load(open(os.path.join(jdir, "train_loss.json")))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=DISTILL_RTOL)


def test_train_cli_debug_corr_stddev_matches_jax(trained):
    pdir, jdir = trained

    def read(d):
        lines = open(os.path.join(d, "corr_stddev.csv")).read().split()
        assert lines[0] == "corr,stddev"
        return [float(v) for v in lines[1].split(",")]

    np.testing.assert_allclose(read(pdir), read(jdir), rtol=0, atol=1e-6)


def test_train_cli_resume_lands_on_the_uninterrupted_run(hf_pair,
                                                        monkeypatch):
    """A run stopped right after its step-2 checkpoint, started again,
    ends where the run without a break ends."""
    from bitdelta_torch.cli.train import main
    from bitdelta_torch.train import distill

    base, fine, root = hf_pair
    common = (["--base_model", base, "--finetuned_model", fine]
              + TRAIN_ARGS[2:] + ["--num_steps", "4", "--batch_size", "2"]
              + PORT)
    whole = os.path.join(root, "resume_whole")
    main(common + ["--save_dir", whole])

    class Stop(Exception):
        pass

    save = distill.save_distill_checkpoint

    def save_then_stop(*a, **kw):
        save(*a, **kw)
        raise Stop

    broken = os.path.join(root, "resume_broken")
    monkeypatch.setattr(distill, "save_distill_checkpoint", save_then_stop)
    with pytest.raises(Stop):
        main(common + ["--save_dir", broken, "--checkpoint_every", "2"])
    monkeypatch.setattr(distill, "save_distill_checkpoint", save)
    assert os.path.exists(os.path.join(broken, "distill_ckpt.safetensors"))
    main(common + ["--save_dir", broken, "--checkpoint_every", "2"])
    got, _ = _read(os.path.join(broken, "diff.safetensors"))
    want, _ = _read(os.path.join(whole, "diff.safetensors"))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def _smoke_tokens(out: str):
    """Per-tenant token ids of a ``--smoke_test`` NDJSON stream."""
    assert "[smoke ok]" in out
    toks = {}
    for line in out.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            assert set(rec) == {"tenant", "token_id", "text", "done"}
            toks.setdefault(rec["tenant"], []).append(rec["token_id"])
    return toks


def serve_tokens(capsys, main, base, artifacts, extra):
    argv = ["--base_model", base, "--dtype", "float32", "--max_seq", "64",
            "--smoke_test"] + extra
    for name, path in artifacts.items():
        argv += ["--delta", f"{name}={path}"]
    capsys.readouterr()
    main(argv)
    return _smoke_tokens(capsys.readouterr().out)


@pytest.mark.parametrize("artifacts_of", ("port", "jax"))
def test_serve_cli_greedy_tokens_match_jax(hf_pair, trained, capsys,
                                           artifacts_of):
    """Each package's artifacts through both serve CLIs: the same greedy
    tokens for every tenant (so the artifacts cross both ways)."""
    from bitdelta_torch.cli.serve import main as t_serve
    from bitdelta_tpu.cli.serve import main as j_serve

    base, _, _ = hf_pair
    d = trained[0 if artifacts_of == "port" else 1]
    arts = {"tuned": os.path.join(d, "diff.safetensors"),
            "untrained": os.path.join(d, "diff_untrained.safetensors")}
    got = serve_tokens(capsys, t_serve, base, arts, PORT)
    want = serve_tokens(capsys, j_serve, base, arts, ["--kernel", "xla"])
    assert set(got) == {"tuned", "untrained"}
    assert got == want


def test_serve_cli_kernel_route_on_cpu_tensors(hf_pair, trained, capsys):
    """``--kernel cuda`` on CPU tensors takes the kernels' plain versions
    (the engine's pair layout included): the same tokens as ``torch``."""
    from bitdelta_torch.cli.serve import main as t_serve

    base, _, _ = hf_pair
    arts = {"tuned": os.path.join(trained[0], "diff.safetensors")}
    plain = serve_tokens(capsys, t_serve, base, arts, PORT)
    routed = serve_tokens(capsys, t_serve, base, arts,
                          ["--device", "cpu", "--kernel", "cuda",
                           "--no_warmup"])
    assert routed == plain


def eval_ppl_cli(main, base, diff, corpus, save_dir, extra):
    main(["--base_model", base, "--model_diff", diff, "--text_file", corpus,
          "--context_size", "64", "--window_size", "32", "--dtype",
          "float32", "--save_dir", save_dir] + extra)
    return float(open(os.path.join(save_dir, "ppl.txt")).read())


@pytest.mark.parametrize("artifact_of", ("port", "jax"))
def test_eval_cli_ppl_matches_jax(hf_pair, trained, tmp_path, artifact_of):
    from bitdelta_torch.cli.eval_ppl import main as t_eval
    from bitdelta_tpu.cli.eval_ppl import main as j_eval

    base, _, root = hf_pair
    corpus = os.path.join(root, "corpus.txt")
    diff = os.path.join(trained[0 if artifact_of == "port" else 1],
                        "diff.safetensors")
    got = eval_ppl_cli(t_eval, base, diff, corpus, str(tmp_path / "t"),
                       PORT)
    want = eval_ppl_cli(j_eval, base, diff, corpus, str(tmp_path / "j"), [])
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def test_export_matches_jax_and_loads_in_transformers(hf_pair, trained,
                                                      tmp_path):
    """The train CLI's ``calibrated_model/``: bit-equal to JAX's export of
    the same fused params, loadable by JAX's importer and transformers."""
    import jax.numpy as jnp
    from transformers import AutoModelForCausalLM

    from bitdelta_torch.core.artifact import iter_safetensors
    from bitdelta_tpu.core.artifact import load_delta
    from bitdelta_tpu.core.compress import fuse_compressed
    from bitdelta_tpu.core.export import save_full_model
    from bitdelta_tpu.models.hf_import import load_hf_params

    base, _, _ = hf_pair
    pdir, _ = trained
    got_dir = os.path.join(pdir, "calibrated_model")
    cfg, base_params = load_hf_params(base, dtype=jnp.float32)
    comp, _ = load_delta(os.path.join(pdir, "diff.safetensors"))
    want_dir = str(tmp_path / "jax_export")
    save_full_model(cfg, fuse_compressed(base_params, comp), want_dir)

    got = dict(iter_safetensors(os.path.join(got_dir, "model.safetensors")))
    want = dict(iter_safetensors(os.path.join(want_dir,
                                              "model.safetensors")))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key
    assert (json.load(open(os.path.join(got_dir, "config.json")))
            == json.load(open(os.path.join(want_dir, "config.json"))))

    _, reloaded = load_hf_params(got_dir, dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(reloaded["layers"]["down_proj"][1]),
        got["model.layers.1.mlp.down_proj.weight"].numpy().T)
    hf = AutoModelForCausalLM.from_pretrained(got_dir)
    assert torch.equal(hf.model.layers[0].self_attn.q_proj.weight.detach(),
                       got["model.layers.0.self_attn.q_proj.weight"])


def test_export_round_trip_through_the_port(hf_pair, trained):
    """``load_hf_params`` of the export equals ``fuse_compressed(base,
    diff)`` exactly."""
    from bitdelta_torch.core.artifact import load_delta
    from bitdelta_torch.core.compress import fuse_compressed
    from bitdelta_torch.models.hf_import import load_hf_params

    base, _, _ = hf_pair
    pdir, _ = trained
    _, base_params = load_hf_params(base, dtype=torch.float32, device="cpu")
    comp, _ = load_delta(os.path.join(pdir, "diff.safetensors"),
                         device="cpu")
    want = fuse_compressed(base_params, comp)
    _, got = load_hf_params(os.path.join(pdir, "calibrated_model"),
                            dtype=torch.float32, device="cpu")
    for name, w in want["layers"].items():
        assert torch.equal(got["layers"][name], w), name
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(got[name], want[name]), name


def test_cli_runs_without_safetensors_or_transformers(hf_pair, trained,
                                                     tmp_path, monkeypatch,
                                                     capsys):
    """As on a machine that has neither package: the serve and eval CLIs
    load the checkpoint and the artifacts, and the tokenizer falls back to
    bytes."""
    from bitdelta_torch.cli.eval_ppl import main as t_eval
    from bitdelta_torch.cli.serve import main as t_serve

    base, _, root = hf_pair
    for mod in [m for m in sys.modules
                if m.split(".")[0] in ("safetensors", "transformers")]:
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    diff = os.path.join(trained[0], "diff.safetensors")
    toks = serve_tokens(capsys, t_serve, base, {"tuned": diff},
                        PORT + ["--no_warmup"])
    assert len(toks["tuned"]) == 4
    ppl = eval_ppl_cli(t_eval, base, diff, os.path.join(root, "corpus.txt"),
                       str(tmp_path), PORT)
    assert np.isfinite(ppl)


@pytest.mark.parametrize("cli", ("train", "serve", "eval_ppl"))
def test_cli_mesh_other_than_one_card_exits_naming_a6(hf_pair, tmp_path,
                                                      cli):
    """``--mesh 2,1`` in one process: train and serve take a mesh, but one
    process is a world of one rank, so they exit naming the launcher that
    starts one process a rank; eval_ppl takes the flag and runs on one
    device, as JAX's CLI does."""
    import importlib

    main = importlib.import_module(f"bitdelta_torch.cli.{cli}").main
    base, fine, root = hf_pair
    argv = {"train": ["--base_model", base, "--finetuned_model", fine,
                      "--save_dir", str(tmp_path)],
            "serve": ["--base_model", base, "--delta", "a=b"],
            "eval_ppl": ["--base_model", base, "--text_file",
                         os.path.join(root, "corpus.txt"), "--save_dir",
                         str(tmp_path), "--context_size", "64",
                         "--window_size", "32", "--dtype", "float32"]}[cli]
    argv += ["--mesh", "2,1", "--device", "cpu"]
    if cli == "eval_ppl":
        ppl = main(argv)
        assert np.isfinite(ppl)
        assert float(open(tmp_path / "ppl.txt").read()) == ppl
        return
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        main(argv)


def test_train_cli_mesh_under_torch_distributed_run(hf_pair, trained,
                                                    tmp_path):
    """``train --mesh 1,2`` as two processes under ``python -m
    torch.distributed.run`` on the CPU: both ranks exit 0, rank 0 alone
    writes, and its artifacts are the single-process run's (words and
    extras bit-exact, scales within 1e-5, losses within DISTILL_RTOL)."""
    import subprocess

    from tests.torch_mesh_worker import free_port

    base, fine, _ = hf_pair
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
               HF_HUB_OFFLINE="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(free_port()), "-m", "bitdelta_torch.cli.train", "--base_model",
         base, "--finetuned_model", fine, *TRAIN_ARGS, *PORT, "--mesh",
         "1,2", "--save_dir", str(tmp_path), "--debug"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("saved ") == 1
    assert sorted(os.listdir(tmp_path)) == [
        "corr_stddev.csv", "diff.safetensors", "diff_untrained.safetensors",
        "train_loss.json"]
    pdir = trained[0]
    _assert_artifacts(os.path.join(tmp_path, "diff_untrained.safetensors"),
                      os.path.join(pdir, "diff_untrained.safetensors"),
                      SCALE_RTOL)
    _assert_artifacts(os.path.join(tmp_path, "diff.safetensors"),
                      os.path.join(pdir, "diff.safetensors"), 1e-5)
    np.testing.assert_allclose(
        json.load(open(tmp_path / "train_loss.json")),
        json.load(open(os.path.join(pdir, "train_loss.json"))),
        rtol=DISTILL_RTOL)


def test_cli_device_cuda_without_a_card_raises(hf_pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bitdelta_torch.cli.eval_ppl import main

    base, _, root = hf_pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--base_model", base, "--text_file",
              os.path.join(root, "corpus.txt"), "--save_dir",
              str(tmp_path)])


def test_cli_modules_import_neither_jax_nor_the_jax_package():
    import subprocess

    code = ("import sys\n"
            "import bitdelta_torch.cli.train, bitdelta_torch.cli.serve, "
            "bitdelta_torch.cli.eval_ppl, bitdelta_torch.core.export, "
            "bitdelta_torch.models.hf_import, "
            "bitdelta_torch.utils.profiling, "
            "bitdelta_torch.utils.diagnostics, "
            "bitdelta_torch.models.quant_import\n"
            "import bitdelta_torch as b\n"
            "for n in b._LAZY: getattr(b, n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'bitdelta_tpu', 'safetensors', 'transformers')]\n"
            "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   timeout=120)
