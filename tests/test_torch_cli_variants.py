"""The port's train and serve CLIs against JAX's on the CPU for the
artifact variants: ``--compress_embeddings`` (embed / lm_head deltas) and
``--quantize_base int8`` / ``int4`` (deltas against the quantized base,
served over it). The checkpoints of ``tests/test_torch_cli.py`` at
hidden size 128 (the W4 base takes 128-row groups) and its tolerances:
packed words bit-equal, scales within 1e-4, greedy served tokens equal
(fp32)."""

import os

import pytest

from test_torch_cli import (DISTILL_RTOL, PORT, _assert_artifacts,
                            serve_tokens, write_pair)


@pytest.fixture(scope="module")
def hf_pair(tmp_path_factory):
    return write_pair(tmp_path_factory.mktemp("ckpts128"), 128, 256)

VARIANTS = {"compress_embeddings": ["--compress_embeddings"],
            "int8": ["--quantize_base", "int8"],
            "int4": ["--quantize_base", "int4"]}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_train_and_serve_match_jax(hf_pair, capsys, variant):
    from bitdelta_torch.cli.serve import main as t_serve
    from bitdelta_torch.cli.train import main as t_train
    from bitdelta_tpu.cli.serve import main as j_serve
    from bitdelta_tpu.cli.train import main as j_train

    base, fine, root = hf_pair
    pdir = os.path.join(root, f"port_{variant}")
    jdir = os.path.join(root, f"jax_{variant}")
    common = ["--base_model", base, "--finetuned_model", fine,
              "--num_steps", "2", "--batch_size", "2", "--max_length", "16",
              "--dataset_name", "synthetic", "--dtype",
              "float32"] + VARIANTS[variant]
    t_train(common + PORT + ["--save_dir", pdir])
    j_train(common + ["--kernel", "xla", "--save_dir", jdir])
    _assert_artifacts(os.path.join(pdir, "diff.safetensors"),
                      os.path.join(jdir, "diff.safetensors"), DISTILL_RTOL)

    got = serve_tokens(capsys, t_serve, base,
                       {"t": os.path.join(pdir, "diff.safetensors")}, PORT)
    want = serve_tokens(capsys, j_serve, base,
                        {"t": os.path.join(jdir, "diff.safetensors")},
                        ["--kernel", "xla"])
    assert got == want and len(got["t"]) == 4
    if variant != "compress_embeddings":
        capsys.readouterr()
        t_serve(["--base_model", base, "--delta",
                 f"t={os.path.join(pdir, 'diff.safetensors')}",
                 "--dtype", "float32", "--max_seq", "64", "--smoke_test",
                 "--no_warmup"] + PORT)
        assert "serving the quantized base" in capsys.readouterr().out


def test_serve_cli_refuses_tenants_on_different_bases(hf_pair):
    """A bf16-base artifact beside an int8-base one."""
    from bitdelta_torch.cli.serve import main as t_serve

    base, fine, root = hf_pair
    arts = [os.path.join(root, d, "diff.safetensors")
            for d in ("port_int8", "port_int4")]
    if not all(os.path.exists(a) for a in arts):
        pytest.skip("needs the variant artifacts of this module")
    with pytest.raises(SystemExit, match="disagree on base_quant"):
        t_serve(["--base_model", base, "--delta", f"a={arts[0]}",
                 "--delta", f"b={arts[1]}", "--smoke_test"] + PORT)
