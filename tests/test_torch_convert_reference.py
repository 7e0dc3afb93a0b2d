"""PyTorch port: the reference-artifact converter
(``tools/convert_reference.py``) against the JAX package on the CPU.

The reference-format dict is built as tests/test_convert_reference.py
builds it (torch and transformers: the reference's ``save_diff``
semantics). Tolerances: the converted CompressedModel is bit-exact with
JAX's converter on the same dict; against ``compress_model`` on the same
weights the packed words are bit-exact and the scales within 1e-5
relative (the reference's ``coeff`` is a mean over the transposed
matrix, summed in another order); artifacts cross between the packages
bit-exact; greedy tokens are equal.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.core import artifact as jart
from bitdelta_tpu.tools import convert_reference as jconv
from bitdelta_torch.convert import params_from_numpy, to_numpy
from bitdelta_torch.core import artifact as tart
from bitdelta_torch.tools import convert_reference as tconv

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_convert_reference import _reference_save_dict  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def world():
    import copy

    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(3)
    cfg = LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64,
                      rms_norm_eps=1e-6, tie_word_embeddings=False)
    base = LlamaForCausalLM(cfg).eval()
    fine = copy.deepcopy(base)
    with torch.no_grad():
        for name, p in fine.named_parameters():
            if "proj" in name:
                p.add_(0.03 * torch.randn_like(p))
    return cfg, base, fine, _reference_save_dict(base, fine, cfg)


def _same_compressed(got, want):
    """A port CompressedModel against a JAX one, bit for bit."""
    want = jax.tree.map(np.asarray, want)
    assert sorted(got.deltas) == sorted(want.deltas)
    for name, d in want.deltas.items():
        assert got.deltas[name].packed.dtype == torch.int32
        np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                      d.packed, err_msg=name)
        np.testing.assert_array_equal(got.deltas[name].scale.numpy(),
                                      d.scale, err_msg=name)
    assert sorted(got.extras) == sorted(want.extras)
    for name, x in want.extras.items():
        np.testing.assert_array_equal(to_numpy(got.extras[name]),
                                      np.asarray(x, np.float32),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_bit_exact_against_jax(world, dtype):
    ref = world[3]
    got = tconv.reference_dict_to_compressed(
        ref, dtype=getattr(torch, dtype), device="cpu")
    assert got.extras["embed"].dtype == getattr(torch, dtype)
    _same_compressed(got, jconv.reference_dict_to_compressed(
        ref, dtype=getattr(jnp, dtype)))


def test_converter_takes_numpy_arrays(world):
    ref = world[3]
    as_np = {k: v.detach().numpy() for k, v in ref.items()}
    got = tconv.reference_dict_to_compressed(as_np, dtype=torch.float32,
                                             device="cpu")
    _same_compressed(got, jconv.reference_dict_to_compressed(
        ref, dtype=jnp.float32))


def test_converter_against_compress_model(world):
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models.config import ModelConfig
    from bitdelta_torch.models.hf_import import params_from_torch_model

    hf_cfg, base_t, fine_t, ref = world
    cfg = ModelConfig.from_hf_config(hf_cfg)
    base = params_from_torch_model(cfg, base_t, device="cpu")
    fine = params_from_torch_model(cfg, fine_t, device="cpu")
    ours = compress_model(base, fine)
    conv = tconv.reference_dict_to_compressed(ref, dtype=torch.float32,
                                              device="cpu")
    for name, d in ours.deltas.items():
        assert torch.equal(conv.deltas[name].packed, d.packed), name
        np.testing.assert_allclose(conv.deltas[name].scale.numpy(),
                                   d.scale.numpy(), rtol=1e-5, err_msg=name)
    for name in ("embed", "final_norm", "attn_norm", "mlp_norm", "lm_head"):
        assert torch.equal(conv.extras[name], ours.extras[name]), name


def test_port_artifact_loads_bit_exact_in_jax(world, tmp_path):
    ref = world[3]
    pt = tmp_path / "diff.pt"
    torch.save(ref, pt)
    ours, theirs = tmp_path / "port.safetensors", tmp_path / "jax.safetensors"
    tconv.convert(str(pt), str(ours), device="cpu")
    jconv.convert(str(pt), str(theirs))
    got, _ = jart.load_delta(str(ours))
    want, _ = jart.load_delta(str(theirs))
    for name in want.deltas:
        np.testing.assert_array_equal(np.asarray(got.deltas[name].packed),
                                      np.asarray(want.deltas[name].packed))
        np.testing.assert_array_equal(np.asarray(got.deltas[name].scale),
                                      np.asarray(want.deltas[name].scale))
    for name, x in want.extras.items():
        assert got.extras[name].dtype == x.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(got.extras[name]),
                                      np.asarray(x))


def test_jax_artifact_loads_bit_exact_in_port(world, tmp_path):
    ref = world[3]
    pt = tmp_path / "diff.pt"
    torch.save(ref, pt)
    out = tmp_path / "jax.safetensors"
    jconv.convert(str(pt), str(out))
    got, _ = tart.load_delta(str(out), device="cpu")
    _same_compressed(got, jconv.reference_dict_to_compressed(ref))


def test_module_entry_writes_a_jax_readable_file(world, tmp_path):
    ref = world[3]
    pt = tmp_path / "diff.pt"
    torch.save(ref, pt)
    out = tmp_path / "out.safetensors"
    proc = subprocess.run(
        [sys.executable, "-m", "bitdelta_torch.tools.convert_reference",
         str(pt), str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, check=True)
    assert f"wrote {out}" in proc.stdout
    got, _ = jart.load_delta(str(out))
    want = jconv.reference_dict_to_compressed(ref)
    for name in want.deltas:
        np.testing.assert_array_equal(np.asarray(got.deltas[name].packed),
                                      np.asarray(want.deltas[name].packed))
        np.testing.assert_array_equal(np.asarray(got.deltas[name].scale),
                                      np.asarray(want.deltas[name].scale))
    for name, x in want.extras.items():
        np.testing.assert_array_equal(np.asarray(got.extras[name]),
                                      np.asarray(x))


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_converted_artifact_serves_jax_tokens(world, tmp_path, kernel):
    """The port's converted artifact served by the port's engine gives
    the greedy tokens of JAX's ``Engine(kernel="xla")`` on JAX's
    converted artifact (``"cuda"`` takes the kernels' plain versions
    here)."""
    from bitdelta_tpu.models.config import ModelConfig as JConfig
    from bitdelta_tpu.models.hf_import import params_from_torch_model as jp
    from bitdelta_tpu.serving.engine import Engine as JEngine
    from bitdelta_tpu.serving.engine import Request as JRequest
    from bitdelta_tpu.serving.stacking import stack_tenants as jstack
    from bitdelta_torch.models.config import ModelConfig
    from bitdelta_torch.serving.engine import Engine, Request
    from bitdelta_torch.serving.stacking import stack_tenants

    hf_cfg, base_t, _, ref = world
    pt = tmp_path / "diff.pt"
    torch.save(ref, pt)
    out = tmp_path / "diff.safetensors"
    tconv.convert(str(pt), str(out), device="cpu")
    prompts = ([1, 2, 3], [5, 9, 4, 4, 7], [11])

    jcfg = JConfig.from_hf_config(hf_cfg)
    jbase = jp(jcfg, base_t, jnp.float32)
    jcomp, _ = jart.load_delta(str(out))
    jcomp = jcomp._replace(extras={k: v.astype(jnp.float32)
                                   for k, v in jcomp.extras.items()})
    want = JEngine(jcfg, jstack(jcfg, jbase, [jcomp]), max_slots=3,
                   max_seq=32, prefill_buckets=(8,), kernel="xla",
                   compute_dtype=jnp.float32).generate(
        [JRequest(prompt_ids=list(p), tenant_id=0, max_new_tokens=6)
         for p in prompts])

    cfg = ModelConfig.from_hf_config(hf_cfg)
    base = params_from_numpy(jax.tree.map(np.asarray, jbase), "cpu")
    comp, _ = tart.load_delta(str(out), device="cpu")
    comp = comp._replace(extras={k: v.float()
                                 for k, v in comp.extras.items()})
    got = Engine(cfg, stack_tenants(cfg, base, [comp], device="cpu"),
                 max_slots=3, max_seq=32, prefill_buckets=(8,),
                 kernel=kernel, compute_dtype=torch.float32,
                 device="cpu").generate(
        [Request(prompt_ids=list(p), tenant_id=0, max_new_tokens=6)
         for p in prompts])
    assert [list(map(int, o)) for o in got] == [list(map(int, o))
                                                for o in want]


def test_converter_errors(world):
    ref = world[3]
    with pytest.raises(ValueError, match="unsupported artifact entry"):
        tconv.reference_dict_to_compressed({"something.weird": np.zeros(3)},
                                           device="cpu")
    bad = dict(ref)
    bad["model.layers.0.mlp.fancy_proj.mask"] = ref[
        "model.layers.0.mlp.up_proj.mask"]
    with pytest.raises(ValueError, match="unknown projection"):
        tconv.reference_dict_to_compressed(bad, device="cpu")
    short = {k: v for k, v in ref.items()
             if not k.startswith("model.layers.1.self_attn.k_proj")}
    with pytest.raises(ValueError, match="missing k_proj masks for layers"):
        tconv.reference_dict_to_compressed(short, device="cpu")
    bare = {k: v for k, v in ref.items() if k != "model.norm.weight"}
    with pytest.raises(ValueError, match="final_norm"):
        tconv.reference_dict_to_compressed(bare, device="cpu")
    # JAX raises the same three.
    for state in (bad, short, bare):
        with pytest.raises(ValueError):
            jconv.reference_dict_to_compressed(state)


def test_converter_defaults_to_the_card(world):
    ref = world[3]
    if torch.cuda.is_available():
        conv = tconv.reference_dict_to_compressed(ref)
        assert conv.deltas["q_proj"].packed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tconv.reference_dict_to_compressed(ref)
