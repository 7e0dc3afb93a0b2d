"""PyTorch port: the package root's public names, and the small public
names of ported modules, against the JAX package on the CPU.

* The root resolves every public name ``import bitdelta_tpu`` resolves,
  eager or lazy, and ``import bitdelta_torch`` imports no torch module
  until a name is used.
* ``pack_signs_np`` is bit-exact with JAX's and with the port's
  ``pack_signs``; the canonical configs equal JAX's field by field;
  ``param_count`` equals JAX's element count (exact integers);
  ``params_from_torch_mixtral`` is bit-exact with JAX's converter.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitdelta_torch
from bitdelta_torch.convert import params_from_numpy, to_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent

# Every public name of JAX's package root: eager (its imports) and lazy
# (its ``__getattr__`` branches). Held against JAX's module below.
JAX_ROOT_NAMES = (
    # eager
    "BinaryDelta", "apply_delta", "delta_linear", "dequantize_delta",
    "quantize_delta", "pack_signs", "unpack_signs", "unpack_to_pm1",
    "binary_bmm", "binary_matmul", "tenant_binary_matmul",
    "CompressedModel", "compress_model", "fuse_compressed",
    "student_params", "load_delta", "save_delta",
    # lazy
    "Engine", "EngineFullError", "Request", "stack_tenants",
    "distill_scales", "eval_ppl", "quantize_kv", "dequantize_kv",
    "Int4Weight", "Int8Weight", "quantize_base", "roundtrip_base",
    "ColumnScaleDelta", "LoRADelta", "TernaryDelta", "fuse_variant_model",
    "load_gptq_params", "int4_from_gptq", "int8_from_bnb",
    "dequantize_gptq",
)


def _jax_lazy_names():
    """The string names JAX's ``__getattr__`` compares ``name`` with."""
    tree = ast.parse((REPO / "bitdelta_tpu" / "__init__.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "__getattr__")
    names = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Compare) and isinstance(node.left, ast.Name)
                and node.left.id == "name"):
            for comp in node.comparators:
                for leaf in ast.walk(comp):
                    if (isinstance(leaf, ast.Constant)
                            and isinstance(leaf.value, str)):
                        names.add(leaf.value)
    return names


def _jax_eager_names():
    import bitdelta_tpu

    return {n for n in dir(bitdelta_tpu) if not n.startswith("_")
            and not isinstance(getattr(bitdelta_tpu, n), types.ModuleType)}


def test_name_table_is_jax_root():
    assert len(set(JAX_ROOT_NAMES)) == len(JAX_ROOT_NAMES)
    assert set(JAX_ROOT_NAMES) == _jax_eager_names() | _jax_lazy_names()


@pytest.mark.parametrize("name", JAX_ROOT_NAMES)
def test_port_root_resolves_jax_name(name):
    obj = getattr(bitdelta_torch, name)
    assert obj is not None
    assert obj.__module__.startswith("bitdelta_torch."), obj.__module__


def test_jax_public_api_surface_list_on_port():
    """The names JAX's own tests/test_utils.py::test_public_api_surface
    requires, read from that test, resolved on the port's root."""
    tree = ast.parse((REPO / "tests" / "test_utils.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "test_public_api_surface")
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For))
    names = [e.value for e in loop.iter.elts]
    assert "compress_model" in names and "save_delta" in names
    for name in names:
        assert getattr(bitdelta_torch, name) is not None, name


def test_unknown_root_name_raises():
    with pytest.raises(AttributeError):
        bitdelta_torch.no_such_name


def test_root_import_stays_light():
    code = ("import sys, bitdelta_torch as bd; "
            "assert 'torch' not in sys.modules, 'torch at import'; "
            "bd.compress_model; assert 'torch' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


# ---------------------------------------------------------------------------
# pack_signs_np
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 96), (64, 33), (3, 32, 7),
                                   (2, 2, 96, 5)])
def test_pack_signs_np_bit_exact(shape):
    from bitdelta_tpu.ops import packing as jp
    from bitdelta_torch.ops import packing as tp

    signs = np.random.default_rng(len(shape)).integers(
        0, 2, size=shape).astype(bool)
    got = tp.pack_signs_np(signs)
    assert got.dtype == np.int32 and got.shape == shape[:-2] + (
        shape[-2] // 32, shape[-1])
    np.testing.assert_array_equal(got, jp.pack_signs_np(signs))
    np.testing.assert_array_equal(got, tp.pack_signs(
        torch.from_numpy(signs)).numpy())


# ---------------------------------------------------------------------------
# Canonical configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama2_7b", "llama2_13b", "llama2_70b",
                                  "tinyllama_1_1b", "mistral_7b"])
def test_canonical_config_matches_jax(name):
    from bitdelta_tpu.models import config as jc
    from bitdelta_torch.models import config as tc

    assert (dataclasses.asdict(getattr(tc, name)())
            == dataclasses.asdict(getattr(jc, name)()))


# ---------------------------------------------------------------------------
# param_count
# ---------------------------------------------------------------------------

def _llama_pair(**over):
    from bitdelta_tpu.models import config as jc
    from bitdelta_tpu.models import llama as jl

    cfg = jc.tiny_test_config(hidden_size=128, intermediate_size=256,
                              **over)
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, jparams


@pytest.mark.parametrize("kind", ["dense", "tied", "int8", "int4"])
def test_param_count_matches_jax(kind):
    from bitdelta_tpu.models import llama as jl
    from bitdelta_tpu.research import quantized_base as jq
    from bitdelta_torch.models import llama as tl
    from bitdelta_torch.research import quantized_base as tq

    cfg, jparams = _llama_pair(tie_word_embeddings=kind == "tied")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    if kind in ("int8", "int4"):
        jparams = jq.quantize_base(jparams, kind)
        tparams = tq.quantize_base(tparams, kind)
        carried = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        assert tl.param_count(carried) == jl.param_count(jparams)
    assert tl.param_count(tparams) == jl.param_count(jparams)


def test_param_count_mixtral_matches_jax():
    from bitdelta_tpu.models import llama as jl
    from bitdelta_tpu.models import mixtral as jmx
    from bitdelta_torch.models import llama as tl

    cfg = jmx.MixtralConfig(vocab_size=128, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2,
                            num_kv_heads=1, max_seq_len=32, num_experts=4,
                            experts_per_token=2)
    jparams = jmx.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert tl.param_count(tparams) == jl.param_count(jparams)


# ---------------------------------------------------------------------------
# params_from_torch_mixtral
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def hf_mixtral(request):
    from transformers import MixtralConfig as HFConfig, MixtralForCausalLM

    torch.manual_seed(0)
    hf_cfg = HFConfig(vocab_size=96, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, num_local_experts=4,
                      num_experts_per_tok=2, max_position_embeddings=64,
                      rms_norm_eps=1e-6, tie_word_embeddings=request.param,
                      attn_implementation="eager")
    return hf_cfg, MixtralForCausalLM(hf_cfg).eval().float()


def test_params_from_torch_mixtral_bit_exact(hf_mixtral):
    from bitdelta_tpu.models import mixtral as jmx
    from bitdelta_torch.models import mixtral as tmx

    hf_cfg, model = hf_mixtral
    want = jax.tree.map(np.asarray, jmx.params_from_torch_mixtral(
        jmx.MixtralConfig.from_hf_config(hf_cfg), model, jnp.float32))
    cfg = tmx.MixtralConfig.from_hf_config(hf_cfg)
    got = to_numpy(tmx.params_from_torch_mixtral(cfg, model, device="cpu"))
    assert sorted(got) == sorted(want)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name in want:
        if name != "layers":
            np.testing.assert_array_equal(got[name], want[name], name)
    for name in want["layers"]:
        assert got["layers"][name].dtype == np.float32
        np.testing.assert_array_equal(got["layers"][name],
                                      want["layers"][name], name)
    # bf16 params: JAX's cast of the same fp32 values, bit for bit.
    want16 = jmx.params_from_torch_mixtral(
        jmx.MixtralConfig.from_hf_config(hf_cfg), model, jnp.bfloat16)
    got16 = tmx.params_from_torch_mixtral(cfg, model, torch.bfloat16,
                                          device="cpu")
    assert got16["layers"]["w2"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(got16["layers"]["w2"]),
                                  np.asarray(want16["layers"]["w2"],
                                             np.float32))


def test_params_from_torch_mixtral_defaults_to_the_card(hf_mixtral):
    from bitdelta_torch.models import mixtral as tmx

    hf_cfg, model = hf_mixtral
    cfg = tmx.MixtralConfig.from_hf_config(hf_cfg)
    if torch.cuda.is_available():
        assert tmx.params_from_torch_mixtral(cfg, model)["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmx.params_from_torch_mixtral(cfg, model)
