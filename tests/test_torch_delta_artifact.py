"""PyTorch port: delta quantization, whole-model compression and the
safetensors artifact against the JAX package.

Packed words are compared bit-exact; scales to rtol 1e-6 (both packages
take an fp32 mean, summed in different orders). Artifacts cross both
ways: a file written by either package loads bit-exact in the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.core import artifact as jart
from bitdelta_tpu.core import compress as jcomp
from bitdelta_tpu.core import delta as jdelta
from bitdelta_tpu.models import config as jcfg
from bitdelta_tpu.models import llama as jl
from bitdelta_torch.convert import params_from_numpy
from bitdelta_torch.core import artifact as tart
from bitdelta_torch.core import compress as tcomp
from bitdelta_torch.core import delta as tdelta
from bitdelta_torch.models import config as tcfg

SCALE_RTOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


@pytest.mark.parametrize("zero_sign", ["positive", "balance"])
def test_quantize_delta_matches_jax(zero_sign):
    rng = np.random.default_rng(0)
    base = rng.standard_normal((2, 64, 256)).astype(np.float32)
    fine = base + 0.05 * rng.standard_normal(base.shape).astype(np.float32)
    fine[:, :8, :8] = base[:, :8, :8]          # exact zeros hit zero_sign
    want = jdelta.quantize_delta(jnp.asarray(base), jnp.asarray(fine),
                                 zero_sign=zero_sign)
    got = tdelta.quantize_delta(torch.from_numpy(base),
                                torch.from_numpy(fine), zero_sign=zero_sign)
    np.testing.assert_array_equal(got.packed.numpy(), np.array(want.packed))
    np.testing.assert_allclose(got.scale.numpy(), np.array(want.scale),
                               rtol=SCALE_RTOL)
    # The pair layout of the same delta.
    wp = jdelta.pair_delta(want)
    gp = tdelta.pair_delta(got)
    np.testing.assert_array_equal(gp.packed_pairs.numpy(),
                                  np.array(wp.packed_pairs))
    np.testing.assert_array_equal(gp.colsum.numpy(), np.array(wp.colsum))


def test_dequantize_and_delta_linear_match_jax():
    # The dense scale*sign matrix is exact; the compressed linear layer
    # sums in fp32 in another order (fp32 compute, 1e-5).
    rng = np.random.default_rng(4)
    base = rng.standard_normal((96, 128)).astype(np.float32)
    fine = base + 0.05 * rng.standard_normal(base.shape).astype(np.float32)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    jd = jdelta.quantize_delta(jnp.asarray(base), jnp.asarray(fine))
    td = tdelta.quantize_delta(torch.from_numpy(base), torch.from_numpy(fine))
    np.testing.assert_allclose(tdelta.dequantize_delta(td).numpy(),
                               np.array(jdelta.dequantize_delta(jd)),
                               rtol=SCALE_RTOL)
    want = np.array(jdelta.delta_linear(jnp.asarray(x), jnp.asarray(base), jd,
                                        compute_dtype=jnp.float32))
    got = tdelta.delta_linear(torch.from_numpy(x), torch.from_numpy(base), td,
                              compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _world(dtype):
    cfg = jcfg.tiny_test_config(vocab_size=64, hidden_size=64,
                                intermediate_size=256, num_layers=2)
    base = jl.init_params(cfg, jax.random.PRNGKey(0), dtype)
    fine = jax.tree.map(lambda x: x, base)
    fine["layers"] = dict(fine["layers"])
    key = jax.random.PRNGKey(1)
    for name in jl.PROJ_NAMES:
        key, sub = jax.random.split(key)
        w = base["layers"][name]
        fine["layers"][name] = (w.astype(jnp.float32) + 0.01 * jax.random.normal(
            sub, w.shape)).astype(dtype)
    fine["final_norm"] = fine["final_norm"] * 1.5
    return cfg, base, fine


def test_compress_model_matches_jax():
    _, base, fine = _world(jnp.float32)
    want = jcomp.compress_model(base, fine)
    got = tcomp.compress_model(params_from_numpy(_np_tree(base), "cpu"),
                               params_from_numpy(_np_tree(fine), "cpu"))
    assert sorted(got.deltas) == sorted(want.deltas)
    for name, d in want.deltas.items():
        np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                      np.array(d.packed))
        np.testing.assert_allclose(got.deltas[name].scale.numpy(),
                                   np.array(d.scale), rtol=SCALE_RTOL)
    assert sorted(got.extras) == sorted(want.extras)
    for name, x in want.extras.items():
        np.testing.assert_array_equal(got.extras[name].numpy(), np.array(x))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_artifact_written_by_jax_loads_in_port(tmp_path, dtype):
    cfg, base, fine = _world(dtype)
    comp = jcomp.compress_model(base, fine)
    path = str(tmp_path / "jax.safetensors")
    jart.save_delta(path, comp, cfg)
    got, got_cfg = tart.load_delta(path, device="cpu")
    assert got_cfg == tcfg.ModelConfig.from_dict(
        __import__("dataclasses").asdict(cfg))
    for name, d in comp.deltas.items():
        np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                      np.array(d.packed))
        np.testing.assert_array_equal(got.deltas[name].scale.numpy(),
                                      np.array(d.scale))
    for name, x in comp.extras.items():
        t = got.extras[name]
        if dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.array(x).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.array(x))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_artifact_written_by_port_loads_in_jax(tmp_path, dtype):
    cfg, base, fine = _world(dtype)
    comp = tcomp.compress_model(params_from_numpy(_np_tree(base), "cpu"),
                                params_from_numpy(_np_tree(fine), "cpu"))
    tcfg_ = tcfg.ModelConfig.from_dict(__import__("dataclasses").asdict(cfg))
    path = str(tmp_path / "torch.safetensors")
    tart.save_delta(path, comp, tcfg_)
    got, got_cfg = jart.load_delta(path)
    assert got_cfg == cfg
    for name, d in comp.deltas.items():
        np.testing.assert_array_equal(np.array(got.deltas[name].packed),
                                      d.packed.numpy())
        np.testing.assert_array_equal(np.array(got.deltas[name].scale),
                                      d.scale.numpy())
    for name, t in comp.extras.items():
        x = got.extras[name]
        if dtype == jnp.bfloat16:
            assert x.dtype == jnp.bfloat16
            np.testing.assert_array_equal(np.array(x).view(np.int16),
                                          t.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(np.array(x), t.numpy())


def test_safetensors_reader_matches_package(tmp_path):
    # The hand-written reader agrees with the safetensors package on a
    # file the package wrote (dtypes, shapes, metadata).
    from safetensors.numpy import save_file

    rng = np.random.default_rng(3)
    tensors = {"a": rng.integers(-2**31, 2**31 - 1, (3, 5), dtype=np.int32),
               "b": rng.standard_normal((7,)).astype(np.float32),
               "c": rng.integers(0, 2**16, (2, 2, 2), dtype=np.uint16)}
    path = str(tmp_path / "pkg.safetensors")
    save_file(tensors, path, metadata={"k": "v"})
    got, meta = tart.read_safetensors(path)
    assert meta == {"k": "v"}
    for name, arr in tensors.items():
        np.testing.assert_array_equal(got[name], arr)
        assert got[name].dtype == arr.dtype
