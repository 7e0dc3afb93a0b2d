"""``load_gptq_params`` of the port against the JAX package's on the CPU,
over AutoGPTQ-format checkpoint directories fabricated here: symmetric
(every zero point 8, the lossless ``Int4Weight`` route), asymmetric and
act-order (dequantized to dense), ``gptq_v2`` (zeros unshifted, named in
``quantize_config.json``), and a group size of 32 and of 128 (the W4
kernel's). ``Int4Weight`` words and scales are held exactly, dense weights
to 1e-6; embed, norms and lm_head bit-equal. On the card a symmetric
projection keeps its words only at 128-row groups; any other group loads
dequantized, with a warning. One decode step over the imported W4 base
takes the W4 kernel's route (its plain version on the CPU) and agrees
with the plain route."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_torch.models import quant_import as tqi
from bitdelta_torch.research.quantized_base import Int4Weight
from bitdelta_tpu.models import quant_import as jqi

PROJS = {"self_attn.q_proj": ("q_proj", "d", "q"),
         "self_attn.k_proj": ("k_proj", "d", "kv"),
         "self_attn.v_proj": ("v_proj", "d", "kv"),
         "self_attn.o_proj": ("o_proj", "q", "d"),
         "mlp.gate_proj": ("gate_proj", "d", "i"),
         "mlp.up_proj": ("up_proj", "d", "i"),
         "mlp.down_proj": ("down_proj", "i", "d")}


def fabricate(path, mode, group, hidden=128, inter=256, layers=2,
              vocab=160, seed=0):
    """A llama-family GPTQ checkpoint: ``mode`` is ``sym``, ``v2`` (sym in
    gptq_v2), ``asym``, ``actorder`` (sym zeros, a permuted ``g_idx``) or
    ``mixed`` (layer 1's down_proj asymmetric)."""
    from bitdelta_torch.core.artifact import write_safetensors

    rng = np.random.default_rng(seed)
    path.mkdir()
    heads, kv_heads = 4, 2
    dims = {"d": hidden, "q": hidden, "kv": hidden // heads * kv_heads,
            "i": inter}
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": vocab, "hidden_size": hidden,
        "intermediate_size": inter, "num_hidden_layers": layers,
        "num_attention_heads": heads, "num_key_value_heads": kv_heads,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 64,
        "tie_word_embeddings": False}))
    if mode == "v2":
        (path / "quantize_config.json").write_text(json.dumps(
            {"bits": 4, "group_size": group, "checkpoint_format": "gptq_v2"}))
    sym_word = np.uint32(0x88888888 if mode == "v2" else 0x77777777)
    f16 = lambda *s: (0.05 * rng.standard_normal(s)).astype(np.float16)
    t = {"model.embed_tokens.weight": f16(vocab, hidden),
         "model.norm.weight": 1 + f16(hidden),
         "lm_head.weight": f16(vocab, hidden)}
    for i in range(layers):
        t[f"model.layers.{i}.input_layernorm.weight"] = 1 + f16(hidden)
        t[f"model.layers.{i}.post_attention_layernorm.weight"] = (
            1 + f16(hidden))
        for sub, (_, kin, kout) in PROJS.items():
            k, n = dims[kin], dims[kout]
            g = k // group
            pre = f"model.layers.{i}.{sub}"
            t[f"{pre}.qweight"] = rng.integers(
                0, 2**32, (k // 8, n), dtype=np.uint64).astype(
                np.uint32).view(np.int32)
            asym = mode == "asym" or (mode == "mixed" and i == 1
                                      and sub == "mlp.down_proj")
            zeros = (rng.integers(0, 2**32, (g, n // 8), dtype=np.uint64)
                     .astype(np.uint32) if asym
                     else np.full((g, n // 8), sym_word, np.uint32))
            t[f"{pre}.qzeros"] = zeros.view(np.int32)
            t[f"{pre}.scales"] = (np.abs(f16(g, n)) + np.float16(0.01))
            if mode == "actorder":
                t[f"{pre}.g_idx"] = rng.permutation(
                    np.arange(k) // group).astype(np.int32)
            else:
                t[f"{pre}.g_idx"] = (np.arange(k) // group).astype(np.int32)
    write_safetensors(str(path / "model.safetensors"), t, {"format": "pt"})
    return str(path)


def _assert_import_matches(got, want):
    np.testing.assert_array_equal(got["embed"].numpy(),
                                  np.asarray(want["embed"]))
    np.testing.assert_array_equal(got["lm_head"].numpy(),
                                  np.asarray(want["lm_head"]))
    np.testing.assert_array_equal(got["final_norm"].numpy(),
                                  np.asarray(want["final_norm"]))
    for name, w in want["layers"].items():
        g = got["layers"][name]
        if type(w).__name__ == "Int4Weight":
            assert isinstance(g, Int4Weight), name
            np.testing.assert_array_equal(g.packed.numpy(),
                                          np.asarray(w.packed), err_msg=name)
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale), err_msg=name)
        else:
            assert isinstance(g, torch.Tensor), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("group", (32, 128))
@pytest.mark.parametrize("mode", ("sym", "v2", "asym", "actorder", "mixed"))
def test_load_gptq_params_matches_jax(tmp_path, mode, group):
    path = fabricate(tmp_path / "gptq", mode, group)
    jcfg, want = jqi.load_gptq_params(path, dtype=jnp.float32)
    tcfg, got = tqi.load_gptq_params(path, dtype=torch.float32,
                                     device="cpu")
    assert tcfg.num_layers == jcfg.num_layers == 2
    _assert_import_matches(got, want)
    kinds = {n: type(w).__name__ for n, w in got["layers"].items()
             if n.endswith("_proj")}
    if mode in ("sym", "v2"):
        assert set(kinds.values()) == {"Int4Weight"}
    elif mode == "asym":
        assert set(kinds.values()) == {"Tensor"}
    else:
        # mixed: one asymmetric layer makes its projection dense;
        # act-order: a permuted g_idx over two or more groups does.
        assert kinds["down_proj"] == "Tensor"
        if mode == "mixed" or group == 32:
            assert kinds["q_proj"] == ("Int4Weight" if mode == "mixed"
                                       else "Tensor")


@pytest.mark.parametrize("group", (32, 64, 128))
def test_gptq_w4_native_rule(group):
    k = 256
    assert tqi._w4_native(k, k // group, torch.device("cpu"))
    assert (tqi._w4_native(k, k // group, torch.device("cuda"))
            == (group == 128))


def test_load_gptq_params_group32_on_card_rule_is_dense(tmp_path,
                                                        monkeypatch):
    """The card's rule (only 128-row groups stay ``Int4Weight``) applied
    to a CPU load: a symmetric group-32 checkpoint loads every projection
    dense, equal to JAX's dequantized import, and the loader warns naming
    them; at group 128 the same rule keeps ``Int4Weight``."""
    real = tqi._w4_native
    monkeypatch.setattr(tqi, "_w4_native", lambda k, g, device: real(
        k, g, torch.device("cuda")))
    path = fabricate(tmp_path / "g32", "sym", 32)
    _, want = jqi.load_gptq_params(path, dtype=jnp.float32, native=False)
    with pytest.warns(UserWarning, match="128-row groups") as rec:
        _, got = tqi.load_gptq_params(path, dtype=torch.float32,
                                      device="cpu")
    _assert_import_matches(got, want)
    assert all(isinstance(w, torch.Tensor) for w in got["layers"].values())
    assert "q_proj" in str(rec[0].message)
    path = fabricate(tmp_path / "g128", "sym", 128)
    _, got = tqi.load_gptq_params(path, dtype=torch.float32, device="cpu")
    assert all(isinstance(w, Int4Weight) for n, w in got["layers"].items()
               if n.endswith("_proj"))


def test_load_gptq_params_native_false_is_dense(tmp_path):
    path = fabricate(tmp_path / "gptq", "sym", 128)
    _, want = jqi.load_gptq_params(path, dtype=jnp.float32, native=False)
    _, got = tqi.load_gptq_params(path, dtype=torch.float32, native=False,
                                  device="cpu")
    _assert_import_matches(got, want)
    assert all(isinstance(w, torch.Tensor) for w in got["layers"].values())


def test_load_gptq_params_refuses_unknown_format(tmp_path):
    path = fabricate(tmp_path / "gptq", "sym", 128)
    (tmp_path / "gptq" / "quantize_config.json").write_text(
        json.dumps({"checkpoint_format": "marlin"}))
    with pytest.raises(ValueError, match="checkpoint_format"):
        jqi.load_gptq_params(path)
    with pytest.raises(ValueError, match="checkpoint_format"):
        tqi.load_gptq_params(path, device="cpu")


def test_gptq_import_decode_step_takes_the_w4_route(tmp_path, monkeypatch):
    """A symmetric group-128 import under a tenant's deltas: a B=8 decode
    step under ``kernel="cuda"`` calls the W4 matmul's wrapper at every
    projection of every layer (its plain version on these CPU tensors, as
    the JAX gate routes a decode-shaped base matmul beside a tenant delta)
    and agrees with the plain route within 1e-3 of the logit scale (the
    kernel route's tenant delta, row 7, puts x on a 14-bit grid); group 32
    keeps ``int4_matmul``."""
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models import llama
    from bitdelta_torch.ops import int4
    from bitdelta_torch.serving.stacking import stack_tenants

    for group, want_calls in ((128, 14), (32, 0)):
        path = fabricate(tmp_path / f"g{group}", "sym", group)
        cfg, params = tqi.load_gptq_params(path, dtype=torch.float32,
                                           device="cpu")
        _, dense = tqi.load_gptq_params(path, dtype=torch.float32,
                                        native=False, device="cpu")
        gen = torch.Generator().manual_seed(0)
        fine = dict(dense, layers={
            n: w + 0.01 * torch.randn(w.shape, generator=gen)
            if n.endswith("_proj") else w
            for n, w in dense["layers"].items()})
        stack = stack_tenants(cfg, params, [compress_model(dense, fine)],
                              device="cpu")
        calls = []
        real = int4.w4_matmul
        monkeypatch.setattr(llama, "w4_matmul",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        tokens = torch.arange(1, 9)[:, None]
        logits = {}
        for kernel in ("torch", "cuda"):
            cache = llama.init_cache(cfg, 8, 16, torch.float32, "cpu")
            logits[kernel], _ = llama.decode_step(
                cfg, stack.params, tokens, cache, deltas=stack.deltas,
                tenant_ids=torch.zeros(8, dtype=torch.int64),
                compute_dtype=torch.float32, kernel=kernel)
        assert len(calls) == want_calls
        assert torch.isfinite(logits["cuda"]).all()
        scale = logits["torch"].abs().max()
        assert (logits["cuda"] - logits["torch"]).abs().max() <= 1e-3 * scale
