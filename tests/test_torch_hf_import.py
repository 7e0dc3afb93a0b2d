"""The port's checkpoint import against the JAX package on the CPU:
``ModelConfig.from_hf_config`` / ``MixtralConfig.from_hf_config``,
``load_hf_params`` over checkpoints written locally with transformers'
``save_pretrained`` (Llama untied and tied, Qwen2 with its biases,
Mixtral, a checkpoint of several shards; stored fp32 or bf16, loaded as
fp32 or bf16), ``resolve_model_module``, the tokenizer fallback and the
byte tokenizer's call.

Tolerance: none. Every config field is equal and every loaded tensor is
bit-equal to JAX's (bf16 compared as its bit pattern).
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitdelta_torch.models import hf_import as thf
from bitdelta_torch.models.config import ModelConfig as TModelConfig
from bitdelta_torch.models.mixtral import MixtralConfig as TMixtralConfig
from bitdelta_tpu.models import hf_import as jhf
from bitdelta_tpu.models.config import ModelConfig as JModelConfig
from bitdelta_tpu.models.mixtral import MixtralConfig as JMixtralConfig

SMALL = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64,
             rms_norm_eps=1e-6)


def _hf_config(kind):
    import transformers as tr

    if kind == "llama":
        return tr.LlamaConfig(**SMALL, tie_word_embeddings=False)
    if kind == "llama_tied":
        return tr.LlamaConfig(**SMALL, tie_word_embeddings=True)
    if kind == "mistral_window":
        return tr.MistralConfig(**SMALL, sliding_window=16,
                                tie_word_embeddings=False)
    if kind == "qwen2":
        return tr.Qwen2Config(**SMALL, tie_word_embeddings=False)
    if kind == "llama3_rope":
        return tr.LlamaConfig(**SMALL, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 32})
    if kind == "linear_rope":
        return tr.LlamaConfig(**SMALL, rope_scaling={"type": "linear",
                                                     "factor": 2.0})
    if kind == "mixtral":
        return tr.MixtralConfig(**SMALL, num_local_experts=4,
                                num_experts_per_tok=2,
                                tie_word_embeddings=False)
    raise ValueError(kind)


CONFIG_KINDS = ("llama", "llama_tied", "mistral_window", "qwen2",
                "llama3_rope", "linear_rope", "mixtral")


@pytest.mark.parametrize("kind", CONFIG_KINDS)
def test_from_hf_config_matches_jax(kind):
    hf = _hf_config(kind)
    if kind == "mixtral":
        got = TMixtralConfig.from_hf_config(hf)
        want = JMixtralConfig.from_hf_config(hf)
        # RopeScaling stays a dataclass through the shallow field copy.
        assert got.rope_scaling is None or dataclasses.is_dataclass(
            got.rope_scaling)
    else:
        got = TModelConfig.from_hf_config(hf)
        want = JModelConfig.from_hf_config(hf)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if kind == "qwen2":
        assert got.attention_bias
    if kind == "mistral_window":
        assert got.sliding_window == 16
    if kind == "llama_tied":
        assert got.tie_word_embeddings


@pytest.mark.parametrize("rtype", ("yarn", "dynamic"))
def test_from_hf_config_refuses_unknown_rope_type(rtype):
    class Raw:
        pass

    hf = Raw()
    hf.__dict__.update(SMALL)
    hf.rope_scaling = {"rope_type": rtype, "factor": 2.0}
    with pytest.raises(ValueError, match="rope_scaling"):
        JModelConfig.from_hf_config(hf)
    with pytest.raises(ValueError, match="rope_scaling"):
        TModelConfig.from_hf_config(hf)


def _model_class(kind):
    import transformers as tr

    return {"llama": tr.LlamaForCausalLM, "llama_tied": tr.LlamaForCausalLM,
            "qwen2": tr.Qwen2ForCausalLM,
            "mixtral": tr.MixtralForCausalLM,
            "sharded": tr.LlamaForCausalLM}[kind]


def write_checkpoint(path, kind, ckpt_dtype, seed=0):
    """A tiny random HF checkpoint of ``kind`` stored in ``ckpt_dtype``."""
    torch.manual_seed(seed)
    hf = _hf_config("llama" if kind == "sharded" else kind)
    model = _model_class(kind)(hf).eval()
    with torch.no_grad():
        for p in model.parameters():      # norms away from 1, biases set
            p.add_(0.05 * torch.randn_like(p))
    model = model.to(ckpt_dtype)
    shard = "8KB" if kind == "sharded" else "5GB"
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size=shard)
    return str(path)


def _bits(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def assert_params_bit_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if key == "layers":
            assert set(got["layers"]) == set(want["layers"])
            for name in want["layers"]:
                g, w = got["layers"][name], want["layers"][name]
                assert tuple(g.shape) == tuple(w.shape), name
                np.testing.assert_array_equal(_torch_bits(g), _bits(w),
                                              err_msg=name)
        else:
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            np.testing.assert_array_equal(_torch_bits(got[key]),
                                          _bits(want[key]), err_msg=key)


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("ckpt_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("llama", "llama_tied", "qwen2", "mixtral",
                                  "sharded"))
def test_load_hf_params_bit_equal_to_jax(tmp_path, kind, ckpt_dtype):
    path = write_checkpoint(tmp_path / kind, kind, DTYPES[ckpt_dtype][0])
    if kind == "sharded":
        shards = [p for p in (tmp_path / kind).iterdir()
                  if p.name.endswith(".safetensors")]
        assert len(shards) > 1
    for load_dtype in ("float32", "bfloat16"):
        tdt, jdt = DTYPES[load_dtype]
        jcfg, want = jhf.load_hf_params(path, dtype=jdt)
        tcfg, got = thf.load_hf_params(path, dtype=tdt, device="cpu")
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert_params_bit_equal(got, want)
        assert ("lm_head" in got) == (kind != "llama_tied")
        if kind == "qwen2":
            assert {"q_bias", "k_bias", "v_bias"} <= set(got["layers"])


def test_load_hf_params_without_safetensors_or_transformers(tmp_path,
                                                             monkeypatch):
    """As on a machine that has neither package: the port's reader and
    importer need neither."""
    path = write_checkpoint(tmp_path / "ck", "llama", torch.bfloat16)
    _, want = jhf.load_hf_params(path, dtype=jnp.bfloat16)
    for mod in [m for m in sys.modules
                if m.split(".")[0] in ("safetensors", "transformers")]:
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    _, got = thf.load_hf_params(path, dtype=torch.bfloat16, device="cpu")
    assert_params_bit_equal(got, want)


def test_missing_layer_tensor_raises_in_both(tmp_path):
    from bitdelta_torch.core.artifact import iter_safetensors, \
        write_safetensors

    path = write_checkpoint(tmp_path / "ck", "llama", torch.float32)
    ck = tmp_path / "ck"
    tensors = {k: v.clone() for k, v in iter_safetensors(
        str(ck / "model.safetensors"))}
    del tensors["model.layers.1.mlp.down_proj.weight"]
    write_safetensors(str(ck / "model.safetensors"), tensors,
                      {"format": "pt"})
    with pytest.raises(ValueError, match="down_proj"):
        jhf.load_hf_params(path, dtype=jnp.float32)
    with pytest.raises(ValueError, match="down_proj"):
        thf.load_hf_params(path, dtype=torch.float32, device="cpu")


def test_unknown_layer_tensor_raises_in_both(tmp_path):
    cfg = TModelConfig.from_hf_config(_hf_config("llama"))
    jcfg = JModelConfig.from_hf_config(_hf_config("llama"))
    sd = {"model.layers.0.mlp.extra_proj.weight": np.zeros((4, 4),
                                                          np.float32)}
    with pytest.raises(ValueError, match="unrecognized"):
        jhf.params_from_state_dict(jcfg, sd, jnp.float32)
    with pytest.raises(ValueError, match="unrecognized"):
        thf.params_from_state_dict(cfg, sd, torch.float32, device="cpu")


def test_params_from_torch_model_matches_jax():
    import transformers as tr

    torch.manual_seed(3)
    model = tr.LlamaForCausalLM(_hf_config("llama")).eval()
    tcfg = TModelConfig.from_hf_config(model.config)
    jcfg = JModelConfig.from_hf_config(model.config)
    got = thf.params_from_torch_model(tcfg, model, device="cpu")
    want = jhf.params_from_torch_model(jcfg, model)
    assert_params_bit_equal(got, want)


def test_load_hf_params_on_missing_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = write_checkpoint(tmp_path / "ck", "llama", torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thf.load_hf_params(path)


def test_safetensors_reader_round_trips_every_dtype(tmp_path):
    from bitdelta_torch.core.artifact import (iter_safetensors,
                                              read_safetensors,
                                              write_safetensors)

    rng = np.random.default_rng(0)
    tensors = {
        "bf16": torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)).to(torch.bfloat16),
        "f32": rng.standard_normal((7,)).astype(np.float32),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "i32": rng.integers(-9, 9, (4, 3)).astype(np.int32),
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "scalar": np.asarray(np.float32(2.5)),
    }
    path = str(tmp_path / "t.safetensors")
    write_safetensors(path, tensors, {"k": "v"})
    got = dict(iter_safetensors(path))
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"], tensors["bf16"])
    for name in ("f32", "f16", "i32", "u8", "scalar"):
        np.testing.assert_array_equal(got[name].numpy(), tensors[name])
        assert got[name].shape == tensors[name].shape
    # The whole-file reader of the artifacts is unchanged for them.
    no_bf16 = {k: v for k, v in tensors.items() if k != "bf16"}
    write_safetensors(path, no_bf16, {"k": "v"})
    raw, meta = read_safetensors(path)
    assert meta == {"k": "v"}
    for name, arr in no_bf16.items():
        np.testing.assert_array_equal(raw[name], arr)
    # safetensors itself reads the port's BF16 as bf16.
    from safetensors.torch import load_file

    write_safetensors(path, {"bf16": tensors["bf16"]})
    assert torch.equal(load_file(path)["bf16"], tensors["bf16"])


@pytest.mark.parametrize("kind", ("llama", "mixtral"))
def test_resolve_model_module(kind):
    from bitdelta_torch.models import llama, mixtral, resolve_model_module

    cfg = (TMixtralConfig if kind == "mixtral" else TModelConfig
           ).from_hf_config(_hf_config(kind))
    assert resolve_model_module(cfg) is (mixtral if kind == "mixtral"
                                         else llama)


def test_byte_tokenizer_call_matches_jax():
    """``tokenize_corpus`` with the byte-level fallback (the tokenizer on
    a machine without transformers): the port's ``ByteTokenizer`` had no
    ``__call__`` and raised TypeError."""
    from bitdelta_torch.eval.ppl import tokenize_corpus as t_tok
    from bitdelta_torch.serving.server import ByteTokenizer as TByte
    from bitdelta_tpu.eval.ppl import tokenize_corpus as j_tok
    from bitdelta_tpu.serving.server import ByteTokenizer as JByte

    got = t_tok(TByte(), ["ab"])
    want = j_tok(JByte(), ["ab"])
    assert list(got) == list(want) == [98, 99, 11, 11]
    texts = ["ab", "", "héllo"]
    assert TByte()(texts) == JByte()(texts)
    assert TByte()("héllo", padding="max_length") == JByte()("héllo")


def test_get_tokenizer_falls_back_offline(tmp_path, capsys):
    from bitdelta_torch.serving.server import ByteTokenizer
    from bitdelta_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer(str(tmp_path))
    assert isinstance(tok, ByteTokenizer)
    assert "bitdelta_torch" in capsys.readouterr().out
    with pytest.raises(Exception):
        get_tokenizer(str(tmp_path), allow_fallback=False)


def test_config_json_round_trip(tmp_path):
    """``load_hf_config`` reads ``config.json`` alone, as JAX's does."""
    for kind in ("mistral_window", "mixtral"):
        d = tmp_path / kind
        d.mkdir()
        _hf_config(kind).to_json_file(str(d / "config.json"))
        got = thf.load_hf_config(str(d))
        want = jhf.load_hf_config(str(d))
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert json.loads((d / "config.json").read_text())["model_type"]


@pytest.mark.parametrize("ckpt_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("mistral_window", "mixtral"))
def test_export_writes_the_import_names(tmp_path, kind, ckpt_dtype):
    """``core/export.py``'s ``hf_state_dict`` / ``hf_config_dict`` (as
    ``chip_smoke.py`` writes its Mistral and Mixtral checkpoints) give back
    an HF checkpoint's tensor names, and JAX's importer reads the result
    bit-equal to the params and to the same config."""
    from bitdelta_torch.core.artifact import iter_safetensors, \
        write_safetensors
    from bitdelta_torch.core.export import hf_config_dict, hf_state_dict

    tdt, jdt = DTYPES[ckpt_dtype]
    src = write_checkpoint(tmp_path / "src", "mixtral" if kind == "mixtral"
                           else "llama", tdt)
    cfg, params = thf.load_hf_params(src, dtype=tdt, device="cpu")
    if kind == "mistral_window":
        cfg = dataclasses.replace(cfg, sliding_window=16)
    out = tmp_path / "out"
    out.mkdir()
    sd = hf_state_dict(cfg, params, dtype=tdt)
    assert {t.dtype for t in sd.values()} == {tdt}
    write_safetensors(str(out / "model.safetensors"), sd)
    (out / "config.json").write_text(json.dumps(hf_config_dict(cfg,
                                                               dtype=tdt)))
    src_names = {name for f in sorted((tmp_path / "src").glob(
        "*.safetensors")) for name, _ in iter_safetensors(str(f))}
    assert set(sd) == src_names
    conf = json.loads((out / "config.json").read_text())
    assert conf["torch_dtype"] == ckpt_dtype
    assert conf["model_type"] == ("mixtral" if kind == "mixtral"
                                  else "mistral")
    assert thf.load_hf_config(str(out)) == cfg
    jcfg, want = jhf.load_hf_params(str(out), dtype=jdt)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert_params_bit_equal(params, want)
