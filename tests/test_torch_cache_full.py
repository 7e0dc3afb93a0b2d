"""PyTorch port: KV-cache writes past the cache's last slot, against the
JAX package.

JAX's ``.at[rows, idx].set`` drops a write whose slot is out of range:
a decode step on a full cache leaves the cache as it was (and attends
over the S cached positions, its own K/V not among them), and a prefill
bucket longer than the cache keeps only the first S positions. The
port's in-place write must do the same, with a bf16/fp32 cache and with
the int8 cache and its scales, in llama and in Mixtral. ``kernel="cuda"``
on CPU tensors runs flash decode's plain version with a length of S + 1.

Everything is fp32 and the two packages compute the same ops, so the
logits agree to 1e-5 of their largest |value| (fp32 sums in other
orders) and the cache slots bit for bit or to the same 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.models import config as jcfg
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.models import mixtral as jmx
from bitdelta_torch.convert import params_from_numpy, to_numpy
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models import mixtral as tmx
from bitdelta_torch.models.config import ModelConfig

TOL = 1e-5
SLOTS = 16


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _inputs(vocab, s, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (2, s)).astype(np.int32)
    # Row 0 fills the cache; row 1 keeps headroom, so one step writes.
    lengths = np.asarray([min(s, SLOTS), min(s, SLOTS) - 3], np.int32)
    nxt = rng.integers(1, vocab, (2, 1)).astype(np.int32)
    return tokens, lengths, nxt


@pytest.fixture(scope="module")
def llama_world():
    cfg = jcfg.tiny_test_config(vocab_size=64, hidden_size=256,
                                intermediate_size=512, num_layers=2,
                                num_heads=4, num_kv_heads=2, dtype="float32")
    params = jax.tree.map(np.array, jl.init_params(
        cfg, jax.random.PRNGKey(1), jnp.float32))
    tcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    return cfg, params, tcfg, params_from_numpy(params, "cpu")


def _llama_jax(cfg, params, tokens, lengths, nxt, kv_quant):
    logits, cache = jl.forward(
        cfg, params, jnp.asarray(tokens), lengths=jnp.asarray(lengths),
        compute_dtype=jnp.float32, return_cache=True, cache_max_seq=SLOTS,
        kernel="xla", kv_quant=kv_quant)
    step, cache2 = jl.decode_step(cfg, params, jnp.asarray(nxt), cache,
                                  compute_dtype=jnp.float32, kernel="xla")
    return np.array(logits), np.array(step), cache2


def _llama_torch(tcfg, tparams, tokens, lengths, nxt, kv_quant, kernel):
    logits, cache = tl.forward(
        tcfg, tparams, torch.from_numpy(tokens).long(),
        lengths=torch.from_numpy(lengths), compute_dtype=torch.float32,
        return_cache=True, cache_max_seq=SLOTS, kernel=kernel,
        kv_quant=kv_quant)
    step, cache2 = tl.decode_step(tcfg, tparams,
                                  torch.from_numpy(nxt).long(), cache,
                                  compute_dtype=torch.float32, kernel=kernel)
    return to_numpy(logits), to_numpy(step), cache2


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_llama_decode_on_a_full_cache_matches_jax(llama_world, kv_quant,
                                                  kernel):
    cfg, params, tcfg, tparams = llama_world
    tokens, lengths, nxt = _inputs(cfg.vocab_size, SLOTS)
    want_logits, want_step, jcache = _llama_jax(
        cfg, jax.tree.map(jnp.asarray, params), tokens, lengths, nxt,
        kv_quant)
    got_logits, got_step, cache = _llama_torch(tcfg, tparams, tokens,
                                               lengths, nxt, kv_quant,
                                               kernel)
    for row, n in enumerate(lengths):
        _close(got_logits[row, :n], want_logits[row, :n])
    _close(got_step, want_step)
    # Row 0's step wrote nothing; row 1's wrote its slot. (Slots past a
    # row's length hold prefill padding, which the routes fill apart.)
    names = ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v")
    for name in names:
        got = getattr(cache, name).float().numpy()
        want = np.asarray(getattr(jcache, name), np.float32)
        for row, n in enumerate(np.minimum(lengths + 1, SLOTS)):
            _close(got[:, row, :n], want[:, row, :n])
    np.testing.assert_array_equal(cache.length.numpy(), lengths + 1)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_llama_prefill_past_the_cache_keeps_the_first_slots(llama_world,
                                                            kv_quant):
    # A 20-token bucket into a 16-slot cache: slots hold tokens 0..15,
    # the last slot token 15's K/V, as JAX leaves them.
    cfg, params, tcfg, tparams = llama_world
    tokens, _, _ = _inputs(cfg.vocab_size, 20, seed=4)
    lengths = np.full((2,), 20, np.int32)
    jlogits, jcache = jl.forward(
        cfg, jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        lengths=jnp.asarray(lengths), compute_dtype=jnp.float32,
        return_cache=True, cache_max_seq=SLOTS, kernel="xla",
        kv_quant=kv_quant)
    logits, cache = tl.forward(
        tcfg, tparams, torch.from_numpy(tokens).long(),
        lengths=torch.from_numpy(lengths), compute_dtype=torch.float32,
        return_cache=True, cache_max_seq=SLOTS, kernel="torch",
        kv_quant=kv_quant)
    _close(to_numpy(logits), np.array(jlogits))
    names = ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v")
    for name in names:
        got = getattr(cache, name).float().numpy()
        want = np.asarray(getattr(jcache, name), np.float32)
        _close(got[:, :, SLOTS - 1], want[:, :, SLOTS - 1])
        _close(got, want)


def test_write_cache_drops_out_of_range_slots():
    # Direct: row 0 starts at the last slot (one write lands, two drop),
    # row 1 past the end (all drop), row 2 inside.
    cache = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(3, 4, 2)
    want = cache.clone()
    new = -1.0 - torch.arange(3 * 3 * 2, dtype=torch.float32).reshape(3, 3, 2)
    tl.write_cache(cache, torch.tensor([3, 4, 0]), new)
    want[0, 3] = new[0, 0]
    want[2, 0:3] = new[2]
    assert torch.equal(cache, want)


def test_mixtral_decode_on_a_full_cache_matches_jax():
    cfg = jmx.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=64, num_experts=4,
        experts_per_token=2, dtype="float32")
    params = jax.tree.map(np.array, jmx.init_params(
        cfg, jax.random.PRNGKey(2), jnp.float32))
    tokens, lengths, nxt = _inputs(cfg.vocab_size, SLOTS, seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    jlogits, jcache = jmx.forward(
        cfg, jparams, jnp.asarray(tokens), lengths=jnp.asarray(lengths),
        compute_dtype=jnp.float32, return_cache=True, cache_max_seq=SLOTS,
        kernel="xla")
    jstep, jcache2 = jmx.decode_step(cfg, jparams, jnp.asarray(nxt), jcache,
                                     compute_dtype=jnp.float32, kernel="xla")
    tcfg = tmx.MixtralConfig.from_dict(dataclasses.asdict(cfg))
    tparams = params_from_numpy(params, "cpu")
    for kernel in ("torch", "cuda"):
        logits, cache = tmx.forward(
            tcfg, tparams, torch.from_numpy(tokens).long(),
            lengths=torch.from_numpy(lengths), compute_dtype=torch.float32,
            return_cache=True, cache_max_seq=SLOTS, kernel=kernel)
        step, cache2 = tmx.decode_step(tcfg, tparams,
                                       torch.from_numpy(nxt).long(), cache,
                                       compute_dtype=torch.float32,
                                       kernel=kernel)
        for row, n in enumerate(lengths):
            _close(to_numpy(logits)[row, :n], np.array(jlogits)[row, :n])
        _close(to_numpy(step), np.array(jstep))
        for row, n in enumerate(np.minimum(lengths + 1, SLOTS)):
            _close(cache2.k.numpy()[:, row, :n], np.array(jcache2.k)[:, row, :n])
            _close(cache2.v.numpy()[:, row, :n], np.array(jcache2.v)[:, row, :n])
