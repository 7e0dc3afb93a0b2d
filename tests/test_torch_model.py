"""PyTorch port: the decoder's prefill and decode logits against the JAX
package, with tenant-routed deltas in both layouts (canonical and
pair-packed).

The port's ``kernel="torch"`` and its ``kernel="cuda"`` dispatch (the
kernel branches, which on CPU tensors run the kernels' plain versions)
are both held against JAX ``kernel="xla"`` at the 2e-3 that
tests/test_pallas_kernels.py uses for its dispatch tests (the pair
kernel quantizes activations to a 12-bit grid). Decode is also held
against the full forward of the extended sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.models import config as jcfg
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.serving.stacking import stack_tenants as jstack
from bitdelta_tpu.serving.stacking import to_pair_layout as jpair
from bitdelta_torch.convert import stack_from_numpy, to_numpy
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models.config import ModelConfig

TOL = 2e-3


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _cfg(**kw):
    base = dict(vocab_size=64, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32")
    base.update(kw)
    return jcfg.tiny_test_config(**base)


def _tcfg(cfg):
    import dataclasses

    return ModelConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=["canonical", "paired"])
def world(request):
    # Base and fine-tunes from numpy seeds; the port compresses them
    # (bit-exact with JAX, tests/test_torch_delta_artifact.py) and both
    # packages stack the same compressed tenants.
    from bitdelta_tpu.core.compress import CompressedModel as JCompressed
    from bitdelta_tpu.core.delta import BinaryDelta as JDelta
    from bitdelta_torch.convert import params_from_numpy
    from bitdelta_torch.core.compress import compress_model

    cfg = _cfg(sliding_window=6)
    rng = np.random.default_rng(0)
    base = _np_tree(jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    tenants = []
    for _ in range(3):
        fine = dict(base)
        fine["layers"] = dict(base["layers"])
        for name in jl.PROJ_NAMES + ("attn_norm",):
            w = base["layers"][name]
            fine["layers"][name] = (w + 0.01 * rng.standard_normal(w.shape)
                                    ).astype(np.float32)
        fine["lm_head"] = (base["lm_head"] + 0.01 * rng.standard_normal(
            base["lm_head"].shape)).astype(np.float32)
        comp = compress_model(params_from_numpy(base, "cpu"),
                              params_from_numpy(fine, "cpu"))
        tenants.append(JCompressed(
            deltas={n: JDelta(jnp.asarray(d.packed.numpy()),
                              jnp.asarray(d.scale.numpy()))
                    for n, d in comp.deltas.items()},
            extras={n: jnp.asarray(x.numpy())
                    for n, x in comp.extras.items()}))
    stack = jstack(cfg, jax.tree.map(jnp.asarray, base), tenants)
    if request.param == "paired":
        stack = jpair(stack)
    tstack = stack_from_numpy(jax.tree.map(np.array, stack), "cpu")
    return cfg, stack, tstack, {}


def _run_jax(cfg, stack, tokens, lengths, ids, nxt):
    logits, cache = jl.forward(
        cfg, stack.params, jnp.asarray(tokens), lengths=jnp.asarray(lengths),
        deltas=stack.deltas, tenant_ids=jnp.asarray(ids),
        compute_dtype=jnp.float32, return_cache=True, cache_max_seq=24,
        kernel="xla")
    step, _ = jl.decode_step(cfg, stack.params, jnp.asarray(nxt), cache,
                             deltas=stack.deltas,
                             tenant_ids=jnp.asarray(ids),
                             compute_dtype=jnp.float32, kernel="xla")
    return np.array(logits), np.array(cache.k), np.array(step)


def _run_torch(cfg, tstack, tokens, lengths, ids, nxt, kernel):
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    tcfg = _tcfg(cfg)
    logits, cache = tl.forward(
        tcfg, tstack.params, t(tokens).long(), lengths=t(lengths),
        deltas=tstack.deltas, tenant_ids=t(ids).long(),
        compute_dtype=torch.float32, return_cache=True, cache_max_seq=24,
        kernel=kernel)
    step, cache2 = tl.decode_step(tcfg, tstack.params, t(nxt).long(), cache,
                                  deltas=tstack.deltas,
                                  tenant_ids=t(ids).long(),
                                  compute_dtype=torch.float32, kernel=kernel)
    return to_numpy(logits), cache, to_numpy(step), cache2


def _inputs(bsz):
    rng = np.random.default_rng(bsz)
    tokens = rng.integers(1, 64, (bsz, 16)).astype(np.int32)
    lengths = np.asarray([16, 11, 7][:bsz], np.int32)
    ids = np.asarray([2, 0, 1][:bsz], np.int32)
    nxt = rng.integers(1, 64, (bsz, 1)).astype(np.int32)
    return tokens, lengths, ids, nxt


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
@pytest.mark.parametrize("bsz", [3, 1])
def test_forward_and_decode_match_jax(world, kernel, bsz):
    # bsz=1 takes the single-request prefill branch (binary matmul kernel
    # path) under kernel="cuda"; bsz=3 the batched prefill path.
    cfg, stack, tstack, jax_results = world
    tokens, lengths, ids, nxt = _inputs(bsz)
    if bsz not in jax_results:
        jax_results[bsz] = _run_jax(cfg, stack, tokens, lengths, ids, nxt)
    want_logits, want_k, want_step = jax_results[bsz]
    got_logits, cache, got_step, _ = _run_torch(cfg, tstack, tokens,
                                                lengths, ids, nxt, kernel)
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(got_logits[row, :n], want_logits[row, :n],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(cache.k.numpy()[:, row, :n],
                                   want_k[:, row, :n], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache.length.numpy(), lengths)
    np.testing.assert_allclose(got_step, want_step, rtol=TOL, atol=TOL)


def test_decode_matches_full_forward(world):
    # The decode step's logits equal the full forward over the sequence
    # with the new token appended (per row, at its own length).
    cfg, _, tstack, _ = world
    tokens, lengths, ids, nxt = _inputs(3)
    _, _, got_step, cache2 = _run_torch(cfg, tstack, tokens, lengths, ids,
                                        nxt, "cuda")
    np.testing.assert_array_equal(cache2.length.numpy(), lengths + 1)
    ext = np.zeros((3, 24), np.int32)
    ext[:, :16] = tokens
    for row, n in enumerate(lengths):
        ext[row, n] = nxt[row, 0]
    full = tl.forward(_tcfg(cfg), tstack.params, torch.from_numpy(ext).long(),
                      lengths=torch.from_numpy(lengths + 1),
                      deltas=tstack.deltas,
                      tenant_ids=torch.from_numpy(ids).long(),
                      compute_dtype=torch.float32, kernel="torch")
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(got_step[row, 0], full[row, n].numpy(),
                                   rtol=TOL, atol=TOL)
