"""PyTorch port: the serving check (``utils/compiled_check.py``) against
the JAX package on the CPU.

JAX's world (``llama.init_params(cfg, PRNGKey(0))``, carried across) is
handed to the port's engine runs; every route's greedy tokens must equal
those of JAX's ``Engine(kernel="xla")`` on that world, for the two
tenants and for the W4 base. JAX's whole ``serving_compiled_check`` runs
its Pallas kernels in interpret mode (about a minute here), so JAX's
half is its XLA engine on the same world. Tokens are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_torch.convert import params_from_numpy
from bitdelta_torch.utils import compiled_check as cc


def _jax_world():
    from bitdelta_tpu.models import llama as jl
    from bitdelta_tpu.models.config import ModelConfig

    # bitdelta_tpu/utils/compiled_check.py's config.
    cfg = ModelConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=1,
                      max_seq_len=64, dtype="float32")
    return cfg, jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)


def _jax_tokens(cfg, base):
    """JAX's two engine runs of its check, on the XLA engine."""
    from bitdelta_tpu.core.compress import compress_model
    from bitdelta_tpu.research.quantized_base import (quantize_base,
                                                      roundtrip_base)
    from bitdelta_tpu.serving.engine import Engine, Request
    from bitdelta_tpu.serving.stacking import stack_tenants

    tenants = []
    for t in range(2):
        fine = dict(base)
        fine["layers"] = {k: (v * (1.01 + 0.01 * t) if v.ndim == 3 else v)
                          for k, v in base["layers"].items()}
        fine["embed"] = base["embed"] * 1.01
        fine["lm_head"] = base["lm_head"] * 1.01
        tenants.append(compress_model(base, fine, compress_embeddings=True))
    stack = stack_tenants(cfg, base, tenants)
    reqs = [Request(prompt_ids=[3, 1, 4, 1, 5], tenant_id=0,
                    max_new_tokens=4),
            Request(prompt_ids=[2, 7, 2], tenant_id=1, max_new_tokens=4)]
    tokens = Engine(cfg, stack, max_slots=2, max_seq=64,
                    prefill_buckets=(16,), kernel="xla").generate(reqs)
    deq = roundtrip_base(base, "int4", jnp.float32)
    stack_w4 = stack_tenants(cfg, quantize_base(base, "int4"),
                             [compress_model(deq, deq)])
    w4 = Engine(cfg, stack_w4, max_slots=1, max_seq=64,
                prefill_buckets=(16,), kernel="xla").generate(
        [Request(prompt_ids=[3, 1, 4], tenant_id=0, max_new_tokens=4)])
    as_lists = lambda outs: [list(map(int, o)) for o in outs]  # noqa: E731
    return as_lists(tokens), as_lists(w4)


def test_check_config_is_jax_world_config():
    jcfg, _ = _jax_world()
    assert dataclasses.asdict(cc.check_config()) == dataclasses.asdict(jcfg)


def test_port_engines_on_jax_world_give_jax_tokens():
    jcfg, jbase = _jax_world()
    want_tokens, want_w4 = _jax_tokens(jcfg, jbase)
    base = params_from_numpy(jax.tree.map(np.asarray, jbase), "cpu")
    logs = []
    got = cc.check_engines(cc.check_config(), base, logs.append,
                           device="cpu")
    assert got == {"status": "ok", "tokens": want_tokens,
                   "w4_tokens": want_w4}
    assert len(logs) == 2 and "cuda and cuda_fused" in logs[0]


def test_serving_compiled_check_on_the_cpu():
    logs = []
    got = cc.serving_compiled_check(logs.append, device="cpu")
    assert got["status"] == "ok"
    assert [len(t) for t in got["tokens"]] == [4, 4]
    assert [len(t) for t in got["w4_tokens"]] == [4]
    assert all(0 <= t < 512 for row in got["tokens"] for t in row)
    # The world comes from a seeded generator: the same tokens again.
    assert cc.serving_compiled_check(lambda _: None, device="cpu") == got


def test_a_diverging_route_raises(monkeypatch):
    real = cc._generate

    def fake(cfg, stack, kernel, requests, device, max_slots):
        out = real(cfg, stack, kernel, requests, device, max_slots)
        if kernel == "cuda_fused":
            out[0][-1] += 1
        return out

    monkeypatch.setattr(cc, "_generate", fake)
    with pytest.raises(AssertionError, match="cuda_fused engine diverged"):
        cc.serving_compiled_check(lambda _: None, device="cpu")


def test_serving_compiled_check_defaults_to_the_card():
    if torch.cuda.is_available():
        assert cc.serving_compiled_check(lambda _: None)["status"] == "ok"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cc.serving_compiled_check(lambda _: None)


def test_check_engines_with_want_runs_only_the_meshed_engines(monkeypatch):
    """``want=`` (an earlier call's result): the single-process engines
    do not run again, only the meshed ones, held to ``want``; a meshed
    engine that diverges from it still raises."""
    from bitdelta_torch.parallel.mesh import make_mesh

    cfg = cc.check_config()
    base = cc.check_world(cfg, "cpu")
    ref = cc.check_engines(cfg, base, lambda _: None, device="cpu")
    mesh = make_mesh((1, 1), device="cpu")
    meshes = []
    real = cc._generate

    def counting(cfg, stack, kernel, requests, device, max_slots,
                 mesh=None, **kw):
        meshes.append(mesh)
        return real(cfg, stack, kernel, requests, device, max_slots, mesh,
                    **kw)

    monkeypatch.setattr(cc, "_generate", counting)
    got = cc.check_engines(cfg, base, lambda _: None, device="cpu",
                           mesh=mesh, want=ref)
    assert got == ref
    assert len(meshes) == 3 and all(m is mesh for m in meshes)
    bad = dict(ref, tokens=[t[:-1] + [t[-1] + 1] for t in ref["tokens"]])
    with pytest.raises(AssertionError, match=r"on mesh \(1, 1\) diverged"):
        cc.check_engines(cfg, base, lambda _: None, device="cpu",
                         mesh=mesh, want=bad)
