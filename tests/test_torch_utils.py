"""The port's utilities and ``Engine.warmup`` on the CPU:
``weight_corr_stddev`` against the JAX package's (within 1e-6), the
profiler trace, ``StepTimer`` and ``device_memory_stats``, and the
warmup's contract (JAX's ``Engine.warmup``): it returns ``{"prefill":
buckets, "decode": [decode_chunk]}``, refuses an engine that is not idle, and
leaves the engine's results as they were."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_torch.core.compress import compress_model
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models.config import tiny_test_config
from bitdelta_torch.serving.engine import Engine, Request
from bitdelta_torch.serving.stacking import stack_tenants


def _world(seed=0, n_tenants=2):
    cfg = tiny_test_config(vocab_size=64, hidden_size=64,
                           intermediate_size=128)
    gen = torch.Generator().manual_seed(seed)
    base = tl.init_params(cfg, gen, torch.float32, scale=0.1, device="cpu")
    fines = []
    for _ in range(n_tenants):
        layers = {n: w + 0.02 * torch.randn(w.shape, generator=gen)
                  if n in tl.PROJ_NAMES else w
                  for n, w in base["layers"].items()}
        fines.append(dict(base, layers=layers))
    return cfg, base, fines


def test_weight_corr_stddev_matches_jax():
    from bitdelta_torch.utils.diagnostics import weight_corr_stddev as t_wcs
    from bitdelta_tpu.utils.diagnostics import weight_corr_stddev as j_wcs

    _, base, fines = _world()

    def jtree(p):
        return {"layers": {n: jnp.asarray(w.numpy())
                           for n, w in p["layers"].items()}}

    got = t_wcs(base, fines[0])
    want = j_wcs(jtree(base), jtree(fines[0]))
    assert set(got) == {"corr", "stddev"}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)


def _engine(cfg, base, fines, **kw):
    stack = stack_tenants(cfg, base, [compress_model(base, f) for f in fines],
                          device="cpu")
    return Engine(cfg, stack, max_slots=4, max_seq=64,
                  prefill_buckets=(16, 64), kernel="torch",
                  compute_dtype=torch.float32, device="cpu", **kw)


def _requests():
    return [Request(prompt_ids=[3, 5, 7, 9][:2 + i], tenant_id=i % 2,
                    max_new_tokens=5) for i in range(3)]


@pytest.mark.parametrize("kv_dtype", (None, "int8"))
def test_engine_warmup_returns_buckets_and_keeps_results(kv_dtype):
    cfg, base, fines = _world()
    cold = _engine(cfg, base, fines, kv_dtype=kv_dtype)
    want = cold.generate(_requests())
    warm = _engine(cfg, base, fines, kv_dtype=kv_dtype, decode_chunk=4)
    assert warm.warmed == {"prefill": [], "decode": []}
    lengths = warm.cache.length.clone()
    out = warm.warmup()
    assert out == warm.warmed == {"prefill": [16, 64], "decode": [4]}
    assert torch.equal(warm.cache.length, lengths)
    assert warm.generate(_requests()) == want


def test_engine_warmup_refuses_a_busy_engine():
    cfg, base, fines = _world()
    engine = _engine(cfg, base, fines)
    engine.submit(Request(prompt_ids=[1, 2, 3], tenant_id=0,
                          max_new_tokens=8))
    with pytest.raises(RuntimeError, match="idle"):
        engine.warmup()


def test_trace_writes_a_chrome_trace(tmp_path):
    from bitdelta_torch.utils.profiling import trace

    with trace(str(tmp_path / "prof")) as d:
        torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.load(open(os.path.join(d, "trace.json")))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_step_timer_and_memory_stats():
    from bitdelta_torch.utils.profiling import StepTimer, device_memory_stats

    timer = StepTimer(window=2)
    for tokens in (4, 8, 16):
        with timer.step(tokens=tokens) as tick:
            tick.tokens += 1
    s = timer.summary()
    assert s["steps_measured"] == 2 and timer.tokens == [9, 17]
    assert s["tokens_per_sec"] > 0 and s["mean_step_time_s"] >= 0
    # The engine's decode meter is this timer, fed through ``add`` once a
    # pump: its wall time, its chunk's tokens and the chunk's steps.
    timer.add(0.5, 3, steps=4)
    assert timer.tokens == [17, 3] and timer.times[-1] == 0.5
    assert timer.steps == [1, 4]
    s = timer.summary()
    assert s["steps_measured"] == 5
    assert s["mean_step_time_s"] == pytest.approx(sum(timer.times) / 5)
    assert s["tokens_per_sec"] == pytest.approx(20 / sum(timer.times))
    from bitdelta_torch.serving import engine
    assert engine.StepTimer is StepTimer
    if not torch.cuda.is_available():
        assert device_memory_stats() is None
