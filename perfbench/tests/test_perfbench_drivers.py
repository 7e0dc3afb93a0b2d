"""Each traffic driver end to end on a tiny configuration, on the CPU
(the engine's plain route), with the comparison against the plain
reference deciding ``correct``."""

from __future__ import annotations

import pytest

from conftest import drive, tiny, tiny_mix

SERVE_ENGINE = {"max_slots": 4, "max_seq": 96, "prefill_buckets": [16, 32],
                "decode_chunk": 4}
SHORT = {"prompt_tokens": {"dist": "uniform", "min": 8, "max": 30},
         "output_tokens": {"dist": "uniform", "min": 6, "max": 12},
         "engine": SERVE_ENGINE, "block": 8, "compare_tokens": 20,
         "compare_requests": 3}
GAP = {"max_gap": 1e-3, "mean_gap": 1e-4}


@pytest.mark.parametrize("config", ["tiny-llama", "tiny-mixtral-w8"])
def test_closed_loop(config):
    mix = tiny_mix("batch-64", clients=3, ramp_concurrency=2, **SHORT,
                   tenants={"dist": "uniform", "min": 0, "max": 1})
    r = drive(tiny(config), mix, GAP, seconds=1.5)
    assert r["correct"], r["checks"]
    assert r["metrics"]["output_tok_s"] > 0
    assert r["checks"]["tokens_compared"]["value"] >= 12
    assert r["failed"] == 0


def test_decode_only():
    mix = tiny_mix("decode-16", lanes=3, ramp_concurrency=2, **{
        **SHORT, "output_tokens": {"dist": "uniform", "min": 60, "max": 60}})
    r = drive(tiny("tiny-mixtral-w8"), mix, GAP, seconds=1.0)
    assert r["correct"], r["checks"]
    assert r["metrics"]["output_tok_s"] > 0
    assert r["attempted"] == 3


def test_open_loop():
    mix = tiny_mix("chat-open", rate_per_s=6.0, ramp_s=0.5, drain_s=30,
                   **{**SHORT, "prompt_tokens": {
                       "dist": "lognormal", "median": 16, "sigma": 0.6,
                       "min": 8, "max": 30}})
    r = drive(tiny("tiny-llama"), mix, GAP, seconds=1.5)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["ttft_p90_ms"] > 0 and m["tpot_p90_ms"] > 0
    assert r["extra"]["requests_due"] == r["attempted"] >= 3
    assert r["failed"] == 0


def test_distill():
    # fp32 compute: at this size bf16 rounding outweighs the delta's own
    # effect on the loss.
    mix = tiny_mix("distill-4x128", batch=2, length=16,
                   compute_dtype="float32")
    r = drive(tiny("tiny-llama"), mix,
              {"loss_gap": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-3},
              seconds=0.5)
    assert r["correct"], r["checks"]
    assert r["metrics"]["distill_tok_s"] > 0


def test_traced_run_reads_its_layers():
    from perfbench import run as bench_run

    mix = tiny_mix("batch-64", clients=3, ramp_concurrency=2, **SHORT,
                   tenants={"dist": "uniform", "min": 0, "max": 1})
    r = drive(tiny("tiny-llama"), mix, GAP, seconds=1.5, trace=True)
    got = bench_run.per_layer(r["ctx"], r)
    # The CPU runs no kernel: the device readers find nothing but idle.
    assert got["device_idle_pct.tok"]["value"] == 100.0
    assert got["lanes_active_mean.tok"]["value"] >= 1
    assert got["pump_ms_mean.tok"]["value"] > 0
    assert "pair_delta_roofline.tok" not in got
    tr = r["ctx"].probe.trace
    assert tr.window_s > 0 and tr.idle_gaps()
    r["ctx"].probe.uninstall()
