"""The yardstick's arithmetic against hand-worked values: percentiles,
window rates, spreads, stratified draws, the work functions and the trace
reduction."""

from __future__ import annotations

import math

import pytest

from perfbench import generator, roofline, stats
from perfbench.trace import Trace


def test_percentile_nearest_rank():
    vals = list(range(1, 21))                  # 1..20
    assert stats.percentile(vals, 90) == 18    # ceil(0.9 * 20) = 18th
    assert stats.percentile(vals, 50) == 10
    assert stats.percentile([5.0], 90) == 5.0
    # A miss counts: two of ten missing puts p90 on a miss.
    assert stats.percentile([1] * 8 + [math.inf] * 2, 90) == math.inf
    assert stats.percentile([1] * 9 + [math.inf], 90) == 1


def test_tokens_produced_spreads_each_burst_since_the_last():
    # The prefill's token at 0.5, then bursts of 8 at 1.0 and 2.0.
    stamps = [0.5] + [1.0 + i * 1e-5 for i in range(8)] + [
        2.0 + i * 1e-5 for i in range(8)]
    assert stats.tokens_produced(stamps, 0.0, 3.0) == pytest.approx(17)
    # [0.75, 1.5): half of the first burst's 0.5 s, half of the second's.
    assert stats.tokens_produced(stamps, 0.75, 1.5) == pytest.approx(
        4 + 4, rel=1e-3)
    # The prefill's token, and a fifth of the first burst's 8.
    assert stats.tokens_produced(stamps, 0.4, 0.6) == pytest.approx(
        1 + 1.6, rel=1e-3)


def test_stratified_draws_are_the_same_set_for_every_seed():
    spec = {"dist": "lognormal", "median": 768, "sigma": 0.6, "min": 128,
            "max": 2048}
    mix = {"prompt_tokens": spec, "output_tokens": spec, "block": 16,
           "tenants": {"dist": "zipf", "s": 1.1}, "rate_per_s": 2.0}
    a = generator.Mix(mix, 1, 100, 16)
    b = generator.Mix(mix, 2 ** 40 + 7, 100, 16)
    lens_a = [len(a.request(j)["prompt"]) for j in range(16)]
    lens_b = [len(b.request(j)["prompt"]) for j in range(16)]
    assert sorted(lens_a) == sorted(lens_b) and lens_a != lens_b
    assert sorted(lens_a)[8] in range(700, 840)     # the median stratum
    assert sorted(a.request(j)["tenant"] for j in range(16)) == sorted(
        b.request(j)["tenant"] for j in range(16))
    gaps_a = a.arrivals(100.0)
    assert 150 <= len(gaps_a) <= 250                # 2 a second for 100 s


def test_quantile_functions():
    u = generator.quantile_fn({"dist": "uniform", "min": 128, "max": 512})
    assert u(0.0) == 128 and u(0.999999) == 512
    z = generator.quantile_fn({"dist": "zipf", "s": 1.1}, 16)
    assert z(0.01) == 0 and z(0.999999) == 15
    e = generator.quantile_fn({"dist": "exponential", "mean": 0.5})
    assert e(1 - math.exp(-1)) == pytest.approx(0.5)


def test_pair_delta_work_counts_each_distinct_matrix_once():
    k, n = 4096, 14336
    b, ops = roofline.pair_delta_work(k, n, live_rows=64, matrices=16)
    words = 16 * (k * n / 8 + 4 * n + 4)
    assert b == words + 64 * (k * 2 + 4 * n)
    assert ops == 2 * 64 * k * n
    # Memory bound: 14 GB of words at 3.35 TB/s.
    assert roofline.bound_s(b, ops) == pytest.approx(b / 3.35e12)


def test_flash_decode_and_binary_matmul_work():
    b, ops = roofline.flash_decode_work([100, 300], 32, 8, 128)
    assert b == 400 * 2 * 8 * 128 * 2 + 2 * 2 * 32 * 128 * 2
    assert ops == 4 * 32 * 128 * 400
    b, ops = roofline.binary_matmul_work(512, 4096, 14336)
    assert b == 4096 * 14336 / 8 + 512 * 4096 * 2 + 512 * 14336 * 4
    assert roofline.bound_s(b, ops) == pytest.approx(ops / 989e12)


def test_model_flops_of_mistral_7b():
    shapes = {"hidden": 4096, "intermediate": 14336, "layers": 32,
              "heads": 32, "kv_heads": 8, "head_dim": 128, "vocab": 32000}
    p = roofline.dense_params_per_token(shapes)
    assert p == 32 * (4096 * 4096 * 2 + 2 * 4096 * 1024
                      + 3 * 4096 * 14336) + 4096 * 32000   # 7.11e9
    assert roofline.decode_token_flops(shapes, 10) == 2 * p + 32 * 4 * 4096 * 10
    assert roofline.prefill_flops(shapes, 4) == (
        2 * p * 4 + 32 * 4 * 4096 * 10)                    # 1+2+3+4 keys
    mix = dict(shapes, experts=8, experts_per_token=2)
    assert roofline.dense_params_per_token(mix) == 32 * (
        4096 * 4096 * 2 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 14336
        + 4096 * 8) + 4096 * 32000


def _trace():
    ev = [{"ph": "X", "name": "perfbench.window", "cat": "user_annotation",
           "ts": 1000.0, "dur": 100.0, "tid": 1}]
    for corr, (ts, dur, tid, name) in enumerate([
            (990.0, 20.0, 7, "flash_decode_split_kernel"),
            (1020.0, 10.0, 7, "pair_delta_tc_kernel"),
            (1025.0, 10.0, 9, "binary_matmul_kernel"),
            (1080.0, 40.0, 7, "flash_decode_split_kernel")]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "ts": ts - 5,
                   "dur": 1.0, "tid": tid, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": dur, "tid": 3, "args": {"correlation": corr}})
    return Trace(ev, {"pump": [(0.0, 0.00005)]}, t0=0.0)


def test_trace_busy_idle_and_attribution():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-4)
    # Busy: [1000,1010] + [1020,1035] + [1080,1100] = 45 us.
    assert tr.busy_s == pytest.approx(45e-6)
    assert tr.kernel_s(("flash_decode",)) == pytest.approx(30e-6)
    tids = tr.launch_tids(("flash_decode",))
    assert tids == {7}
    assert tr.kernel_s(tids=tids) == pytest.approx(40e-6)
    gaps = dict(tr.idle_gaps())
    # The pump span covers trace times 1000..1050. A gap is labelled by
    # its midpoint: 1010-1020 lies in it, 1035-1080 (midpoint 1057.5)
    # does not.
    assert gaps["pump"] == pytest.approx(10e-6)
    assert gaps["no harness span"] == pytest.approx(45e-6)
