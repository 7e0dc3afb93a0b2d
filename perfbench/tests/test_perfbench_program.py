"""The program's spans as the benchmark reads them (``program.py`` and its
readers under ``metrics/``), on the tiny configurations on the CPU. A
traced run reports the new metrics whose inputs the CPU has; with the
recorder taken away, as in a program that predates it, the same run
reports exactly the metrics it reported before them, and raises
nothing."""

from __future__ import annotations

import importlib

import pytest

from conftest import drive, tiny, tiny_mix
from perfbench import program
from perfbench import run as bench_run
from test_perfbench_drivers import GAP, SHORT

NEW = {"engine_step_device_ms.tok", "dispatch_ms_per_step.tok",
       "dispatch_cpu_pct.tok", "submit_ms.tok", "idle_in_dispatch_pct.tok",
       "idle_in_consume_pct.tok", "idle_in_step_pct.distill"}
# What a traced tiny run reported before the program had spans.
BEFORE = {"serve": {"device_idle_pct.tok", "lanes_active_mean.tok",
                    "pump_ms_mean.tok", "step_mfu.tok"},
          "distill": {"device_idle_pct.distill", "step_mfu.distill"}}
PROGRAM_MODULES = ("bitdelta_torch.models.llama",
                   "bitdelta_torch.models.mixtral",
                   "bitdelta_torch.serving.engine",
                   "bitdelta_torch.serving.server",
                   "bitdelta_torch.train.distill")
# The new metrics the CPU has inputs for: its trace holds no kernel.
ON_CPU = {"serve": NEW - {"engine_step_device_ms.tok",
                          "idle_in_step_pct.distill"},
          "distill": {"idle_in_step_pct.distill"}}


def _traced(kind: str):
    if kind == "serve":
        mix = tiny_mix("batch-64", clients=3, ramp_concurrency=2, **SHORT,
                       tenants={"dist": "uniform", "min": 0, "max": 1})
        r = drive(tiny("tiny-llama"), mix, GAP, seconds=1.5, trace=True)
    else:
        mix = tiny_mix("distill-4x128", batch=2, length=16,
                       compute_dtype="float32")
        r = drive(tiny("tiny-llama"), mix,
                  {"loss_gap": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-3},
                  seconds=0.5, trace=True)
    try:
        return r, bench_run.per_layer(r["ctx"], r)
    finally:
        r["ctx"].probe.uninstall()


@pytest.mark.parametrize("kind", ["serve", "distill"])
def test_traced_run_reads_the_programs_spans(kind):
    r, got = _traced(kind)
    assert r["correct"], r["checks"]
    assert set(got) == BEFORE[kind] | ON_CPU[kind]
    if kind == "serve":
        idle = got["device_idle_pct.tok"]["value"]
        split = (got["idle_in_dispatch_pct.tok"]["value"]
                 + got["idle_in_consume_pct.tok"]["value"])
        assert 0 < split <= idle + 1e-9
        assert got["dispatch_ms_per_step.tok"]["value"] > 0
        assert 0 < got["dispatch_cpu_pct.tok"]["value"] <= 100 + 1e-9
        # The program's decode steps in the profiled stretch are the
        # harness's (``Engine._parked`` answering no).
        ctx = r["ctx"]
        mine = len(program.in_stretch(ctx, "engine.decode_step"))
        assert abs(mine - len(ctx.probe.calls["step"])) <= 1
    else:
        assert (0 < got["idle_in_step_pct.distill"]["value"]
                <= got["device_idle_pct.distill"]["value"] + 1e-9)


@pytest.mark.parametrize("kind", ["serve", "distill"])
def test_a_program_without_the_recorder_reports_what_it_did(kind,
                                                             monkeypatch):
    from bitdelta_torch.utils import profiling

    # The program's modules bind the recorder when imported: import them
    # first, so that only the readers see it gone.
    for name in PROGRAM_MODULES:
        importlib.import_module(name)
    monkeypatch.delattr(profiling, "RECORDER")
    assert program.recorder() is None
    _, got = _traced(kind)
    assert set(got) == BEFORE[kind]


@pytest.mark.parametrize("x, y, both, x_only", [
    ([(0, 4), (6, 9)], [(1, 2), (3, 7)], [(1, 2), (3, 4), (6, 7)],
     [(0, 1), (2, 3), (7, 9)]),
    ([(0, 1)], [], [], [(0, 1)]),
    ([(2, 3)], [(0, 5)], [(2, 3)], []),
    ([(0, 2), (3, 5)], [(1, 4)], [(1, 2), (3, 4)], [(0, 1), (4, 5)]),
])
def test_interval_algebra(x, y, both, x_only):
    assert program.intersect(x, y) == both
    assert program.minus(x, y) == x_only
