"""``BENCHMARK.json`` against the contract's shapes and the harness's
files: names and units of the allowed characters, every cell's files
present, every per-layer metric a reader of its own that moves the
metric the manifest says, and no forbidden module after a run."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run as bench_run
from perfbench import world

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in bench["workloads"]] + [
            w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_find_their_files(bench):
    for w in bench["workloads"]:
        cell = world.load_json("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        mix = world.load_json("traffic", w["traffic"])
        assert (bench_run.ROOT / "drivers" / f"{mix['driver']}.py").exists()
        assert cell["limits"]
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_each_per_layer_metric_has_its_reader(bench):
    reports = {}
    for m in bench["end_to_end"]:
        for w in m.get("workloads", [x["name"] for x in bench["workloads"]]):
            reports.setdefault(w, set()).add(m["name"])
    for m in bench["per_layer"]:
        reader = bench_run.load_module(bench_run.ROOT / "metrics"
                                       / f"{m['name']}.py")
        assert reader.MOVES == m["moves"] and reader.UNIT == m["unit"]
        for w in m["workloads"]:
            assert m["moves"] in reports[w], (m["name"], w)


def test_without_a_card_the_run_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "mistral-7b.batch-64", "--seed", str(2 ** 33 + 5), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_run_loads_no_forbidden_module():
    script = (
        "import sys; sys.path[:0] = ['perfbench/tests']\n"
        "from conftest import drive, tiny, tiny_mix\n"
        "from test_perfbench_drivers import SHORT, GAP\n"
        "from perfbench import run\n"
        "mix = tiny_mix('batch-64', clients=2, ramp_concurrency=1, **SHORT,"
        " tenants={'dist': 'uniform', 'min': 0, 'max': 1})\n"
        "drive(tiny('tiny-llama'), mix, GAP, seconds=0.5)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
