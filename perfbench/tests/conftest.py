"""Fixtures of the benchmark's CPU tests: tiny configurations and mixes,
and a driver run on the CPU (the plain route) without the look for a
card."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from perfbench import run as bench_run

DATA = Path(__file__).resolve().parent / "data"
MIXES = Path(__file__).resolve().parents[1] / "traffic"


def tiny(name: str) -> dict:
    with open(DATA / f"{name}.json") as f:
        return json.load(f)


def tiny_mix(name: str, **changes) -> dict:
    """A shipped mix cut to the tiny model's sizes."""
    with open(MIXES / f"{name}.json") as f:
        mix = json.load(f)
    mix = copy.deepcopy(mix)
    mix.update(changes)
    return mix


def drive(cfg: dict, mix: dict, limits: dict, seed: int = 3,
          seconds: float = 1.0, trace: bool = False) -> dict:
    """Run ``mix``'s driver on the CPU and return its result."""
    cell = {"config": cfg["name"], "traffic": "test", "chips": 1,
            "limits": limits}
    ctx = bench_run.Context(cell, cfg, mix, seed, seconds,
                            torch.device("cpu"), trace)
    driver = bench_run.load_module(bench_run.ROOT / "drivers"
                                   / f"{mix['driver']}.py")
    result = driver.run(ctx)
    result["ctx"] = ctx
    return result


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
