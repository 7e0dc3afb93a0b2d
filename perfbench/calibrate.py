"""The readings that a cell's limits are set from: for each seed, one run
of the cell's driver with a short window (the program's numbers against
the plain reference), then the control, the reference itself in the next
precision below bf16 (float8 e4m3 operands at every weight matmul), on
the same prompts and tokens or batches, in the same process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 11,12,13 --seconds 20

Prints one JSON line a seed: ``program`` and ``control`` numbers. With
``--fault`` the program runs with that fault planted underneath (see
``FAULTS``) and no control is run: the fault's own readings."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run as bench_run
from . import serving, world
from .reference import distill as distill_ref

CONTROL = "fp8"


def _altered_token():
    """A token altered where it is produced: the engine's sampler returns
    the next id for every seventh lane's pick."""
    from bitdelta_torch.serving import engine

    sample = engine.sample_tokens

    def altered(*a, **kw):
        tok = sample(*a, **kw)
        return torch.where(tok % 7 == 3, tok + 1, tok)
    engine.sample_tokens = altered


def _half_batch():
    """Half of the batch left out: the step sees the first half of its
    rows, and its mean is over them."""
    from bitdelta_torch.train import distill

    make = distill.make_distill_step

    def half(*a, **kw):
        step = make(*a, **kw)
        return lambda batch: step(batch[: batch.shape[0] // 2])
    distill.make_distill_step = half


FAULTS = {"altered_token": _altered_token, "half_batch": _half_batch}


def control(ctx, result) -> dict:
    """The control's numbers beside the program's, for one run."""
    layer = result["layer"]
    if ctx.mix["driver"] == "distill":
        ctl = distill_ref.follow(ctx.cfg, ctx.seed, layer["batches"],
                                 layer["dcfg"], ctx.device, CONTROL)
        return distill_ref.gaps(ctl, layer["reference"])
    got = serving.served_gap(ctx.cfg, ctx.seed, layer["compared"],
                             ctx.device, CONTROL)
    return {k[len("control_"):]: v for k, v in got.items()
            if k.startswith("control_")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    cell = world.load_json("workloads", args.workload)
    cfg = world.load_json("configs", cell["config"])
    mix = world.load_json("traffic", cell["traffic"])
    driver = bench_run.load_module(bench_run.ROOT / "drivers"
                                   / f"{mix['driver']}.py")
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench_run.Context(cell, cfg, mix, seed, args.seconds, device,
                                False)
        torch.cuda.reset_peak_memory_stats()
        result = driver.run(ctx)
        line = {"workload": args.workload, "seed": seed,
                "correct": result["correct"],
                "metrics": result["metrics"],
                "program": {**result["layer"].get("gaps", {}),
                            **{k: c["value"] for k, c in
                               result["checks"].items()}}}
        if args.control and not args.fault:
            line["control"] = control(ctx, result)
        print(json.dumps(line), flush=True)
        del result, ctx
        serving.release()
    sys.exit(0)


if __name__ == "__main__":
    main()
