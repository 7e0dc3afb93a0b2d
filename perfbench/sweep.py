"""Find an open-loop cell's knee once: one engine, warmed once, then one
open-loop window at each offered rate, reporting the tails and how many
requests due in the window were still unfinished when the drain ended.

    python3 -m perfbench.sweep --workload mistral-7b.chat-open --rates 1,1.5,2,2.5 --seconds 30

Prints one JSON line a rate. No reference runs: the sweep only sizes the
cell's fixed rate."""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from . import run as bench_run
from . import serving, stats, world


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    cell = world.load_json("workloads", args.workload)
    cfg = world.load_json("configs", cell["config"])
    mix = world.load_json("traffic", cell["traffic"])
    driver = bench_run.load_module(bench_run.ROOT / "drivers"
                                   / f"{mix['driver']}.py")
    ctx = bench_run.Context(cell, cfg, mix, args.seed, args.seconds,
                            torch.device("cuda", 0), False)
    app = serving.build_app(cfg, mix, args.seed, ctx.device)
    serving.warm(app, mix, world.shapes(cfg)["vocab"])
    for rate in (float(r) for r in args.rates.split(",")):
        w = driver.serve(ctx, app, {**mix, "rate_per_s": rate})
        done = [r for r in w["ok"]]
        print(json.dumps({
            "rate_per_s": rate, "due": len(w["due"]),
            "unfinished": len(w["missed"]),
            "ttft_p50_ms": statistics.median(w["ttft"]) * 1e3,
            "ttft_p90_ms": stats.percentile(w["ttft"], 90) * 1e3,
            "tpot_p50_ms": statistics.median(w["tpot"]) * 1e3,
            "tpot_p90_ms": stats.percentile(w["tpot"], 90) * 1e3,
            "output_tok_s": serving.tokens_in(w["records"], w["t0"], w["t1"])
            / (w["t1"] - w["t0"]),
            "lag_max_ms": max(w["lag"]) * 1e3 if w["lag"] else None,
            "finished": len(done)}), flush=True)
    serving.free(app)


if __name__ == "__main__":
    main()
