"""Scale distillation, the program's training step
(``train/distill.py``: ``make_optimizer`` and ``make_distill_step``, the
step ``distill_scales`` loops over) on batches of ``batch`` x ``length``
calibration tokens, distinct rows drawn from the seed. The teacher is a
dense fine-tune of the seed's base; the student is the program's
``compress_model`` of it. Set-up builds the one step, with its scales and
AdamW state, and drives it through the first three steps, which the
reference follows; the same step then runs in the window. Reports
``distill_tok_s``: the window's whole steps' tokens over the time from
the window's start to the end of its last step."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from perfbench import serving, world
from perfbench.reference import distill as reference

COMPARED_STEPS = 3


def batch(seed: int, j: int, b: int, s: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(world.leaf_seed(seed, "batch", j))
    return rng.integers(1, vocab, (b, s))


def run(ctx) -> dict:
    from bitdelta_torch.core.compress import compress_model, get_scales
    from bitdelta_torch.train.distill import (DistillConfig,
                                              make_distill_step,
                                              make_optimizer)

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    s = world.shapes(cfg)
    b, n = mix["batch"], mix["length"]
    base, fine = world.dense_model(cfg, ctx.seed, dev)
    ctx.mark("inputs")
    compressed = compress_model(base, fine)
    dcfg = DistillConfig(lr=mix["lr"], num_steps=mix["num_steps"],
                         weight_decay=mix["weight_decay"],
                         compute_dtype=mix["compute_dtype"])
    scales = {k: v.detach().to(torch.float32).clone().requires_grad_()
              for k, v in get_scales(compressed).items()}
    optimizer = make_optimizer(scales, dcfg)
    step = make_distill_step(serving.model_config(cfg), dcfg, base, fine,
                             compressed, scales, optimizer)

    def run_step(j: int) -> float:
        tokens = torch.as_tensor(batch(ctx.seed, j, b, n, s["vocab"]),
                                 device=dev).long()
        return float(step(tokens))

    start = {k: v.detach().clone() for k, v in scales.items()}
    losses = [run_step(0)]
    beta1 = optimizer.param_groups[0]["betas"][0]
    # AdamW's first moment after one step is (1 - beta1) * gradient; a
    # step that kept no state got none.
    grad1 = {k: optimizer.state[v].get("exp_avg", torch.zeros_like(v))
             .detach() / (1 - beta1) for k, v in scales.items()}
    losses += [run_step(j) for j in range(1, COMPARED_STEPS)]
    change = {k: v.detach() - start[k] for k, v in scales.items()}
    ctx.mark("first steps")

    t0 = time.monotonic()
    setup_s = ctx.setup_s(t0)
    ctx.window = (t0, t0 + ctx.seconds)
    ctx.sample_smi()
    j, profiled = COMPARED_STEPS, 0
    while time.monotonic() < t0 + ctx.seconds:
        if (ctx.probe is not None and not profiled
                and time.monotonic() >= t0 + ctx.seconds / 3):
            # The steps run on a thread of their own: the profiler records
            # host ops of the thread that starts it only, and that
            # recording would slow the steps it measures.
            profiled = mix["profiled_steps"]
            worker = threading.Thread(target=lambda: [
                run_step(j + i) for i in range(profiled)])
            with ctx.probe.profile():
                worker.start()
                worker.join()
            j += profiled
            continue
        run_step(j)
        j += 1
    t_end = time.monotonic()
    ctx.sample_smi()
    steps = j - COMPARED_STEPS
    ctx.read_memory_peak()
    del step, optimizer, scales, compressed, base, fine
    serving.release()

    ref = reference.follow(cfg, ctx.seed, [batch(ctx.seed, i, b, n,
                                                 s["vocab"])
                                           for i in range(COMPARED_STEPS)],
                           dcfg, dev)
    got = reference.gaps({"losses": losses, "grad1": grad1,
                          "change": change}, ref)
    limits = ctx.cell["limits"]
    checks = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": j, "failed": 0,
            "metrics": {"distill_tok_s": steps * b * n / (t_end - t0),
                        "setup_s": setup_s},
            "checks": checks,
            "layer": {"window": (t0, t_end), "steps": steps,
                      "seconds": t_end - t0, "batch": b, "length": n,
                      "tokens_per_step": b * n,
                      "profiled_steps": profiled, "reference": ref,
                      "batches": [batch(ctx.seed, i, b, n, s["vocab"])
                                  for i in range(COMPARED_STEPS)],
                      "dcfg": dcfg}}
