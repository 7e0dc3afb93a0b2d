"""The quantities the per-layer readers under ``metrics/`` report, from a
traced run's probe (host spans, recorded kernel inputs, the profiler's
trace) and its driver's result. Each returns None where it finds nothing
to read."""

from __future__ import annotations

import statistics
from typing import Optional

import torch

from . import roofline, world

ROW1_KERNELS = ("pair_prep_kernel", "pair_delta_tc_kernel")
ROW2_KERNELS = ("flash_decode_split_kernel", "flash_decode_merge_kernel")
ROW5_KERNELS = ("binary_matmul_kernel", "binary_splits_kernel")
ROW6_KERNELS = ("binary_matmul_t_kernel",)


def _in_window(result, spans):
    t0, t1 = result["layer"]["window"]
    return [s for s in spans if t0 <= s[0] and s[1] <= t1]


def span_ms(ctx, result, name: str, stat: str,
            busy_only: bool = False) -> Optional[float]:
    """Median or mean milliseconds of the harness spans ``name`` in the
    window and outside the profiled stretch (``busy_only``: of pumps
    with an active lane)."""
    spans = _in_window(result, ctx.probe.outside_window(name))
    if busy_only:
        spans = [s for s in spans if s[2]]
    if not spans:
        return None
    ms = [(s[1] - s[0]) * 1e3 for s in spans]
    return statistics.median(ms) if stat == "median" else statistics.fmean(ms)


def lanes_active_mean(ctx, result) -> Optional[float]:
    spans = _in_window(result, ctx.probe.outside_window("pump"))
    lanes = [s[2] for s in spans if s[2]]
    return statistics.fmean(lanes) if lanes else None


def idle_pct(ctx, result) -> Optional[float]:
    tr = ctx.probe.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def decode_step_device_ms(ctx, result) -> Optional[float]:
    """Device time of the kernels that the engine's stepper thread
    launched, over the decode steps run in the profiled stretch. The
    stepper is the host thread that launched flash decode, which only
    decode steps run."""
    steps = len(ctx.probe.calls["step"])
    tr = ctx.probe.trace
    busy = tr.kernel_s(tids=tr.launch_tids(ROW2_KERNELS))
    return busy / steps * 1e3 if steps and busy > 0 else None


def serving_mfu(ctx, result) -> Optional[float]:
    """The dense fine-tune's FLOPs of the window's work over the window's
    seconds at the bf16 peak: every token decoded in the window at its
    context, and every prompt whose first token came in the window."""
    shapes = world.shapes(ctx.cfg)
    t0, t1 = result["layer"]["window"]
    flops = 0.0
    for r in result["layer"]["records"]:
        n = len(r.req["prompt"])
        for i, s in enumerate(r.stamps):
            if t0 <= s < t1:
                flops += (roofline.prefill_flops(shapes, n) if i == 0 else
                          roofline.decode_token_flops(shapes, n + i))
    return (100.0 * flops / ((t1 - t0) * roofline.PEAK_BF16_S)
            if flops else None)


def _live_rows(live, rows: int) -> Optional[torch.Tensor]:
    if live is None:
        return None
    return live.repeat_interleave(rows // live.shape[0])


def pair_delta_roofline(ctx, result) -> Optional[float]:
    """Row 1's least time for the live rows' work over its kernels' time."""
    bound = 0.0
    for c in ctx.probe.calls["row1"]:
        live = _live_rows(c["live"], c["ids"].shape[0])
        if live is None or not bool(live.any()):
            continue
        ids = c["ids"][live]
        b, ops = roofline.pair_delta_work(
            c["k"], c["n"], int(ids.numel()), int(torch.unique(ids).numel()),
            c["x_bytes"])
        bound += roofline.bound_s(b, ops)
    t = ctx.probe.trace.kernel_s(ROW1_KERNELS)
    return 100.0 * bound / t if bound and t else None


def flash_decode_roofline(ctx, result) -> Optional[float]:
    """Row 2's least time for the live lanes' keys over its kernels'
    time."""
    bound = 0.0
    for c in ctx.probe.calls["row2"]:
        live = c["live"]
        if live is None or not bool(live.any()):
            continue
        lengths = c["lengths"][live].to(torch.int64)
        if c["window"]:
            lengths = lengths.clamp(max=c["window"])
        b, ops = roofline.flash_decode_work(
            lengths.tolist(), c["heads"], c["kv_heads"], c["head_dim"],
            c["kv_bytes"], c["q_bytes"])
        bound += roofline.bound_s(b, ops)
    t = ctx.probe.trace.kernel_s(ROW2_KERNELS)
    return 100.0 * bound / t if bound and t else None


def prefill_binary_roofline(ctx, result) -> Optional[float]:
    """Row 5 at single-request prefill: the prompt's own rows (not the
    bucket's padding) over its kernels' time."""
    bound = sum(roofline.bound_s(*roofline.binary_matmul_work(
        c["m"], c["k"], c["n"], c["x_bytes"]))
        for c in ctx.probe.calls["row5"])
    t = ctx.probe.trace.kernel_s(ROW5_KERNELS)
    return 100.0 * bound / t if bound and t else None


def distill_binary_roofline(ctx, result) -> Optional[float]:
    """Rows 5 and 6 in distillation: for each profiled step, each
    projection's forward ``x @ sign`` and its activation gradient ``g @
    sign.T`` at M = batch * length, over the two kernels' time."""
    layer = result["layer"]
    steps = layer.get("profiled_steps", 0)
    if not steps:
        return None
    s = world.shapes(ctx.cfg)
    m = layer["tokens_per_step"]
    bound = 0.0
    for (k, n), _ in world.leaf_specs(ctx.cfg).values():
        bound += roofline.bound_s(*roofline.binary_matmul_work(m, k, n))
        bound += roofline.bound_s(*roofline.binary_matmul_work(m, n, k))
    bound *= steps * s["layers"]
    t = ctx.probe.trace.kernel_s(ROW5_KERNELS + ROW6_KERNELS)
    return 100.0 * bound / t if t else None


def distill_step_device_ms(ctx, result) -> Optional[float]:
    steps = result["layer"].get("profiled_steps", 0)
    busy = ctx.probe.trace.kernel_s()
    return busy / steps * 1e3 if steps and busy > 0 else None


def distill_mfu(ctx, result) -> Optional[float]:
    layer = result["layer"]
    if not layer.get("steps"):
        return None
    flops = layer["steps"] * roofline.distill_step_flops(
        world.shapes(ctx.cfg), layer["batch"], layer["length"])
    return 100.0 * flops / (layer["seconds"] * roofline.PEAK_BF16_S)
