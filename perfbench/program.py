"""The program's own spans (``bitdelta_torch.utils.profiling.RECORDER``,
taken on the monotonic clock where the work happens), as the per-layer
readers under ``metrics/`` read them: those of the run's window outside
the profiled stretch, those begun in the profiled stretch, and their
union as intervals on the profiler trace's clock beside the device's
idle time. A program without the recorder gives None from every helper
here, and so no metric."""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence, Tuple

from .layer import ROW2_KERNELS
from .trace import merge

Intervals = List[Tuple[float, float]]


def recorder():
    """The program's span recorder, or None where the program has none."""
    from bitdelta_torch.utils import profiling

    return getattr(profiling, "RECORDER", None)


def _spans(name: str) -> Optional[list]:
    """``[(start_s, end_s, span), ...]`` of the recorded spans ``name``,
    in monotonic seconds; None without a recorder."""
    rec = recorder()
    if rec is None:
        return None
    return [(s.start_ns / 1e9, s.end_ns / 1e9, s) for s in rec.spans(name)]


def in_window(ctx, result, name: str) -> list:
    """The spans ``name`` that start in the run's window and do not
    overlap the profiled stretch (the profiler slows the host while it
    records)."""
    t0, t1 = result["layer"]["window"]
    a, b = ctx.probe.window
    return [s for s0, s1, s in _spans(name) or ()
            if t0 <= s0 < t1 and (s1 <= a or s0 >= b)]


def in_stretch(ctx, name: str) -> list:
    """The spans ``name`` begun in the profiled stretch."""
    a, b = ctx.probe.window
    return [s for s0, _, s in _spans(name) or () if a <= s0 < b]


def wall_s(span) -> float:
    return (span.end_ns - span.start_ns) / 1e9


def on_trace(ctx, names: Sequence[str]) -> Intervals:
    """The union of the spans ``names``, moved onto the trace's clock by
    the ``perfbench.window`` range that anchors the harness's own spans,
    within the profiled stretch (trace microseconds)."""
    tr = ctx.probe.trace
    shift = tr.t0 - ctx.probe.window[0] * 1e6
    ivs = []
    for name in names:
        for s0, s1, _ in _spans(name) or ():
            a, b = max(s0 * 1e6 + shift, tr.t0), min(s1 * 1e6 + shift, tr.t1)
            if b > a:
                ivs.append((a, b))
    return merge(ivs)


def idle(tr) -> Intervals:
    """The profiled stretch's intervals with nothing running on the
    card: the complement of ``tr.busy`` within ``[tr.t0, tr.t1]``."""
    edges = [tr.t0] + [x for ab in tr.busy for x in ab] + [tr.t1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def intersect(x: Intervals, y: Intervals) -> Intervals:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(x: Intervals, y: Intervals) -> Intervals:
    """``x`` without ``y``, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > a:
                out.append((a, y[k][0]))
            a = max(a, y[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def idle_pct_in(ctx, inside: Sequence[str],
                outside: Sequence[str] = ()) -> Optional[float]:
    """The share of the profiled stretch with nothing running on the card
    while one of the spans ``inside`` is open and none of ``outside``."""
    tr = ctx.probe.trace
    if tr is None or tr.window_s <= 0 or recorder() is None:
        return None
    region = on_trace(ctx, inside)
    if not region:
        return None
    if outside:
        region = minus(region, on_trace(ctx, outside))
    quiet = intersect(idle(tr), region)
    return 100.0 * sum(b - a for a, b in quiet) / (tr.t1 - tr.t0)


def engine_step_device_ms(ctx, result) -> Optional[float]:
    """Device time of the kernels the engine's stepper launched (the
    thread that launched flash decode) over the program's decode steps
    begun in the profiled stretch."""
    steps = in_stretch(ctx, "engine.decode_step")
    if not steps:
        return None
    tr = ctx.probe.trace
    busy = tr.kernel_s(tids=tr.launch_tids(ROW2_KERNELS))
    return busy / len(steps) * 1e3 if busy > 0 else None


def dispatch_ms_per_step(ctx, result) -> Optional[float]:
    """Wall milliseconds of the window's chunk dispatches over the decode
    steps they ran."""
    spans = in_window(ctx, result, "engine.dispatch")
    steps = sum(s.attrs.get("steps", 0) for s in spans)
    if not steps:
        return None
    return 1e3 * sum(wall_s(s) for s in spans) / steps


def dispatch_cpu_pct(ctx, result) -> Optional[float]:
    """The stepper's CPU time over the wall time of the window's chunk
    dispatches."""
    spans = in_window(ctx, result, "engine.dispatch")
    wall = sum(s.end_ns - s.start_ns for s in spans)
    if not wall:
        return None
    return 100.0 * sum(s.cpu_ns for s in spans) / wall


def submit_ms(ctx, result) -> Optional[float]:
    """Median wall milliseconds of the window's admissions
    (``Engine.submit`` calls that took a slot)."""
    ms = [wall_s(s) * 1e3 for s in in_window(ctx, result, "engine.submit")
          if "bucket" in s.attrs]
    return statistics.median(ms) if ms else None
