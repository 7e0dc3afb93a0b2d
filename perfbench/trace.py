"""Reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics and the ``breakdown`` read: the device's busy time within the
profiled window, each kernel's time, the host thread that launched it,
and the idle gaps labelled by the harness's host spans open during them.

The profiler records host ranges of the thread that started it only, so
the harness's spans on other threads (the engine's stepper, the clients)
are its own monotonic timestamps, placed on the trace's clock by the
``perfbench.window`` range that the profiling thread opens."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covers(intervals: List[Tuple[float, float]], t: float) -> bool:
    """True when one of the sorted, disjoint ``intervals`` holds ``t``."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


class Trace:
    """Device activity within the ``perfbench.window`` range. Trace times
    are microseconds; results are seconds. ``spans``: ``{name: [(start,
    end), ...]}`` in monotonic seconds, ``t0``: the monotonic time at which
    the window range opened."""

    def __init__(self, events: List[dict],
                 spans: Optional[Dict[str, Iterable[tuple]]] = None,
                 t0: float = 0.0):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        if not win:
            raise ValueError("trace has no perfbench.window range")
        self.t0 = win[0]["ts"]
        self.t1 = self.t0 + win[0]["dur"]
        self._launch_tid: Dict[object, object] = {}
        self.kernels: List[Tuple[str, float, float, object]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                self._launch_tid[corr] = e.get("tid")
            elif e.get("cat") in DEVICE_CATS:
                a = max(e["ts"], self.t0)
                b = min(e["ts"] + e["dur"], self.t1)
                if b > a:
                    self.kernels.append((e["name"], a, b, corr))
        self.busy = merge([(a, b) for _, a, b, _ in self.kernels])
        shift = self.t0 - t0 * 1e6
        self.spans = {name: merge([(a * 1e6 + shift, b * 1e6 + shift)
                                   for a, b, *_ in ss])
                      for name, ss in (spans or {}).items()}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_s(self, names=(), tids=None) -> float:
        """Seconds of the device entries whose name contains one of
        ``names`` (all when empty) and, with ``tids``, whose launch came
        from one of those host threads."""
        total = 0.0
        for name, a, b, corr in self.kernels:
            if names and not any(n in name for n in names):
                continue
            if tids is not None and self._launch_tid.get(corr) not in tids:
                continue
            total += b - a
        return total / 1e6

    def launch_tids(self, names) -> set:
        """The host threads that launched the device entries whose name
        contains one of ``names``."""
        return {self._launch_tid.get(corr) for name, _, _, corr
                in self.kernels if any(n in name for n in names)} - {None}

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, a, b, _ in self.kernels:
            by[name[:120]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time within the window, summed by the harness spans
        open at each gap's midpoint."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        by: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            open_ = [name for name, iv in sorted(self.spans.items())
                     if _covers(iv, mid)]
            by["+".join(open_) or "no harness span"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


def load(path: str, spans=None, t0: float = 0.0) -> Trace:
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"], spans, t0)
