"""Tracing and profiling utilities (port of
``bitdelta_tpu/utils/profiling.py``): the program's span recorder, a
``torch.profiler`` trace of any region written as a Chrome trace, a
rolling step-time / tokens-per-second meter, and the card's allocator
statistics.

``RECORDER`` records host spans where the work happens: the serving
engine's pump, dispatch, decode steps, readback and consume, admissions
and their prefill, the server's routing of events and its waits for a
free slot, each decoder layer's attention and MLP, and the four phases
of a distillation step. A span keeps its name, its start and end on
``time.monotonic_ns()``, the thread, the enclosing span on that thread,
its attributes (``request_id`` where it serves one request) and, for the
engine's chunk dispatch alone, the thread's CPU time over it. The last ``SPAN_CAPACITY`` spans are kept;
``RECORDER.totals`` counts admissions, prompt and padded tokens, decode
steps and rows, tokens produced and slot waits, and the serving API's
``/stats`` returns them. The recorder is on from import;
``RECORDER.enabled = False`` turns it off, and a span then costs one
attribute test. :func:`trace` writes the spans recorded during its
region into its Chrome trace on the kernels' clock, so ``train
--profile_dir`` shows what the host was doing under every idle gap.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# Host time traced before and after the region: the H100's profiler drops
# device records that land near the edges of its window.
TRACE_PAD_S = 0.01
# Spans kept: Mistral-7B serving 64 lanes records about 450 a second.
SPAN_CAPACITY = 1 << 17
# The profiler ranges that anchor the spans to the trace's clock: the
# tightest of a few, each with a monotonic reading inside it.
CLOCK_RANGE = "bitdelta.clock"
CLOCK_READS = 5
SPAN_PROCESS = "bitdelta spans"


class Span:
    """One span: ``name``, ``start_ns`` / ``end_ns`` (monotonic),
    ``cpu_ns`` (the thread's CPU time over it, for a span opened with
    ``cpu=True``; None otherwise), ``tid`` / ``thread``, ``parent`` (the
    enclosing span on the same thread, or None) and ``attrs``. A context
    manager that yields itself, so attributes known only at its end can
    be :meth:`set` on it."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "cpu_ns", "tid",
                 "thread", "parent", "_recorder", "_stack")

    def __init__(self, recorder: "Recorder", name: str, attrs: dict,
                 cpu: bool):
        self.name = name
        self.attrs = attrs
        self.cpu_ns = 0 if cpu else None
        self._recorder = recorder

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        local = self._recorder._thread()
        self.tid, self.thread = local.tid, local.name
        self._stack = local.stack
        self.parent = self._stack[-1] if self._stack else None
        self._stack.append(self)
        self.end_ns = None
        if self.cpu_ns is not None:
            self.cpu_ns = time.thread_time_ns()
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.monotonic_ns()
        if self.cpu_ns is not None:
            self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        self._stack.pop()
        self._stack = None
        self._recorder._keep(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}..{self.end_ns}, "
                f"{self.attrs})")


class _NoSpan:
    """What :meth:`Recorder.span` returns while the recorder is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class Recorder:
    """Host spans in a ring of ``capacity`` (``dropped`` counts those it
    let go) and cumulative counters in ``totals``. Thread-safe; spans nest
    per thread."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.enabled = True
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.totals: Dict[str, int] = {}
        self._mu = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, cpu: bool = False, **attrs):
        """A context manager that records the region as span ``name``;
        with ``cpu`` it also takes the thread's CPU time over it. That
        clock is a system call, which has cost hundreds of microseconds
        on a host busy driving the card, so only spans few and long
        enough to pay for it take it."""
        if not self.enabled:
            return _NO_SPAN
        return Span(self, name, attrs, cpu)

    def count(self, counter: str, n: int = 1) -> None:
        """Add ``n`` to ``totals[counter]``."""
        if not self.enabled:
            return
        with self._mu:
            self.totals[counter] = self.totals.get(counter, 0) + int(n)

    def spans(self, name: Optional[str] = None, since_ns: int = 0,
              until_ns: Optional[int] = None) -> List[Span]:
        """The kept spans of ``name`` (all without one) that started at or
        after ``since_ns`` and ended by ``until_ns``, oldest first."""
        with self._mu:
            kept = list(self._ring)
        return [s for s in kept
                if (name is None or s.name == name) and s.start_ns >= since_ns
                and (until_ns is None or s.end_ns <= until_ns)]

    def _thread(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack = []
            local.tid = threading.get_native_id()
            local.name = threading.current_thread().name
        return local

    def _keep(self, span: Span) -> None:
        with self._mu:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)


RECORDER = Recorder()


def _span_events(spans: List[Span], shift_us: float,
                 pids: set) -> List[dict]:
    """Chrome ``"X"`` events of ``spans`` (monotonic ns, moved by
    ``shift_us`` onto the trace's clock) in a process row of their own
    named ``SPAN_PROCESS``, one row a thread."""
    pid = 1 + max([p for p in pids if isinstance(p, int)] + [0])
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": SPAN_PROCESS}}]
    for tid, thread in sorted({(s.tid, s.thread) for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": thread}})
    for s in spans:
        args = dict(s.attrs)
        if s.cpu_ns is not None:
            args["cpu_ms"] = s.cpu_ns / 1e6
        if s.parent is not None:
            args["parent"] = s.parent.name
        events.append({"ph": "X", "cat": "bitdelta", "name": s.name,
                       "pid": pid, "tid": s.tid,
                       "ts": s.start_ns / 1e3 + shift_us,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return events


@contextlib.contextmanager
def trace(log_dir: str = "bitdelta_trace"):
    """Trace the region (CPU, and CUDA where a card is present) with
    ``torch.profiler`` and write ``log_dir/trace.json`` (open it in
    Perfetto or ``chrome://tracing``), with the program's spans recorded
    during the region on the trace's clock in a process row of their own
    (``bitdelta spans``). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    since_ns = time.monotonic_ns()
    anchors = []
    with profile(activities=activities) as prof:
        for _ in range(CLOCK_READS):
            with record_function(CLOCK_RANGE):
                anchors.append(time.monotonic_ns())
        time.sleep(TRACE_PAD_S)
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    spans = RECORDER.spans(since_ns=since_ns)
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    # A reading lies inside its range: the shortest range (the first pays
    # the profiler's set-up) places it best, at the range's middle.
    clocks = sorted((e for e in events if e.get("name") == CLOCK_RANGE
                     and e.get("ph") == "X"), key=lambda e: e["ts"])
    clock, anchor_ns = min(zip(clocks, anchors), key=lambda ca: ca[0]["dur"])
    shift_us = clock["ts"] + clock["dur"] / 2 - anchor_ns / 1e3
    events += _span_events(spans, shift_us, {e.get("pid") for e in events})
    with open(path, "w") as f:
        json.dump(doc, f)


class StepTimer:
    """Rolling step-time / tokens-per-second meter over the last
    ``window`` entries; an entry may cover several steps.

    >>> timer = StepTimer()
    >>> with timer.step(tokens=batch_tokens): run_step()
    >>> timer.summary()
    """

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list = []
        self.tokens: list = []
        self.steps: list = []

    class _Tick:
        """Mutable token count for regions whose token yield is only known
        after the device call (a chunked decode that a stop truncates)."""
        __slots__ = ("tokens",)

        def __init__(self, tokens: int):
            self.tokens = tokens

    def add(self, seconds: float, tokens: int, steps: int = 1) -> None:
        """Record ``steps`` steps timed elsewhere (the engine feeds each
        pump that read back a decode chunk: its wall time, the chunk's
        tokens and its steps)."""
        self.times.append(seconds)
        self.tokens.append(tokens)
        self.steps.append(steps)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.tokens.pop(0)
            self.steps.pop(0)

    @contextlib.contextmanager
    def step(self, tokens: int = 0):
        tick = StepTimer._Tick(tokens)
        t0 = time.perf_counter()
        yield tick
        self.add(time.perf_counter() - t0, tick.tokens)

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / max(sum(self.steps), 1)

    @property
    def tokens_per_sec(self) -> float:
        total_t = sum(self.times)
        return sum(self.tokens) / total_t if total_t > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {"mean_step_time_s": self.mean_step_time,
                "tokens_per_sec": self.tokens_per_sec,
                "steps_measured": sum(self.steps)}


def device_memory_stats(device=None) -> Optional[Dict[str, float]]:
    """The card's allocator statistics (``torch.cuda.memory_stats``:
    allocated, reserved and peak bytes, ...); None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    if not stats:
        return None
    return {k: float(v) for k, v in stats.items()
            if isinstance(v, (int, float))}
