"""Harness wrappers around the program's calls, installed only under
``--trace 1``: host spans of ``Engine.submit`` and ``Engine.pump`` (with
the host thread that ran them), and records of the inputs of the
measured kernels' wrappers (row 1's pair delta, row 2's flash decode,
row 5's binary matmul) and of each decode step's live lanes, taken while
the profiler's window is open."""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

from .trace import WINDOW, Trace, load


class Probe:
    def __init__(self):
        self.spans: Dict[str, List[tuple]] = defaultdict(list)
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.recording = False
        self.live = None            # the live-lane mask of the current step
        self.window = (0.0, 0.0)    # host times of the profiled window
        self.trace: Trace = None
        self._prof = None
        self._undo: List[Callable] = []
        self._mu = threading.Lock()
        self.local = threading.local()   # ``info`` of this thread's span

    # -- installing -----------------------------------------------------
    def _patch(self, owner, attr: str, wrapper) -> None:
        orig = getattr(owner, attr)
        in_dict = attr in vars(owner)
        functools.update_wrapper(wrapper, orig)
        setattr(owner, attr, wrapper)
        self._undo.append(lambda: setattr(owner, attr, orig) if in_dict
                          else delattr(owner, attr))

    def span(self, owner, attr: str, name: str, extra=None) -> None:
        """Time every call of ``owner.attr`` on the host; ``extra(owner,
        *args)`` is read just before the call, kept with its span and left
        in ``self.local.info`` for the calls made inside it."""
        orig = getattr(owner, attr)

        def wrapper(*a, **kw):
            info = extra(owner, *a) if extra else None
            self.local.info = info
            t0 = time.monotonic()
            try:
                return orig(*a, **kw)
            finally:
                with self._mu:
                    self.spans[name].append((t0, time.monotonic(), info))
        self._patch(owner, attr, wrapper)

    def record(self, owner, attr: str, name: str, fields) -> None:
        """While recording, keep ``fields(*args, **kwargs)`` of each call
        of ``owner.attr`` (with the current live-lane mask)."""
        orig = getattr(owner, attr)

        def wrapper(*a, **kw):
            if self.recording:
                rec = fields(*a, **kw)
                rec["live"] = self.live
                self.calls[name].append(rec)
            return orig(*a, **kw)
        self._patch(owner, attr, wrapper)

    def steps(self, engine) -> None:
        """Each decode step starts with ``Engine._parked(live, probe)``;
        a False answer means the step runs with that live mask."""
        orig = engine._parked

        def wrapper(live, probe):
            parked = orig(live, probe)
            if not parked:
                self.live = live
                if self.recording:
                    self.calls["step"].append({"live": live})
            return parked
        self._patch(engine, "_parked", wrapper)

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    # -- the profiled window ---------------------------------------------
    @contextlib.contextmanager
    def profile(self):
        """Profile the body (CPU and CUDA activity) inside a
        ``perfbench.window`` range and record the wrappers' inputs
        meanwhile. The trace is reduced later (:meth:`reduce`), once the
        run's window has closed: exporting and reading it holds the
        interpreter lock for seconds."""
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if cuda else [])
        with profile(activities=activities) as prof:
            time.sleep(0.01)
            with torch.profiler.record_function(WINDOW):
                t0 = time.monotonic()
                self.recording = True
                try:
                    yield
                finally:
                    self.recording = False
                    if cuda:
                        torch.cuda.synchronize()
                    self.window = (t0, time.monotonic())
            time.sleep(0.01)
        self._prof = prof

    def reduce(self) -> Trace:
        """The profiled stretch's trace (written under TMPDIR, read, and
        deleted)."""
        if self.trace is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                self.trace = load(path, self.spans, self.window[0])
            finally:
                os.remove(path)
            self._prof = None
        return self.trace

    def outside_window(self, name: str) -> List[tuple]:
        """Spans of ``name`` that do not overlap the profiled window (the
        profiler slows the host while it records)."""
        a, b = self.window
        return [s for s in self.spans[name] if s[1] <= a or s[0] >= b]
