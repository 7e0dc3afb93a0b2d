"""Tracing and profiling utilities (port of
``bitdelta_tpu/utils/profiling.py``): a ``torch.profiler`` trace of any
region written as a Chrome trace, a rolling step-time / tokens-per-second
meter, and the card's allocator statistics."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

# Host time traced before and after the region: the H100's profiler drops
# device records that land near the edges of its window.
TRACE_PAD_S = 0.01


@contextlib.contextmanager
def trace(log_dir: str = "bitdelta_trace"):
    """Trace the region (CPU, and CUDA where a card is present) with
    ``torch.profiler`` and write ``log_dir/trace.json`` (open it in
    Perfetto or ``chrome://tracing``). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(TRACE_PAD_S)
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time / tokens-per-second meter.

    >>> timer = StepTimer()
    >>> with timer.step(tokens=batch_tokens): run_step()
    >>> timer.summary()
    """

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list = []
        self.tokens: list = []

    class _Tick:
        """Mutable token count for regions whose token yield is only known
        after the device call (a chunked decode that a stop truncates)."""
        __slots__ = ("tokens",)

        def __init__(self, tokens: int):
            self.tokens = tokens

    def add(self, seconds: float, tokens: int) -> None:
        """Record one step timed elsewhere (the engine times each decode
        chunk around its readback)."""
        self.times.append(seconds)
        self.tokens.append(tokens)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.tokens.pop(0)

    @contextlib.contextmanager
    def step(self, tokens: int = 0):
        tick = StepTimer._Tick(tokens)
        t0 = time.perf_counter()
        yield tick
        self.add(time.perf_counter() - t0, tick.tokens)

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def tokens_per_sec(self) -> float:
        total_t = sum(self.times)
        return sum(self.tokens) / total_t if total_t > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {"mean_step_time_s": self.mean_step_time,
                "tokens_per_sec": self.tokens_per_sec,
                "steps_measured": len(self.times)}


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
