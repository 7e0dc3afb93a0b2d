"""Admission: the median wall milliseconds of ``Engine.submit`` (the
single-request prefill and its first-token readback) as ``ServingApp``
calls it, over the window outside the profiled stretch."""

from perfbench import layer

MOVES = "ttft_p90_ms"
UNIT = "ms"


def read(ctx, result):
    return layer.span_ms(ctx, result, "submit", "median")
