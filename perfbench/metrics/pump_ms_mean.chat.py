"""Scheduling: the mean wall milliseconds of one ``Engine.pump`` with an
active lane, over the window outside the profiled stretch."""

from perfbench import layer

MOVES = "tpot_p90_ms"
UNIT = "ms"


def read(ctx, result):
    return layer.span_ms(ctx, result, "pump", "mean", busy_only=True)
