"""Scheduling: the mean wall milliseconds of one ``Engine.pump`` (one
decode chunk dispatched, the previous one read back) with an active
lane, over the window outside the profiled stretch."""

from perfbench import layer

MOVES = "output_tok_s"
UNIT = "ms"


def read(ctx, result):
    return layer.span_ms(ctx, result, "pump", "mean", busy_only=True)
