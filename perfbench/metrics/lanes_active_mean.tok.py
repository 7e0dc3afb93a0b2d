"""Scheduling: the mean number of active slots at each ``Engine.pump``
that had one, over the window outside the profiled stretch."""

from perfbench import layer

MOVES = "output_tok_s"
UNIT = "lanes"


def read(ctx, result):
    return layer.lanes_active_mean(ctx, result)
