"""Scheduling: wall milliseconds of the engine's chunk dispatches
(``engine.dispatch``: the lock, the host state and the enqueue of every
decode step) over the steps they ran, in the window outside the
profiled stretch."""

from perfbench import program

MOVES = "output_tok_s"
UNIT = "ms"


def read(ctx, result):
    return program.dispatch_ms_per_step(ctx, result)
