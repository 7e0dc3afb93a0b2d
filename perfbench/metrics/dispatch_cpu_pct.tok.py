"""Scheduling: the stepper thread's CPU time over the wall time of its
chunk dispatches (``engine.dispatch``), in the window outside the
profiled stretch. Near 100: Python enqueue work; far below: the stepper
waited (the interpreter lock, the engine lock, a hidden sync)."""

from perfbench import program

MOVES = "output_tok_s"
UNIT = "%"


def read(ctx, result):
    return program.dispatch_cpu_pct(ctx, result)
