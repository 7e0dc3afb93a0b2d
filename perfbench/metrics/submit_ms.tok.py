"""Admission: the median wall milliseconds of the program's admissions
(``engine.submit`` spans that took a slot: the single-request prefill
and its first-token readback), in the window outside the profiled
stretch."""

from perfbench import program

MOVES = "output_tok_s"
UNIT = "ms"


def read(ctx, result):
    return program.submit_ms(ctx, result)
