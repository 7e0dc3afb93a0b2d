"""Whole step: teacher forward, student forward and the student's
backward to its activations, of the window's steps, over the window at
the bf16 peak (989 TFLOP/s)."""

from perfbench import layer

MOVES = "distill_tok_s"
UNIT = "%"


def read(ctx, result):
    return layer.distill_mfu(ctx, result)
