"""Whole step: the dense fine-tune's FLOPs of the window's prefills and
decoded tokens over the window at the bf16 peak (989 TFLOP/s)."""

from perfbench import layer

MOVES = "output_tok_s"
UNIT = "%"


def read(ctx, result):
    return layer.serving_mfu(ctx, result)
