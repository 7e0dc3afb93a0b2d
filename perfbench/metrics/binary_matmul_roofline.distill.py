"""Kernels, rows 5 and 6 in distillation: each projection's forward and
activation gradient at the step's tokens, over the two kernels' device
time."""

from perfbench import layer

MOVES = "distill_tok_s"
UNIT = "%"


def read(ctx, result):
    return layer.distill_binary_roofline(ctx, result)
