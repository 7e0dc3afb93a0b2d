"""Training loop: device milliseconds of the profiled distillation steps
over their number."""

from perfbench import layer

MOVES = "distill_tok_s"
UNIT = "ms"


def read(ctx, result):
    return layer.distill_step_device_ms(ctx, result)
