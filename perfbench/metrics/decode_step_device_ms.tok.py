"""Model: device milliseconds of the kernels launched inside
``Engine.pump`` over the decode steps in the profiled stretch."""

from perfbench import layer

MOVES = "output_tok_s"
UNIT = "ms"


def read(ctx, result):
    return layer.decode_step_device_ms(ctx, result)
