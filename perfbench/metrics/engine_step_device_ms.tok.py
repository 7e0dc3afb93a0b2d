"""Model: device milliseconds of the kernels the engine's stepper thread
launched in the profiled stretch, over the program's own decode steps
(``engine.decode_step`` spans) begun there."""

from perfbench import program

MOVES = "output_tok_s"
UNIT = "ms"


def read(ctx, result):
    return program.engine_step_device_ms(ctx, result)
