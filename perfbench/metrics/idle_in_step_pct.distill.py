"""Device: the share of the profiled stretch with nothing running on the
card while a distillation step runs (``distill.step`` open); the rest of
``device_idle_pct.distill`` falls between steps, in the caller."""

from perfbench import program

MOVES = "distill_tok_s"
UNIT = "%"


def read(ctx, result):
    return program.idle_pct_in(ctx, ["distill.step"])
