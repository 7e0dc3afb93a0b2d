"""Device: the share of the profiled stretch with nothing running on the
card while the engine dispatches a chunk (``engine.dispatch`` open)."""

from perfbench import program

MOVES = "output_tok_s"
UNIT = "%"


def read(ctx, result):
    return program.idle_pct_in(ctx, ["engine.dispatch"])
