"""Device: the share of the profiled stretch with nothing running on the
card."""

from perfbench import layer

MOVES = "output_tok_s"
UNIT = "%"


def read(ctx, result):
    return layer.idle_pct(ctx, result)
