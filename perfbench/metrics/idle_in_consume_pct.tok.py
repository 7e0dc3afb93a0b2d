"""Device: the share of the profiled stretch with nothing running on the
card while the stepper applies a chunk's tokens or routes its events to
the clients (``engine.consume`` or ``server.route`` open, no
``engine.dispatch``)."""

from perfbench import program

MOVES = "output_tok_s"
UNIT = "%"


def read(ctx, result):
    return program.idle_pct_in(ctx, ["engine.consume", "server.route"],
                               outside=["engine.dispatch"])
