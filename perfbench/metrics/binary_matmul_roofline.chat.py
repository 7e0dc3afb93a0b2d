"""Kernels, row 5 at single-request prefill (``binary_matmul``): the
least time of the prompts' own rows over its kernels' device time."""

from perfbench import layer

MOVES = "ttft_p90_ms"
UNIT = "%"


def read(ctx, result):
    return layer.prefill_binary_roofline(ctx, result)
