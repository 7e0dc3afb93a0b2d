"""Kernels, row 2 (``ops/flash_decode.py``): the least time of the live
lanes' keys and values over the device time of its two kernels."""

from perfbench import layer

MOVES = "output_tok_s"
UNIT = "%"


def read(ctx, result):
    return layer.flash_decode_roofline(ctx, result)
