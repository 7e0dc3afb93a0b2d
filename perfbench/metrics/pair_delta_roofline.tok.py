"""Kernels, row 1 (``ops/binary_gemm.py::tenant_delta_matmul_pair``):
the least time of the live rows' work (each distinct routed matrix's
words once) over the device time of its two kernels."""

from perfbench import layer

MOVES = "output_tok_s"
UNIT = "%"


def read(ctx, result):
    return layer.pair_delta_roofline(ctx, result)
