"""The W4 base matmul at decode (port of ``w4_matmul_pallas``,
``bitdelta_tpu/ops/pallas_int4.py``): ``x @ deq(Int4Weight)`` with the
packed words streamed and unpacked in the kernel, so no dense operand
exists in device memory.

:func:`w4_matmul` launches ``csrc/int4_gemm.cu`` on a CUDA tensor and
takes :func:`w4_matmul_plain` on a CPU tensor; launches are counted in
``w4_matmul.launches``. The kernel is chosen by x's dtype before the
launch: bf16 x runs ``w4_matmul_tc_kernel`` (nibbles turned into bf16 in
registers, fed to the tensor cores), fp32 x ``w4_matmul_fp32_kernel`` (on
the CUDA cores).
"""

from __future__ import annotations

import torch

from . import _build
from ._build import I, P

_LIB = "int4_gemm"
_GROUP = 128          # K rows per scale group the kernel takes
_BLOCK_N = 128        # columns per block of either kernel
_TARGET_BLOCKS = 528  # four blocks on each of the H100's 132 SMs
MAX_M = 64


def w4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version (fp32 out): ``int4_matmul``'s arithmetic with x's
    dtype as the compute dtype, as the TPU kernel unpacks to x's dtype."""
    from ..research.quantized_base import Int4Weight, int4_matmul

    return int4_matmul(x, Int4Weight(packed, scale), compute_dtype=x.dtype,
                       out_dtype=torch.float32)


def _splits(n: int, n_groups: int) -> int:
    """K ranges (of whole groups) per column tile, so that the grid holds
    at most _TARGET_BLOCKS blocks: one wave, with no second wave of a few
    blocks (rounding up ran row 8's bf16 kernel 17% slower a layer on the
    H100, PERF.md)."""
    tiles = -(-n // _BLOCK_N)
    return max(1, min(n_groups, _TARGET_BLOCKS // tiles))


def w4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              *, out_dtype=None) -> torch.Tensor:
    """``x @ deq(Int4Weight(packed, scale))``: x ``(M, K)`` bf16 or fp32
    with M <= 64; packed ``(K//8, N)`` int32; scale ``(K//128, N)`` fp32.
    Returns ``(M, N)`` in ``out_dtype`` (default x.dtype), summed in
    fp32."""
    out_dtype = out_dtype or x.dtype
    m, kdim = x.shape
    k8, n = packed.shape
    if k8 * 8 != kdim or kdim % _GROUP:
        raise ValueError(f"x {tuple(x.shape)} vs packed "
                         f"{tuple(packed.shape)} (K must be a multiple of "
                         f"{_GROUP})")
    if tuple(scale.shape) != (kdim // _GROUP, n):
        raise ValueError(f"scale {tuple(scale.shape)} != "
                         f"{(kdim // _GROUP, n)}: the kernel takes "
                         f"{_GROUP}-row groups")
    if not x.is_cuda:
        return w4_matmul_plain(x, packed, scale).to(out_dtype)
    if m > MAX_M:
        raise ValueError(f"M={m} > {MAX_M}: the kernel is for decode rows")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or fp32 x, got {x.dtype}")
    if packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError("packed must be int32 and scale fp32")
    xc = _build.aligned16(x)          # the bf16 kernel copies 16 bytes
    pc = packed.contiguous()
    sc = scale.contiguous()
    n_split = _splits(n, kdim // _GROUP)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = (torch.empty((n_split, m, n), dtype=torch.float32,
                        device=x.device) if n_split > 1 else out)
    _build.launch(_LIB, "bd_w4_matmul", [P] * 5 + [I] * 5 + [P],
                  _build.ptr(xc), _build.ptr(pc), _build.ptr(sc),
                  _build.ptr(part), _build.ptr(out), m, kdim, n, n_split,
                  int(x.dtype == torch.bfloat16), _build.stream(x.device))
    w4_matmul.launches += 1
    return out.to(out_dtype)


w4_matmul.launches = 0
