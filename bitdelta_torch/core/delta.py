"""1-bit delta quantization core (port of ``bitdelta_tpu/core/delta.py``).

A fine-tuned weight is ``W_fine = W_base + delta``; the delta is stored
as ``scale * sign(delta)`` with ``scale = mean(|delta|)`` in fp32 and the
signs bit-packed along K. Weights are ``(K_in, N_out)`` (``y = x @ W``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.packing import (column_popcount, pack_signs, repack_pairs,
                           unpack_to_pm1)


class BinaryDelta(NamedTuple):
    """packed: int32 ``(*, K//32, N)`` sign bits; scale: fp32 ``(*,)``."""

    packed: torch.Tensor
    scale: torch.Tensor

    @property
    def k(self) -> int:
        return self.packed.shape[-2] * 32

    @property
    def n(self) -> int:
        return self.packed.shape[-1]


class PairedBinaryDelta(NamedTuple):
    """Serving layout for the pair decode kernel.

    packed_pairs: int32 ``(*, K//16, N//2)`` (ops/packing.py::repack_pairs);
    colsum: fp32 ``(*, N)`` = ``2*popcount - K`` per column;
    scale: fp32 ``(*,)``.
    """

    packed_pairs: torch.Tensor
    colsum: torch.Tensor
    scale: torch.Tensor


def pair_delta(delta: BinaryDelta) -> PairedBinaryDelta:
    """Canonical delta (any leading stack dims) -> pair layout."""
    k = delta.packed.shape[-2] * 32
    colsum = (2.0 * column_popcount(delta.packed) - k).to(torch.float32)
    return PairedBinaryDelta(packed_pairs=repack_pairs(delta.packed),
                             colsum=colsum,
                             scale=delta.scale.to(torch.float32))


def delta_signs(diff: torch.Tensor, zero_sign: str = "positive"
                ) -> torch.Tensor:
    """Boolean sign plane of a dense fp32 diff. ``"positive"``: reference
    parity, ``diff >= 0`` -> +1. ``"balance"``: exact zeros take a (k+n)
    checkerboard instead."""
    if zero_sign == "balance":
        k, n = diff.shape[-2], diff.shape[-1]
        ar_k = torch.arange(k, device=diff.device)
        ar_n = torch.arange(n, device=diff.device)
        checker = ((ar_k[:, None] + ar_n[None, :]) % 2) == 0
        return torch.where(diff == 0, checker, diff > 0)
    if zero_sign == "positive":
        return diff >= 0
    raise ValueError(f"unknown zero_sign: {zero_sign!r}")


def quantize_delta(base: torch.Tensor, finetune: torch.Tensor, *,
                   zero_sign: str = "positive") -> BinaryDelta:
    """Quantize ``finetune - base`` (``(K, N)`` or stacked ``(L, K, N)``)
    to packed signs + an fp32 ``mean(|diff|)`` scale per matrix."""
    diff = finetune.to(torch.float32) - base.to(torch.float32)
    scale = diff.abs().mean(dim=(-2, -1))
    return BinaryDelta(packed=pack_signs(delta_signs(diff, zero_sign)),
                       scale=scale)


def dequantize_delta(delta: BinaryDelta, dtype=torch.float32
                     ) -> torch.Tensor:
    """The dense ``scale * sign`` matrix ``(*, K, N)``."""
    pm1 = unpack_to_pm1(delta.packed, torch.float32)
    scale = delta.scale.to(torch.float32)
    if scale.ndim:
        scale = scale[..., None, None]
    return (scale * pm1).to(dtype)


def delta_linear(x: torch.Tensor, base_w: torch.Tensor, delta: BinaryDelta,
                 *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Compressed linear layer ``x @ W_base + scale * (x @ sign)``."""
    from ..ops.binary_matmul import binary_matmul, matmul_f32

    y_base = matmul_f32(x.to(compute_dtype), base_w.to(compute_dtype))
    y_delta = binary_matmul(x, delta.packed, delta.scale,
                            compute_dtype=compute_dtype).to(torch.float32)
    return (y_base + y_delta).to(x.dtype)
