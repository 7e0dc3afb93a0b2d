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
from ..parallel.collectives import axis_size, psum
from ..parallel.mesh import MODEL_AXIS


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
                   zero_sign: str = "positive", mesh=None) -> BinaryDelta:
    """Quantize ``finetune - base`` (``(K, N)`` or stacked ``(L, K, N)``)
    to packed signs + an fp32 ``mean(|diff|)`` scale per matrix.

    ``mesh``: the matrices are this rank's equal shards of matrices split
    over the model axis; the signs packed are the shard's own and the
    scale the whole matrix's (the shards' means summed over the axis)."""
    diff = finetune.to(torch.float32) - base.to(torch.float32)
    tp = axis_size(mesh, MODEL_AXIS)
    if tp > 1 and zero_sign == "balance" and (diff.shape[-2] % 2
                                              or diff.shape[-1] % 2):
        # The checkerboard's parity follows the shard's own indices.
        raise ValueError(f"zero_sign='balance' needs even shards, got "
                         f"{tuple(diff.shape)}")
    scale = psum(diff.abs().mean(dim=(-2, -1)), mesh) / tp
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


def apply_delta(base: torch.Tensor, delta: BinaryDelta) -> torch.Tensor:
    """Dense fusion ``W_base + scale * sign`` in fp32, cast to the base's
    dtype (the evaluation path of ``fuse_compressed``)."""
    fused = base.to(torch.float32) + dequantize_delta(delta, torch.float32)
    return fused.to(base.dtype)


def delta_nbytes(delta: BinaryDelta) -> int:
    """Bytes of a compressed delta (packed words + scales)."""
    return delta.packed.numel() * 4 + delta.scale.numel() * 4


def compression_ratio(base: torch.Tensor, delta: BinaryDelta,
                      dense_bytes_per_el: int = 2) -> float:
    """Dense-delta bytes over packed-delta bytes."""
    return base.numel() * dense_bytes_per_el / delta_nbytes(delta)


def delta_linear(x: torch.Tensor, base_w: torch.Tensor, delta: BinaryDelta,
                 *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Compressed linear layer ``x @ W_base + scale * (x @ sign)``."""
    from ..ops.binary_matmul import binary_matmul, matmul_f32

    y_base = matmul_f32(x.to(compute_dtype), base_w.to(compute_dtype))
    y_delta = binary_matmul(x, delta.packed, delta.scale,
                            compute_dtype=compute_dtype).to(torch.float32)
    return (y_base + y_delta).to(x.dtype)
