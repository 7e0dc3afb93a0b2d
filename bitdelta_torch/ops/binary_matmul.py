"""Binary (1-bit) delta matmuls — plain PyTorch (port of
``bitdelta_tpu/ops/binary_matmul.py``, the paths JAX leaves to XLA).

``C = scale * (A @ (2*bits(P) - 1))`` with ``P`` the int32-packed sign
matrix ``(K//32, N)``. Unpack to a dense ±1 matrix and multiply; the
hand-written kernels in :mod:`.binary_gemm` are held against these.
"""

from __future__ import annotations

import torch

from .packing import unpack_to_pm1

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and a.dtype in _LOW_PRECISION and b.dtype == a.dtype:
        if b.ndim == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        lead = a.shape[:-1]
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*lead, b.shape[-1])
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class _MatmulF32(torch.autograd.Function):
    """:func:`_mm_f32` with a gradient: torch has no derivative for
    ``mm``/``bmm`` with ``out_dtype``. The backward is XLA's transpose of
    ``preferred_element_type=float32``: the fp32 cotangent times the other
    operand widened to fp32 (exact for bf16 values), cast to the operand's
    dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a if ctx.needs_input_grad[1] else None, b)
        ctx.a_dtype = a.dtype
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.to(torch.float32).transpose(-1, -2)).to(
                ctx.a_dtype)
        if ctx.needs_input_grad[1]:
            af = a.to(torch.float32)
            if b.ndim == 2:
                db = torch.matmul(af.reshape(-1, af.shape[-1]).transpose(0, 1),
                                  g.reshape(-1, g.shape[-1]))
            else:
                db = torch.matmul(af.transpose(-1, -2), g)
            db = db.to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the products of the given operand values summed in
    fp32 and an fp32 result: JAX's ``preferred_element_type=float32``.

    ``a``: ``(..., K)``; ``b``: ``(K, N)`` or batched ``(B, K, N)`` with
    ``a`` ``(B, M, K)``. On the card a bf16/fp16 pair goes to cuBLAS with
    an fp32 output type (no bf16 rounding of the sum), through
    :class:`_MatmulF32` when a gradient is to be taken; elsewhere both
    operands widen to fp32 first, which is exact for bf16 values.
    """
    if (a.is_cuda and a.dtype in _LOW_PRECISION and b.dtype == a.dtype
            and torch.is_grad_enabled()
            and (a.requires_grad or b.requires_grad)):
        return _MatmulF32.apply(a, b)
    return _mm_f32(a, b)


def binary_matmul(x: torch.Tensor, packed: torch.Tensor, scale=1.0, *,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ (scale * sign)``; x ``(..., K)``, packed ``(K//32, N)``.
    Returns ``(..., N)`` in ``x.dtype``, accumulated in fp32."""
    signs = unpack_to_pm1(packed, compute_dtype)
    y = matmul_f32(x.to(compute_dtype), signs)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=y.device)
    return (scale * y).to(x.dtype)


def binary_bmm(x: torch.Tensor, packed: torch.Tensor, scale=1.0, *,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Batched ``x[b] @ (scale[b] * sign[b])``: x ``(B, M, K)``, packed
    ``(B, K//32, N)``, scale ``()`` or ``(B,)``."""
    signs = unpack_to_pm1(packed, compute_dtype)
    y = matmul_f32(x.to(compute_dtype), signs)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=y.device)
    if scale.ndim == 1:
        scale = scale[:, None, None]
    return (scale * y).to(x.dtype)


def tenant_binary_matmul(x: torch.Tensor, packed_stack: torch.Tensor,
                         scales: torch.Tensor, tenant_ids: torch.Tensor, *,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-row tenant-routed delta matmul: row ``b`` of x ``(B, M, K)``
    uses delta ``tenant_ids[b]`` of ``packed_stack`` ``(T, K//32, N)``
    with scale ``scales[tenant_ids[b]]``."""
    packed = packed_stack[tenant_ids]
    scale = scales[tenant_ids]
    return binary_bmm(x, packed, scale, compute_dtype=compute_dtype)
