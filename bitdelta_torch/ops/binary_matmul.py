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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the products of the given operand values summed in
    fp32 and an fp32 result: JAX's ``preferred_element_type=float32``.

    ``a``: ``(..., K)``; ``b``: ``(K, N)`` or batched ``(B, K, N)`` with
    ``a`` ``(B, M, K)``. On the card a bf16/fp16 pair goes to cuBLAS with
    an fp32 output type (no bf16 rounding of the sum); elsewhere both
    operands widen to fp32 first, which is exact for bf16 values.
    """
    if a.is_cuda and a.dtype in _LOW_PRECISION and b.dtype == a.dtype:
        if b.ndim == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        lead = a.shape[:-1]
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*lead, b.shape[-1])
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


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
