"""1-bit delta GEMM kernels for the serving path, each beside its plain
PyTorch version (port of three kernels of
``bitdelta_tpu/ops/pallas_binary_gemm.py``):

* :func:`tenant_delta_matmul_pair` — decode, every projection's delta
  (``tenant_delta_matmul_pair_pallas``);
* :func:`tenant_dense_matmul` — decode, the per-tenant lm_head
  (``tenant_dense_matmul_pallas``);
* :func:`binary_matmul` — the single-request prefill delta
  (``binary_matmul_pallas``).

Each wrapper picks by the device of its input: a CPU tensor takes the
plain version (``*_plain``); a CUDA tensor launches the hand-written
kernel of ``csrc/binary_gemm.cu`` or raises. Each wrapper counts its
launches in ``<wrapper>.launches``. The kernel sources say what bounds
each kernel on the H100 and what its design does about it.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import I, P
from .packing import PAIR_BLOCK, _u32

PAIR_Q_LEVELS = 4095   # 12-bit grid: 16 * 4095 = 65520 < 2^16 (no carry)
_LIB = "binary_gemm"


def _cuda_dtype_flag(t: torch.Tensor) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"kernel takes bf16 or fp32, got {t.dtype}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# Pair-packed tenant delta (decode)
# ---------------------------------------------------------------------------

def _pair_quantize(x: torch.Tensor, scales: torch.Tensor,
                   tenant_ids: torch.Tensor):
    """Quantize rows to the non-negative PAIR_Q_LEVELS affine grid and
    fold the tenant scale into the two dequantization coefficients (plain
    torch, as JAX runs it in XLA; ``torch.round`` is half-to-even like
    ``jnp.round``). Returns ``(xq (B, K) int32, sxq (B,), a1 (B,),
    a2 (B,))`` with ``a1 = alpha * step``, ``a2 = alpha * xmin``."""
    xf = x.to(torch.float32)
    xmin = xf.min(dim=1).values
    xmax = xf.max(dim=1).values
    step = torch.clamp((xmax - xmin) / PAIR_Q_LEVELS, min=1e-30)
    xq = torch.round((xf - xmin[:, None]) / step[:, None]).to(torch.int32)
    sxq = xq.sum(dim=1).to(torch.float32)
    alpha = scales.to(torch.float32)[tenant_ids]
    return xq, sxq, alpha * step, alpha * xmin


def _colsum_to_pair_order(colsum: torch.Tensor) -> torch.Tensor:
    """``(R, N)`` -> ``(R, 2, N//2)``: ``[r, h, g*128 + i] =
    colsum[r, g*256 + 128*h + i]`` (the pair layout's lo/hi halves)."""
    r, n = colsum.shape
    return (colsum.reshape(r, n // PAIR_BLOCK, 2, PAIR_BLOCK // 2)
            .transpose(1, 2).reshape(r, 2, n // 2))


def _pair_reassemble(y_lo: torch.Tensor, y_hi: torch.Tensor) -> torch.Tensor:
    """Interleave lo/hi half outputs ``(B, N//2)`` back into natural
    column order (group g's low half, then its high half)."""
    bsz, nh = y_lo.shape
    nblk = nh * 2 // PAIR_BLOCK
    return torch.stack([y_lo.reshape(bsz, nblk, PAIR_BLOCK // 2),
                        y_hi.reshape(bsz, nblk, PAIR_BLOCK // 2)],
                       dim=2).reshape(bsz, nh * 2)


def tenant_delta_matmul_pair_plain(x, packed_pairs, colsum, scales,
                                   tenant_ids):
    """Plain version of :func:`tenant_delta_matmul_pair` (fp32 out): the
    same integer bit-plane sums over pair words, in int64, and the same
    fp32 epilogue, reassembled in natural column order."""
    bsz, kdim = x.shape
    xq, sxq, a1, a2 = _pair_quantize(x, scales, tenant_ids)
    xq = xq.to(torch.int64).reshape(bsz, kdim // 16, 16)
    u = _u32(packed_pairs[tenant_ids])                  # (B, K/16, N/2)
    inner = torch.zeros_like(u)
    for s in range(16):
        inner += ((u >> s) & 0x00010001) * xq[:, :, s, None]
    s_lo = (inner & 0xFFFF).sum(dim=1).to(torch.float32)
    s_hi = (inner >> 16).sum(dim=1).to(torch.float32)
    c2 = _colsum_to_pair_order(colsum.to(torch.float32)[tenant_ids])
    two_a1 = (2.0 * a1)[:, None]
    off = (a1 * sxq)[:, None]
    y_lo = two_a1 * s_lo + (a2[:, None] * c2[:, 0] - off)
    y_hi = two_a1 * s_hi + (a2[:, None] * c2[:, 1] - off)
    return _pair_reassemble(y_lo, y_hi)


def tenant_delta_matmul_pair(x: torch.Tensor, packed_pairs: torch.Tensor,
                             colsum: torch.Tensor, scales: torch.Tensor,
                             tenant_ids: torch.Tensor, *, out_dtype=None
                             ) -> torch.Tensor:
    """``Y[b] = scales[ids[b]] * (x[b] @ sign(P[ids[b]]))`` at decode,
    pair-packed layout. x ``(B, K)``; packed_pairs ``(T, K//16, N//2)``;
    colsum ``(T, N)`` fp32 = 2*popcount - K; scales ``(T,)``;
    tenant_ids ``(B,)``. Returns ``(B, N)`` in ``out_dtype`` (default
    x.dtype)."""
    out_dtype = out_dtype or x.dtype
    bsz, kdim = x.shape
    t, k16, nhalf = packed_pairs.shape
    _require(k16 * 16 == kdim, f"x {tuple(x.shape)} vs pairs "
             f"{tuple(packed_pairs.shape)}")
    _require(tuple(colsum.shape) == (t, nhalf * 2),
             f"colsum {tuple(colsum.shape)} != {(t, nhalf * 2)}")
    if not x.is_cuda:
        return tenant_delta_matmul_pair_plain(
            x, packed_pairs, colsum, scales, tenant_ids).to(out_dtype)
    _require(nhalf % (PAIR_BLOCK // 2) == 0, "N must be a multiple of 256")
    _require(kdim * 2 <= 200 * 1024, f"K={kdim} too large for the kernel")
    xq, sxq, a1, a2 = _pair_quantize(x, scales, tenant_ids)
    # The kernel writes fp32 (B, N) in natural column order.
    out = torch.empty((bsz, nhalf * 2), dtype=torch.float32, device=x.device)
    pairs = packed_pairs.contiguous()
    ids = tenant_ids.to(torch.int32).contiguous()
    cs = colsum.to(torch.float32).contiguous()
    _build.launch(_LIB, "bd_pair_delta", [P] * 8 + [I, I, I, P],
                  _build.ptr(xq), _build.ptr(pairs), _build.ptr(ids),
                  _build.ptr(a1), _build.ptr(a2), _build.ptr(sxq),
                  _build.ptr(cs), _build.ptr(out), bsz, k16, nhalf,
                  _build.stream(x.device))
    tenant_delta_matmul_pair.launches += 1
    return out.to(out_dtype)


tenant_delta_matmul_pair.launches = 0


# ---------------------------------------------------------------------------
# Tenant-routed dense matmul (per-tenant lm_head at decode)
# ---------------------------------------------------------------------------

def tenant_dense_matmul_plain(x, w_stack, tenant_ids):
    """Plain version (fp32 out): gather each row's ``(K, N)`` and
    multiply with fp32 accumulation."""
    from .binary_matmul import matmul_f32

    return matmul_f32(x[:, None, :], w_stack[tenant_ids])[:, 0]


def tenant_dense_matmul(x: torch.Tensor, w_stack: torch.Tensor,
                        tenant_ids: torch.Tensor, *, out_dtype=None
                        ) -> torch.Tensor:
    """``Y[b] = x[b] @ W[ids[b]]``: x ``(B, K)``; w_stack ``(T, K, N)``;
    tenant_ids ``(B,)``. No ``(B, K, N)`` gather on the card."""
    out_dtype = out_dtype or x.dtype
    bsz, kdim = x.shape
    t, kw, n = w_stack.shape
    _require(kw == kdim, f"x {tuple(x.shape)} vs W {tuple(w_stack.shape)}")
    if not x.is_cuda:
        return tenant_dense_matmul_plain(x, w_stack, tenant_ids).to(out_dtype)
    _require(x.dtype == w_stack.dtype, "x and W must share a dtype")
    flag = _cuda_dtype_flag(x)
    xc = x.contiguous()
    wc = w_stack.contiguous()
    ids = tenant_ids.to(torch.int32).contiguous()
    splits = _dense_splits(kdim)
    partial = torch.empty((splits, bsz, n), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    _build.launch(_LIB, "bd_tenant_dense", [P, P, P, P, P, I, I, I, I, I, P],
                  _build.ptr(xc), _build.ptr(wc), _build.ptr(ids),
                  _build.ptr(partial), _build.ptr(out), bsz, kdim, n, splits,
                  flag, _build.stream(x.device))
    tenant_dense_matmul.launches += 1
    return out.to(out_dtype)


def _dense_splits(kdim: int) -> int:
    """K ranges of the dense kernel: about 256 rows each, at most 32."""
    return max(1, min(32, kdim // 256))


tenant_dense_matmul.launches = 0


# ---------------------------------------------------------------------------
# Binary matmul, canonical packing (single-request prefill delta)
# ---------------------------------------------------------------------------

def binary_matmul_plain(x, packed, scale):
    """Plain version (fp32 out): unpack to ±1 and multiply in fp32."""
    from .binary_matmul import binary_matmul as plain

    return plain(x.to(torch.float32), packed, scale,
                 compute_dtype=torch.float32)


def binary_matmul(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``scale * (x @ sign(packed))``: x ``(M, K)``, packed ``(K//32, N)``,
    scale a 0-d or 1-element fp32 tensor (read on the device)."""
    out_dtype = out_dtype or x.dtype
    m, kdim = x.shape
    k32, n = packed.shape
    _require(k32 * 32 == kdim, f"x {tuple(x.shape)} vs packed "
             f"{tuple(packed.shape)}")
    if not x.is_cuda:
        return binary_matmul_plain(x, packed, scale).to(out_dtype)
    flag = _cuda_dtype_flag(x)
    xc = x.contiguous()
    pc = packed.contiguous()
    sc = torch.as_tensor(scale, dtype=torch.float32,
                         device=x.device).reshape(1).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.launch(_LIB, "bd_binary_matmul", [P, P, P, P, I, I, I, I, P],
                  _build.ptr(xc), _build.ptr(pc), _build.ptr(sc),
                  _build.ptr(out), m, kdim, n, flag,
                  _build.stream(x.device))
    binary_matmul.launches += 1
    return out.to(out_dtype)


binary_matmul.launches = 0
