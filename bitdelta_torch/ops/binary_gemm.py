"""1-bit delta GEMM kernels for the serving and training paths, each
beside its plain PyTorch version (port of the seven kernels of
``bitdelta_tpu/ops/pallas_binary_gemm.py``):

* :func:`tenant_delta_matmul_pair` — decode, every projection's delta
  (``tenant_delta_matmul_pair_pallas``);
* :func:`tenant_delta_matmul` — decode, a delta in the canonical layout:
  a stack the pair layout did not convert, and Mixtral's routed experts
  (``tenant_delta_matmul_pallas``);
* :func:`tenant_dense_matmul` — decode, the per-tenant lm_head
  (``tenant_dense_matmul_pallas``);
* :func:`binary_matmul` — the single-request prefill delta, and the
  forward of the trainable matmul (``binary_matmul_pallas``);
* :func:`binary_matmul_t` — its transpose, the activation gradient of
  the trainable matmul (``binary_matmul_t_pallas``);
* :func:`fused_tenant_matmul` — decode under the fused route, the base
  matmul and a canonical delta in one kernel
  (``fused_tenant_matmul_pallas``);
* :func:`fused_base_pair_matmul` — decode under the fused route, the base
  matmul and a pair-layout delta in one kernel
  (``fused_base_pair_matmul_pallas``).

:func:`binary_matmul_trainable` is the differentiable delta matmul of
scale distillation, an autograd Function over the last two.

Each wrapper picks by the device of its input: a CPU tensor takes the
plain version (``*_plain``); a CUDA tensor launches the hand-written
kernel of ``csrc/binary_gemm.cu`` or raises. Each wrapper counts its
launches in ``<wrapper>.launches``. The kernel sources say what bounds
each kernel on the H100 and what its design does about it.
"""

from __future__ import annotations

import ctypes
import functools

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
    torch, as JAX's source writes it; ``torch.round`` is half-to-even
    like ``jnp.round``; every division IEEE, on the CPU and the card
    alike). The pair kernel's prep launch computes the same values.
    Returns ``(xq (B, K) int32, sxq (B,), a1 (B,), a2 (B,))`` with
    ``a1 = alpha * step``, ``a2 = alpha * xmin``."""
    xf = x.to(torch.float32)
    xmin = xf.min(dim=1).values
    xmax = xf.max(dim=1).values
    # A tensor divisor: on a CUDA tensor PyTorch divides by a Python
    # scalar as a multiply by its reciprocal, which can put the step one
    # ulp off the IEEE quotient (the CPU's and the kernel's).
    levels = torch.full_like(xmax, PAIR_Q_LEVELS)
    step = torch.clamp((xmax - xmin) / levels, min=1e-30)
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


@functools.lru_cache(maxsize=256)
def _pair_scratch_bytes(bsz: int, kdim: int) -> int:
    """Scratch bytes of one pair kernel call, as its library lays them
    out (x's bit planes and each row's coefficients)."""
    fn = _build.library(_LIB).bd_pair_delta_scratch_bytes
    fn.argtypes, fn.restype = [I, I], ctypes.c_longlong
    return fn(bsz, kdim)


def tenant_delta_matmul_pair(x: torch.Tensor, packed_pairs: torch.Tensor,
                             colsum: torch.Tensor, scales: torch.Tensor,
                             tenant_ids: torch.Tensor, *, out_dtype=None
                             ) -> torch.Tensor:
    """``Y[b] = scales[ids[b]] * (x[b] @ sign(P[ids[b]]))`` at decode,
    pair-packed layout. x ``(B, K)``; packed_pairs ``(T, K//16, N//2)``;
    colsum ``(T, N)`` fp32 = 2*popcount - K; scales ``(T,)``;
    tenant_ids ``(B,)``. Returns ``(B, N)`` in ``out_dtype`` (default
    x.dtype).

    On a CUDA tensor it launches two kernels and nothing else: the x prep
    (``pair_prep_kernel``) and the 1-bit tensor-core product with its
    epilogue (``pair_delta_tc_kernel``, once for each 64 rows). It takes
    any B rows of bf16 or fp32 x (unit column stride), K a multiple of 32,
    N a multiple of 256, contiguous int32 pairs and fp32 colsum and scales,
    int32 or int64 ids, and raises on anything else."""
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
    _require(kdim % 32 == 0, f"K={kdim} must be a multiple of 32")
    _require(x.stride(1) == 1, "x needs a unit column stride")
    _require(packed_pairs.dtype == torch.int32
             and packed_pairs.is_contiguous()
             and packed_pairs.data_ptr() % 16 == 0,
             "pairs must be contiguous int32 at a 16-byte aligned address")
    _require(colsum.dtype == torch.float32 and colsum.is_contiguous(),
             "colsum must be contiguous fp32")
    _require(tuple(scales.shape) == (t,) and scales.dtype == torch.float32
             and scales.is_contiguous(), f"scales must be fp32 ({t},)")
    _require(tuple(tenant_ids.shape) == (bsz,)
             and tenant_ids.dtype in (torch.int32, torch.int64)
             and tenant_ids.is_contiguous(),
             f"tenant_ids must be int32 or int64 ({bsz},)")
    _require(all(a.device == x.device for a in
                 (packed_pairs, colsum, scales, tenant_ids)),
             "every input must be on x's device")
    is_bf16 = _cuda_dtype_flag(x)
    buf = torch.empty(_pair_scratch_bytes(bsz, kdim), dtype=torch.uint8,
                      device=x.device)
    out = torch.empty((bsz, nhalf * 2), dtype=torch.float32, device=x.device)
    _build.launch(_LIB, "bd_pair_delta", [P, I, I] + [P] * 4 + [I, P, P]
                  + [I] * 4 + [P],
                  _build.ptr(x), x.stride(0), is_bf16,
                  _build.ptr(packed_pairs), _build.ptr(colsum),
                  _build.ptr(scales), _build.ptr(tenant_ids),
                  int(tenant_ids.dtype == torch.int64), _build.ptr(buf),
                  _build.ptr(out), bsz, kdim, nhalf, t,
                  _build.stream(x.device))
    tenant_delta_matmul_pair.launches += 1
    return out.to(out_dtype)


tenant_delta_matmul_pair.launches = 0


# ---------------------------------------------------------------------------
# Canonical-layout tenant delta (decode)
# ---------------------------------------------------------------------------

X_QUANT_BITS = 14  # one symmetric grid for the whole (B, K) input


def _canonical_quantize(x: torch.Tensor):
    """JAX's x grid of ``tenant_delta_matmul_pallas`` (plain torch, as JAX
    runs it in XLA): ``xq = round(x / xscale)`` with ONE ``xscale =
    max(max|x|, 1e-30) / 2**14`` for the whole input, not per row.
    Returns ``(xq (B, K) int32, xscale 0-d fp32)``."""
    xf = x.to(torch.float32)
    xmax = torch.clamp(xf.abs().max(), min=1e-30)
    xscale = xmax / (2.0 ** X_QUANT_BITS)
    return torch.round(xf / xscale).to(torch.int32), xscale


def _canonical_kernel_input(x: torch.Tensor):
    """What row 7's prep kernel (``canon_prep_kernel``) writes for the main
    kernel, in plain torch: ``(xq (B, K) int16, sxq (B,) int64, xscale 0-d
    fp32)`` from :func:`_canonical_quantize`. |xq| <= 2^14 fits int16 (the
    kernel keeps it as 16 two's-complement bit planes); sxq is summed in
    int64, since at K >= 2^17 a row's sum passes 2^31."""
    xq, xscale = _canonical_quantize(x)
    return (xq.to(torch.int16), xq.sum(dim=1, dtype=torch.int64),
            xscale)


def tenant_delta_matmul_plain(x, packed_stack, scales, tenant_ids):
    """Plain version of :func:`tenant_delta_matmul` (fp32 out): the
    integer sums ``sum_k bit * xq`` over each row's matrix in int64, then
    ``(scale * float(2 * S - sum(xq))) * xscale`` in the kernel's order.
    JAX sums per K block in fp32 instead, so it agrees with this to fp32
    rounding; the kernel agrees bit for bit."""
    bsz, kdim = x.shape
    xq, xscale = _canonical_quantize(x)
    xq = xq.to(torch.int64)
    xr = xq.reshape(bsz, kdim // 32, 32)
    u = _u32(packed_stack[tenant_ids])                  # (B, K/32, N)
    s = torch.zeros((bsz, u.shape[-1]), dtype=torch.int64, device=x.device)
    for bit in range(32):
        s += (((u >> bit) & 1) * xr[:, :, bit, None]).sum(dim=1)
    d = (2 * s - xq.sum(dim=1, keepdim=True)).to(torch.float32)
    alpha = scales.to(torch.float32)[tenant_ids]
    return (alpha[:, None] * d) * xscale


@functools.lru_cache(maxsize=256)
def _canon_scratch_bytes(bsz: int, kdim: int) -> int:
    """Scratch bytes of one canonical kernel call, as its library lays
    them out (x's 16 bit planes, each row's int64 sum of xq, xscale)."""
    fn = _build.library(_LIB).bd_canon_delta_scratch_bytes
    fn.argtypes, fn.restype = [I, I], ctypes.c_longlong
    return fn(bsz, kdim)


# Element types of x that row 7's prep kernel reads (``bd_canon_delta``).
_CANON_X_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                  torch.float64: 3}


def tenant_delta_matmul(x: torch.Tensor, packed_stack: torch.Tensor,
                        scales: torch.Tensor, tenant_ids: torch.Tensor, *,
                        out_dtype=None) -> torch.Tensor:
    """``Y[b] = scales[ids[b]] * (x[b] @ sign(P[ids[b]]))`` at decode,
    canonical layout, x on the 14-bit grid of :func:`_canonical_quantize`.
    x ``(B, K)``; packed_stack ``(G, K//32, N)``; scales ``(G,)``;
    tenant_ids ``(B,)`` in ``[0, G)`` (a tenant, or a flattened (tenant,
    expert) pair). Returns ``(B, N)`` in ``out_dtype`` (default x.dtype).

    On a CUDA tensor it launches two kernels and nothing else: the x prep
    (``canon_prep_kernel``: the global grid and xq's 16 bit planes) and the
    1-bit tensor-core product with its epilogue (``canon_delta_tc_kernel``,
    once for each 64 rows). It takes any B rows (up to 409600) of fp32,
    bf16, fp16 or fp64 x (any strides), any G, K a multiple of 32, any N,
    contiguous int32 words, contiguous fp32 scales, int32 or int64 ids, and
    raises on anything else."""
    out_dtype = out_dtype or x.dtype
    bsz, kdim = x.shape
    g, k32, n = packed_stack.shape
    _require(k32 * 32 == kdim, f"x {tuple(x.shape)} vs packed "
             f"{tuple(packed_stack.shape)}")
    _require(tuple(scales.shape) == (g,), f"scales {tuple(scales.shape)} "
             f"!= {(g,)}")
    if not x.is_cuda:
        return tenant_delta_matmul_plain(x, packed_stack, scales,
                                         tenant_ids).to(out_dtype)
    _require(x.dtype in _CANON_X_TYPES,
             f"x must be fp32, bf16, fp16 or fp64, got {x.dtype}")
    _require(bsz >= 1 and n >= 1 and g >= 1, "empty input")
    _require(packed_stack.dtype == torch.int32
             and packed_stack.is_contiguous(),
             "packed words must be contiguous int32")
    _require(scales.dtype == torch.float32 and scales.is_contiguous(),
             f"scales must be fp32 ({g},)")
    _require(tuple(tenant_ids.shape) == (bsz,)
             and tenant_ids.dtype in (torch.int32, torch.int64)
             and tenant_ids.is_contiguous(),
             f"tenant_ids must be int32 or int64 ({bsz},)")
    _require(all(a.device == x.device for a in
                 (packed_stack, scales, tenant_ids)),
             "every input must be on x's device")
    buf = torch.empty(_canon_scratch_bytes(bsz, kdim), dtype=torch.uint8,
                      device=x.device)
    out = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    strides = [ctypes.c_longlong] * 2
    _build.launch(_LIB, "bd_canon_delta", [P, *strides, I] + [P] * 3
                  + [I, P, P] + [I] * 4 + [P],
                  _build.ptr(x), x.stride(0), x.stride(1),
                  _CANON_X_TYPES[x.dtype], _build.ptr(packed_stack),
                  _build.ptr(scales), _build.ptr(tenant_ids),
                  int(tenant_ids.dtype == torch.int64), _build.ptr(buf),
                  _build.ptr(out), bsz, kdim, n, g, _build.stream(x.device))
    tenant_delta_matmul.launches += 1
    return out.to(out_dtype)


tenant_delta_matmul.launches = 0


# ---------------------------------------------------------------------------
# Tenant-routed dense matmul (per-tenant lm_head at decode)
# ---------------------------------------------------------------------------

def tenant_dense_matmul_plain(x, w_stack, tenant_ids):
    """Plain version (fp32 out): gather each row's ``(K, N)`` and
    multiply with fp32 accumulation."""
    from .binary_matmul import matmul_f32

    return matmul_f32(x[:, None, :], w_stack[tenant_ids])[:, 0]


# Element types of the CUDA-core dense kernel (``bd_tenant_dense``).
_DENSE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def tenant_dense_matmul(x: torch.Tensor, w_stack: torch.Tensor,
                        tenant_ids: torch.Tensor, *, out_dtype=None
                        ) -> torch.Tensor:
    """``Y[b] = x[b] @ W[ids[b]]``: x ``(B, K)``; w_stack ``(T, K, N)``;
    tenant_ids ``(B,)``. Products and sums in fp32, as the TPU kernel's;
    returns ``(B, N)`` in ``out_dtype`` (default x.dtype). No ``(B, K,
    N)`` gather on the card.

    On a CUDA tensor, bf16 x and W with K and N multiples of 8 launch the
    tensor-core kernel (``tenant_dense_tc_kernel``, once for each 128
    rows) and nothing else; x and W each bf16, fp16 or fp32 in any other
    pair, or any other K or N, take the CUDA-core kernel
    (``tenant_dense_kernel``) and its split sum. The head is never cast
    (a contiguous, 16-byte aligned stack is not copied). int32 or int64
    ids."""
    out_dtype = out_dtype or x.dtype
    bsz, kdim = x.shape
    t, kw, n = w_stack.shape
    _require(kw == kdim, f"x {tuple(x.shape)} vs W {tuple(w_stack.shape)}")
    if not x.is_cuda:
        return tenant_dense_matmul_plain(x, w_stack, tenant_ids).to(out_dtype)
    _require(x.dtype in _DENSE_TYPES and w_stack.dtype in _DENSE_TYPES,
             f"x and W must be bf16, fp16 or fp32, got {x.dtype} and "
             f"{w_stack.dtype}")
    _require(tuple(tenant_ids.shape) == (bsz,),
             f"tenant_ids {tuple(tenant_ids.shape)} != {(bsz,)}")
    _require(w_stack.device == x.device and tenant_ids.device == x.device,
             "every input must be on x's device")
    out = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    if (x.dtype == w_stack.dtype == torch.bfloat16 and kdim % 8 == 0
            and n % 8 == 0):
        xc = _build.aligned16(x)
        wc = _build.aligned16(w_stack)
        ids = (tenant_ids if tenant_ids.dtype in (torch.int32, torch.int64)
               else tenant_ids.to(torch.int32)).contiguous()
        _build.launch(_LIB, "bd_tenant_dense_tc", [P, I, P, P, I, P]
                      + [I] * 4 + [P],
                      _build.ptr(xc), xc.stride(0), _build.ptr(wc),
                      _build.ptr(ids), int(ids.dtype == torch.int64),
                      _build.ptr(out), bsz, kdim, n, t,
                      _build.stream(x.device))
    else:
        xc = x.contiguous()
        wc = w_stack.contiguous()
        ids = tenant_ids.to(torch.int32).contiguous()
        splits = _dense_splits(kdim)
        partial = torch.empty((splits, bsz, n), dtype=torch.float32,
                              device=x.device)
        _build.launch(_LIB, "bd_tenant_dense", [P] * 5 + [I] * 6 + [P],
                      _build.ptr(xc), _build.ptr(wc), _build.ptr(ids),
                      _build.ptr(partial), _build.ptr(out), bsz, kdim, n,
                      splits, _DENSE_TYPES[x.dtype],
                      _DENSE_TYPES[w_stack.dtype], _build.stream(x.device))
    tenant_dense_matmul.launches += 1
    return out.to(out_dtype)


def _dense_splits(kdim: int) -> int:
    """K ranges of the CUDA-core dense kernel: about 256 rows each, at
    most 32."""
    return max(1, min(32, kdim // 256))


tenant_dense_matmul.launches = 0


# ---------------------------------------------------------------------------
# Fused base + tenant delta (decode under the fused route)
# ---------------------------------------------------------------------------

FUSED_COLS = 256   # output columns (row 10: pair columns) per kernel block
FUSED_ROWS = 8     # batch rows per kernel block


def _fused_splits(kdim: int, col_tiles: int, rows: int,
                  device: torch.device) -> int:
    """K ranges of the fused kernels: enough blocks for three per SM (the
    number that fit at their register use), each range at least 128
    deep."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = col_tiles * -(-rows // FUSED_ROWS)
    return max(1, min(-(-3 * sms // blocks), kdim // 128))


def _check_fused(x, w_base, kdim, n):
    _require(tuple(w_base.shape) == (kdim, n),
             f"x {tuple(x.shape)} vs W {tuple(w_base.shape)}")
    _require(x.dtype == w_base.dtype,
             f"x ({x.dtype}) and W ({w_base.dtype}) must share a dtype")


def fused_tenant_matmul_plain(x, w_base, packed_stack, scales, tenant_ids):
    """Plain version of :func:`fused_tenant_matmul` (fp32 out): the base
    matmul with fp32 sums, plus ``scale * (x @ ±1)`` with the ±1 stack in
    x's dtype and fp32 sums, as the TPU kernel's two dots."""
    from .binary_matmul import matmul_f32
    from .packing import unpack_to_pm1

    base = matmul_f32(x, w_base)
    pm1 = unpack_to_pm1(packed_stack[tenant_ids], x.dtype)      # (B, K, N)
    d = matmul_f32(x[:, None, :], pm1)[:, 0]
    alpha = scales.to(torch.float32)[tenant_ids]
    return base + alpha[:, None] * d


def fused_tenant_matmul(x: torch.Tensor, w_base: torch.Tensor,
                        packed_stack: torch.Tensor, scales: torch.Tensor,
                        tenant_ids: torch.Tensor, *, out_dtype=None
                        ) -> torch.Tensor:
    """``Y[b] = x[b] @ W + scales[ids[b]] * (x[b] @ sign(P[ids[b]]))`` at
    decode, canonical layout, the delta as exact ±x sums (no x grid). x
    ``(B, K)`` and w_base ``(K, N)`` of one dtype (bf16 or fp32);
    packed_stack ``(T, K//32, N)``; scales ``(T,)``; tenant_ids ``(B,)``.
    Returns ``(B, N)`` in ``out_dtype`` (default x.dtype).

    On a CUDA tensor, bf16 x and W with N a multiple of 8 launch the
    tensor-core kernel (``fused_tenant_tc_kernel``, once for each 32 rows)
    and nothing else; fp32 x and W (their dot with ±1 must not go through
    TF32), or any other N, take the CUDA-core kernel
    (``fused_tenant_kernel``) and its split sum (``sum_splits_kernel``).
    It takes int32 words, scales of any float dtype (read as fp32), int32
    or int64 ids of shape ``(B,)`` (other integer ids are cast to int32),
    every input on x's device, and raises on anything else."""
    out_dtype = out_dtype or x.dtype
    bsz, kdim = x.shape
    t, k32, n = packed_stack.shape
    _require(k32 * 32 == kdim, f"x {tuple(x.shape)} vs packed "
             f"{tuple(packed_stack.shape)}")
    _require(tuple(scales.shape) == (t,), f"scales {tuple(scales.shape)} "
             f"!= {(t,)}")
    _check_fused(x, w_base, kdim, n)
    if not x.is_cuda:
        return fused_tenant_matmul_plain(x, w_base, packed_stack, scales,
                                         tenant_ids).to(out_dtype)
    flag = _cuda_dtype_flag(x)
    _require(packed_stack.dtype == torch.int32,
             f"packed words must be int32, got {packed_stack.dtype}")
    _require(tuple(tenant_ids.shape) == (bsz,)
             and not tenant_ids.is_floating_point()
             and not tenant_ids.is_complex(),
             f"tenant_ids must be integers of shape {(bsz,)}, got "
             f"{tenant_ids.dtype} {tuple(tenant_ids.shape)}")
    _require(all(a.device == x.device for a in
                 (w_base, packed_stack, scales, tenant_ids)),
             "every input must be on x's device")
    out = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    packed = _build.aligned16(packed_stack)
    sc = scales.to(torch.float32).contiguous()
    if flag and n % 8 == 0:
        xc = _build.aligned16(x)
        wc = _build.aligned16(w_base)
        ids = (tenant_ids if tenant_ids.dtype in (torch.int32, torch.int64)
               else tenant_ids.to(torch.int32)).contiguous()
        _build.launch(_LIB, "bd_fused_tenant_tc", [P, I] + [P] * 4
                      + [I, P] + [I] * 3 + [P],
                      _build.ptr(xc), xc.stride(0), _build.ptr(wc),
                      _build.ptr(packed), _build.ptr(sc), _build.ptr(ids),
                      int(ids.dtype == torch.int64), _build.ptr(out), bsz,
                      kdim, n, _build.stream(x.device))
    else:
        splits = _fused_splits(kdim, -(-n // FUSED_COLS), bsz, x.device)
        partial = torch.empty((splits, bsz, n), dtype=torch.float32,
                              device=x.device)
        xc = x.contiguous()
        wc = w_base.contiguous()
        ids = tenant_ids.to(torch.int32).contiguous()
        _build.launch(_LIB, "bd_fused_tenant", [P] * 7 + [I] * 5 + [P],
                      _build.ptr(xc), _build.ptr(wc), _build.ptr(packed),
                      _build.ptr(ids), _build.ptr(sc), _build.ptr(partial),
                      _build.ptr(out), bsz, kdim, n, splits, flag,
                      _build.stream(x.device))
    fused_tenant_matmul.launches += 1
    return out.to(out_dtype)


fused_tenant_matmul.launches = 0


def fused_tenant_tc_launched() -> int:
    """Launches of ``fused_tenant_tc_kernel`` (one a slab of 32 rows)
    since the kernel library was loaded, counted by the library where it
    launches them: unlike a profiler trace, this count loses none."""
    fn = _build.library(_LIB).bd_fused_tenant_tc_launched
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return fn()


def fused_base_pair_matmul_plain(x, w_base, packed_pairs, colsum, scales,
                                 tenant_ids):
    """Plain version of :func:`fused_base_pair_matmul` (fp32 out): the
    base matmul with fp32 sums plus :func:`tenant_delta_matmul_pair_plain`
    (row 1's integer pair sums and epilogue)."""
    from .binary_matmul import matmul_f32

    return matmul_f32(x, w_base) + tenant_delta_matmul_pair_plain(
        x, packed_pairs, colsum, scales, tenant_ids)


def fused_base_pair_matmul(x: torch.Tensor, w_base: torch.Tensor,
                           packed_pairs: torch.Tensor, colsum: torch.Tensor,
                           scales: torch.Tensor, tenant_ids: torch.Tensor, *,
                           out_dtype=None) -> torch.Tensor:
    """``Y[b] = x[b] @ W + scales[ids[b]] * (x[b] @ sign(P[ids[b]]))`` at
    decode, pair-packed layout, the delta on row 1's 12-bit x grid. x
    ``(B, K)`` and w_base ``(K, N)`` (natural layout) of one dtype;
    packed_pairs ``(T, K//16, N//2)``; colsum ``(T, N)``; scales ``(T,)``;
    tenant_ids ``(B,)``; N a multiple of 256. Returns ``(B, N)`` in
    ``out_dtype`` (default x.dtype).

    On a CUDA tensor, bf16 x and W launch row 1's x prep
    (``pair_prep_kernel``) and the tensor-core kernel
    (``fused_pair_tc_kernel``, once for each 32 rows), and nothing else;
    fp32 x and W take the CUDA-core kernel and its epilogue after the
    plain-torch x prep. It takes any B, K a multiple of 16, contiguous
    int32 pairs, fp32 colsum and scales, int32 or int64 ids, and raises
    on anything else."""
    out_dtype = out_dtype or x.dtype
    bsz, kdim = x.shape
    t, k16, nhalf = packed_pairs.shape
    n = nhalf * 2
    _require(k16 * 16 == kdim, f"x {tuple(x.shape)} vs pairs "
             f"{tuple(packed_pairs.shape)}")
    _require(tuple(colsum.shape) == (t, n),
             f"colsum {tuple(colsum.shape)} != {(t, n)}")
    _check_fused(x, w_base, kdim, n)
    if not x.is_cuda:
        return fused_base_pair_matmul_plain(
            x, w_base, packed_pairs, colsum, scales, tenant_ids).to(out_dtype)
    _require(n % PAIR_BLOCK == 0, "N must be a multiple of 256")
    flag = _cuda_dtype_flag(x)
    _require(packed_pairs.dtype == torch.int32
             and packed_pairs.is_contiguous()
             and packed_pairs.data_ptr() % 16 == 0,
             "pairs must be contiguous int32 at a 16-byte aligned address")
    _require(colsum.dtype == torch.float32 and colsum.is_contiguous(),
             "colsum must be contiguous fp32")
    _require(tuple(scales.shape) == (t,) and scales.dtype == torch.float32
             and scales.is_contiguous(), f"scales must be fp32 ({t},)")
    _require(tuple(tenant_ids.shape) == (bsz,)
             and tenant_ids.dtype in (torch.int32, torch.int64)
             and tenant_ids.is_contiguous(),
             f"tenant_ids must be int32 or int64 ({bsz},)")
    _require(all(a.device == x.device for a in
                 (w_base, packed_pairs, colsum, scales, tenant_ids)),
             "every input must be on x's device")
    out = torch.empty((bsz, n), dtype=torch.float32, device=x.device)
    xc = _build.aligned16(x)
    wc = _build.aligned16(w_base)
    if flag:
        buf = torch.empty(_pair_scratch_bytes(bsz, kdim), dtype=torch.uint8,
                          device=x.device)
        _build.launch(_LIB, "bd_fused_base_pair_tc", [P, I] + [P] * 5
                      + [I, P, P] + [I] * 3 + [P],
                      _build.ptr(xc), xc.stride(0), _build.ptr(wc),
                      _build.ptr(packed_pairs), _build.ptr(colsum),
                      _build.ptr(scales), _build.ptr(tenant_ids),
                      int(tenant_ids.dtype == torch.int64), _build.ptr(buf),
                      _build.ptr(out), bsz, kdim, nhalf,
                      _build.stream(x.device))
    else:
        xq, sxq, a1, a2 = _pair_quantize(x, scales, tenant_ids)
        splits = _fused_splits(kdim, -(-nhalf // FUSED_COLS), bsz, x.device)
        part_base = torch.empty((splits, bsz, n), dtype=torch.float32,
                                device=x.device)
        part_s = torch.empty((splits, bsz, n), dtype=torch.int32,
                             device=x.device)
        ids = tenant_ids.to(torch.int32).contiguous()
        _build.launch(_LIB, "bd_fused_base_pair", [P] * 12 + [I] * 4 + [P],
                      _build.ptr(xc), _build.ptr(xq), _build.ptr(wc),
                      _build.ptr(packed_pairs), _build.ptr(ids),
                      _build.ptr(a1), _build.ptr(a2), _build.ptr(sxq),
                      _build.ptr(colsum), _build.ptr(part_base),
                      _build.ptr(part_s), _build.ptr(out), bsz, kdim, nhalf,
                      splits, _build.stream(x.device))
    fused_base_pair_matmul.launches += 1
    return out.to(out_dtype)


fused_base_pair_matmul.launches = 0


# ---------------------------------------------------------------------------
# Binary matmul, canonical packing (single-request prefill delta)
# ---------------------------------------------------------------------------

GEMM_TILE = 128   # output rows and columns per block of rows 5 and 6
GEMM_STEP = 64    # reduction depth of one pipeline step


def _split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as three bf16 pieces ``(3, *x.shape)``: ``hi =
    bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``. Their
    fp32 sum ``hi + mid + lo`` is ``x`` bit for bit for normal values
    (each residual fits the next piece's 8 bits); a zero piece takes x's
    sign, so -0.0 splits into three -0.0."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = r - mid
    pieces = torch.stack([hi, mid, lo])
    pieces = torch.where(pieces == 0, torch.copysign(pieces, x), pieces)
    return pieces.to(torch.bfloat16)


def _gemm_operand(a: torch.Tensor):
    """Rows 5 and 6's input as the kernel reads it: ``(pieces, M, lda)``
    bf16, one piece for bf16 input and :func:`_split_bf16x3`'s three for
    fp32, with ``lda`` the reduction length rounded up to 8 (zero-padded)
    and a 16-byte aligned start, so every 16-byte copy is aligned."""
    red = a.shape[1]
    if a.dtype == torch.float32:
        pieces = _split_bf16x3(a.contiguous())
    elif a.dtype == torch.bfloat16:
        pieces = a.contiguous()[None]
    else:
        raise TypeError(f"kernel takes bf16 or fp32, got {a.dtype}")
    lda = -(-red // 8) * 8
    if lda != red:
        pieces = torch.nn.functional.pad(pieces, (0, lda - red))
    elif pieces.data_ptr() % 16:
        pieces = pieces.clone()
    return pieces, lda


def _gemm_splits(m: int, n_out: int, red: int, per_sm: int,
                 device: torch.device):
    """Reduction splits of rows 5 and 6: where the output tiles alone do
    not fill the card (``per_sm`` blocks an SM: two for bf16 input, one
    for fp32's three pieces, by shared memory), as many splits as fill
    it, each at least 16 steps deep (a shallower split costs more in its
    second pass than it gains). Returns ``(splits, reduction per
    split)``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-m // GEMM_TILE) * -(-n_out // GEMM_TILE)
    steps = -(-red // GEMM_STEP)
    splits = max(1, min(per_sm * sms // tiles, steps // 16))
    per = -(-steps // splits) * GEMM_STEP
    return -(-red // per), per


def _launch_binary(fn_name: str, a, packed, scale, n_out: int, dims):
    """Launch row 5 or 6 (``fn_name``) on ``a`` ``(M, red)``; ``dims``
    are the entry's (K or K32, N). Returns the fp32 ``(M, n_out)``
    output."""
    m, red = a.shape
    pieces, lda = _gemm_operand(a)
    pc = packed.contiguous()
    sc = torch.as_tensor(scale, dtype=torch.float32,
                         device=a.device).reshape(1).contiguous()
    splits, per = _gemm_splits(m, n_out, red,
                               2 if pieces.shape[0] == 1 else 1, a.device)
    out = torch.empty((m, n_out), dtype=torch.float32, device=a.device)
    partial = (torch.empty((splits, m, n_out), dtype=torch.float32,
                           device=a.device) if splits > 1 else None)
    _build.launch(_LIB, fn_name, [P] * 5 + [I] * 7 + [P],
                  _build.ptr(pieces), _build.ptr(pc), _build.ptr(sc),
                  _build.ptr(out),
                  _build.ptr(partial) if partial is not None else None,
                  m, *dims, lda, pieces.shape[0], splits, per,
                  _build.stream(a.device))
    return out


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
    out = _launch_binary("bd_binary_matmul", x, packed, scale, n, (kdim, n))
    binary_matmul.launches += 1
    return out.to(out_dtype)


binary_matmul.launches = 0


# ---------------------------------------------------------------------------
# Transposed binary matmul and the trainable binary matmul (training path)
# ---------------------------------------------------------------------------

def binary_matmul_t_plain(g, packed, scale):
    """Plain version (fp32 out): unpack to ±1 in fp32 and multiply by the
    transpose."""
    from .packing import unpack_to_pm1

    signs = unpack_to_pm1(packed, torch.float32)                # (K, N)
    y = torch.matmul(g.to(torch.float32), signs.transpose(0, 1))
    return torch.as_tensor(scale, dtype=torch.float32, device=y.device) * y


def binary_matmul_t(g: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``scale * (g @ sign(packed).T)``: g ``(M, N)``, packed
    ``(K//32, N)``, scale a 0-d or 1-element fp32 tensor (read on the
    device). Returns ``(M, K)`` in ``out_dtype`` (default g.dtype)."""
    out_dtype = out_dtype or g.dtype
    m, n = g.shape
    k32, n_p = packed.shape
    _require(n_p == n, f"g {tuple(g.shape)} vs packed {tuple(packed.shape)}")
    if not g.is_cuda:
        return binary_matmul_t_plain(g, packed, scale).to(out_dtype)
    out = _launch_binary("bd_binary_matmul_t", g, packed, scale, k32 * 32,
                         (k32, n))
    binary_matmul_t.launches += 1
    return out.to(out_dtype)


binary_matmul_t.launches = 0


class _BinaryMatmulTrainable(torch.autograd.Function):
    """The custom VJP of ``binary_matmul_trainable`` in
    ``bitdelta_tpu/ops/pallas_binary_gemm.py`` with its roundings: the
    forward in x's dtype; the backward recomputes ``u = x @ sign`` in fp32
    (not saved), ``d_scale = sum(g * u)`` in fp32 and
    ``d_x = scale * (g @ sign.T)`` in x's dtype. The packed bits get no
    gradient."""

    @staticmethod
    def forward(ctx, x, packed, scale):
        ctx.save_for_backward(x, packed, scale)
        return binary_matmul(x, packed, scale)

    @staticmethod
    def backward(ctx, g):
        x, packed, scale = ctx.saved_tensors
        d_x = d_scale = None
        if ctx.needs_input_grad[2]:
            u = binary_matmul(x, packed, torch.ones_like(scale),
                              out_dtype=torch.float32)
            d_scale = (g.to(torch.float32) * u).sum().to(
                scale.dtype).reshape(scale.shape)
        if ctx.needs_input_grad[0]:
            d_x = binary_matmul_t(g.to(x.dtype), packed, scale,
                                  out_dtype=x.dtype)
        return d_x, None, d_scale


def binary_matmul_trainable(x: torch.Tensor, packed: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """Differentiable ``scale * (x @ sign(packed))`` in x's dtype: x
    ``(M, K)``, packed ``(K//32, N)``, scale a 0-d fp32 tensor. Gradients
    flow to x (through :func:`binary_matmul_t`) and to scale; without a
    gradient to take it is :func:`binary_matmul` alone."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _BinaryMatmulTrainable.apply(x, packed, scale)
    return binary_matmul(x, packed, scale)
