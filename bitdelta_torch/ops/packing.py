"""Sign-bit packing for 1-bit weight deltas (port of
``bitdelta_tpu/ops/packing.py``; same layouts, bit for bit).

Sign bits are packed along K, LSB-first, 32 per int32 word: word
``w[k32, n]`` holds the sign of row ``k32*32 + s`` at bit ``s``. Bit 1
<=> delta >= 0 (+1), bit 0 <=> delta < 0 (-1).

JAX shifts a uint32 bitcast; torch has no general uint32 arithmetic and
its ``>>`` on int32 is arithmetic (it drags bit 31 along). So every
function here widens the words to int64 and masks to 32 bits
(``_u32``) before shifting, and narrows back with an explicit two's-
complement wrap (``_to_i32``).
"""

from __future__ import annotations

import torch

N_BITS = 32
PAIR_BLOCK = 256  # output columns per pair block (two 128-column halves)


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned value, held in int64."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) to the int32 with the same bits."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def packed_rows(k: int, n_bits: int = N_BITS) -> int:
    if k % n_bits != 0:
        raise ValueError(f"K={k} must be divisible by n_bits={n_bits}")
    return k // n_bits


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """Pack a boolean ``(*, K, N)`` sign tensor into ``(*, K//32, N)``
    int32 (LSB-first along K). One bit position at a time, so no
    ``(*, K, N)`` int64 temporary exists."""
    *lead, k, n = signs.shape
    k32 = packed_rows(k)
    bits = signs.reshape(*lead, k32, N_BITS, n)
    words = torch.zeros((*lead, k32, n), dtype=torch.int64,
                        device=signs.device)
    for s in range(N_BITS):
        words |= bits[..., s, :].to(torch.int64) << s
    return _to_i32(words)


def _unpack(packed: torch.Tensor, dtype, pm1: bool) -> torch.Tensor:
    # One bit position at a time into the output, so the only
    # temporaries are packed-sized (no (*, K, N) int64 tensor).
    *lead, k32, n = packed.shape
    u = _u32(packed)
    out = torch.empty((*lead, k32, N_BITS, n), dtype=dtype,
                      device=packed.device)
    for s in range(N_BITS):
        bit = (u >> s) & 1
        out[..., s, :] = (2 * bit - 1) if pm1 else bit
    return out.reshape(*lead, k32 * N_BITS, n)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """``(*, K//32, N)`` int32 -> boolean ``(*, K, N)``."""
    return _unpack(packed, torch.bool, pm1=False)


def unpack_to_pm1(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense ±1 ``(*, K, N)`` of ``dtype``: bit 1 -> +1, bit 0 -> -1."""
    return _unpack(packed, dtype, pm1=True)


def repack_pairs(packed: torch.Tensor) -> torch.Tensor:
    """Canonical ``(*, K//32, N)`` -> pair layout ``(*, K//16, N//2)``.

    Pair word ``[k16, g*128 + r]`` holds, LSB-first, the 16 sign bits of
    K rows ``[16*k16, 16*k16 + 16)`` for output column ``g*256 + r`` in
    its low half and for column ``g*256 + 128 + r`` in its high half.
    """
    *lead, k32, n = packed.shape
    if n % PAIR_BLOCK != 0:
        raise ValueError(f"N={n} must be divisible by {PAIR_BLOCK}")
    u = _u32(packed)
    h = torch.stack([u & 0xFFFF, u >> 16], dim=-2)      # (*, K32, 2, N)
    h = h.reshape(*lead, 2 * k32, n // PAIR_BLOCK, 2, PAIR_BLOCK // 2)
    pair = h[..., 0, :] | (h[..., 1, :] << 16)
    return _to_i32(pair.reshape(*lead, 2 * k32, n // 2))


def unpair_packed(pair: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`repack_pairs`: ``(*, K//16, N//2)`` ->
    ``(*, K//32, N)``."""
    *lead, k16, n2 = pair.shape
    n = n2 * 2
    u = _u32(pair)
    hl = torch.stack([u & 0xFFFF, u >> 16], dim=-2)     # (*, K16, 2, N/2)
    hl = hl.reshape(*lead, k16, 2, n // PAIR_BLOCK, PAIR_BLOCK // 2)
    h = hl.transpose(-3, -2).reshape(*lead, k16, n)
    h = h.reshape(*lead, k16 // 2, 2, n)
    return _to_i32(h[..., 0, :] | (h[..., 1, :] << 16))


def column_popcount(packed: torch.Tensor) -> torch.Tensor:
    """Per-output-column count of set bits: ``(*, K//32, N)`` ->
    ``(*, N)`` int32. One bit position at a time (no unpacked temp)."""
    u = _u32(packed)
    count = torch.zeros(u.shape[:-2] + u.shape[-1:], dtype=torch.int64,
                        device=packed.device)
    for s in range(N_BITS):
        count += ((u >> s) & 1).sum(dim=-2)
    return count.to(torch.int32)
