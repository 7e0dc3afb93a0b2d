"""Import pre-quantized layers (AutoGPTQ int4, bitsandbytes int8); port
of ``bitdelta_tpu/models/quant_import.py`` in numpy and torch.

The reference dequantizes such layers back to fp16 so BitDelta can ride
on top (``deq = (q - zero) * scale`` per K group with the legacy
``zeros + 1`` offset; int8 ``CB * SCB / 127``). Beyond that:

* the GPTQ nibble layout (8 4-bit values per int32, LSB-first along the
  input dimension) is the :class:`Int4Weight` word layout, and a
  symmetric layer (every zero point 8) maps onto it losslessly by one
  XOR with 0x88888888 (unsigned nibble ``q`` -> two's-complement
  ``q - 8``), so an imported base serves through the W4 path without
  dense weights;
* asymmetric or act-order (``g_idx``) layers dequantize to dense, which
  is what the reference does for every checkpoint.

GPTQ stores ``(K_in, N_out)``, the port's layout, so imports need no
transpose. Loading a whole checkpoint directory (``load_gptq_params``)
is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..research.quantized_base import Int4Weight, Int8Weight

_SYM_NIBBLES = np.uint32(0x77777777)   # zero-point nibble 7 => zero == 8
_SYM_NIBBLES_V2 = np.uint32(0x88888888)  # gptq_v2 stores zeros unshifted
_SIGN_FLIP = np.uint32(0x88888888)     # unsigned nibble -> two's-complement


def unpack_gptq_nibbles(packed: np.ndarray, axis: int = 0) -> np.ndarray:
    """Unpack int32 words into unsigned 4-bit values ``[0, 15]`` along
    ``axis`` (LSB-first)."""
    u = np.ascontiguousarray(packed).view(np.uint32)
    shifts = np.arange(8, dtype=np.uint32) * 4
    nib = (u[..., None] >> shifts).astype(np.uint32) & 0xF
    # (..., W, ..., 8) -> interleave the nibble axis right after `axis`.
    nib = np.moveaxis(nib, -1, axis + 1)
    out_shape = list(packed.shape)
    out_shape[axis] *= 8
    return nib.reshape(out_shape).astype(np.int32)


def dequantize_gptq(qweight: np.ndarray, qzeros: np.ndarray,
                    scales: np.ndarray,
                    g_idx: Optional[np.ndarray] = None,
                    checkpoint_format: str = "gptq") -> np.ndarray:
    """Dense fp32 ``(K, N)`` from GPTQ arrays: ``(q - zero) * scale``.

    qweight ``(K//8, N)`` int32; qzeros ``(G, N//8)`` int32; scales
    ``(G, N)``; g_idx ``(K,)`` optional group index per input row
    (act-order checkpoints), contiguous groups by default.
    ``checkpoint_format``: ``"gptq"`` (legacy, zeros stored shifted by
    -1) or ``"gptq_v2"`` (zeros stored unshifted)."""
    if checkpoint_format not in ("gptq", "gptq_v2"):
        raise ValueError(f"unknown checkpoint_format {checkpoint_format!r}")
    q = unpack_gptq_nibbles(qweight, axis=0)            # (K, N)
    z = unpack_gptq_nibbles(qzeros, axis=1)             # (G, N)
    if checkpoint_format == "gptq":
        z = z + 1                                       # legacy offset
    k = q.shape[0]
    if g_idx is None:
        if k % scales.shape[0]:
            raise ValueError(
                f"K={k} does not divide into {scales.shape[0]} groups; "
                f"an act-order checkpoint must supply g_idx explicitly")
        g_idx = np.arange(k) // (k // scales.shape[0])
    g_idx = np.asarray(g_idx, np.int64)
    s = scales.astype(np.float32)[g_idx]                # (K, N)
    return (q - z[g_idx]).astype(np.float32) * s


def gptq_is_symmetric(qzeros: np.ndarray,
                      g_idx: Optional[np.ndarray] = None,
                      k: Optional[int] = None,
                      checkpoint_format: str = "gptq") -> bool:
    """True when the layer maps losslessly onto :class:`Int4Weight`:
    every zero point is 8 (nibble 7 in the legacy shifted format, 8 in
    gptq_v2) and the group assignment is the contiguous one."""
    want = _SYM_NIBBLES if checkpoint_format == "gptq" else _SYM_NIBBLES_V2
    if not np.all(np.ascontiguousarray(qzeros).view(np.uint32) == want):
        return False
    if g_idx is not None and k is not None:
        groups = qzeros.shape[0]
        if k % groups or not np.array_equal(
                np.asarray(g_idx), np.arange(k) // (k // groups)):
            return False
    return True


def int4_from_gptq(qweight: np.ndarray, qzeros: np.ndarray,
                   scales: np.ndarray,
                   g_idx: Optional[np.ndarray] = None,
                   checkpoint_format: str = "gptq",
                   device="cuda") -> Int4Weight:
    """Lossless :class:`Int4Weight` on ``device`` from a symmetric GPTQ
    layer: the words up to the unsigned -> two's-complement XOR; the
    scales pass through (any group size dividing K; ``int4_matmul``
    derives the group from the scale's shape)."""
    device = resolve_device(device)
    if not gptq_is_symmetric(qzeros, g_idx, qweight.shape[0] * 8,
                             checkpoint_format):
        raise ValueError(
            "asymmetric or act-order GPTQ layer: no lossless Int4Weight "
            "mapping — use dequantize_gptq (dense), as the reference "
            "does for every checkpoint")
    packed = (np.ascontiguousarray(qweight).view(np.uint32)
              ^ _SIGN_FLIP).view(np.int32)
    return Int4Weight(
        packed=torch.from_numpy(packed.copy()).to(device),
        scale=torch.from_numpy(np.asarray(scales, np.float32)).to(device))


def int8_from_bnb(cb: np.ndarray, scb: np.ndarray,
                  device="cuda") -> Int8Weight:
    """:class:`Int8Weight` on ``device`` from bitsandbytes
    ``Linear8bitLt`` state: weight = ``CB * SCB[:, None] / 127`` in
    torch's ``(out, in)`` layout -> ``(K, N)`` with a per-column scale."""
    device = resolve_device(device)
    q = torch.from_numpy(np.ascontiguousarray(cb.T).copy())
    scale = torch.from_numpy(np.asarray(scb, np.float32) / np.float32(127.0))
    return Int8Weight(q=q.to(device), scale=scale.to(device))
