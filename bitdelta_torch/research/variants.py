"""Delta-fidelity research variants (port of
``bitdelta_tpu/research/variants.py``).

Counterparts of the reference's experimental compressors:

  * :class:`LoRADelta` — a rank-r delta from the exact truncated SVD
    (the reference's ``LoRADiff`` takes ``torch.svd_lowrank``; the exact
    truncation is the stricter baseline, as in JAX);
  * :class:`TernaryDelta` — a {-1, 0, +1} delta thresholded at a
    quantile of |delta|, and the ``binary_median`` variant (every sign
    kept, scaled by the median of |delta|);
  * :class:`ColumnScaleDelta` — 1-bit signs with one scale per output
    column.

Each variant has quantize / dequantize / apply, and
:func:`fuse_variant_model` runs the whole-model ablation in one call.
They are plain torch: in JAX they are XLA ops, and no kernel is behind
them.

The median and the ternary threshold follow ``jnp.quantile`` step by
step (:func:`_quantile`): the position ``q * (n - 1)`` is taken in fp32,
so above 2^24 elements ``n - 1`` rounds and the picked elements are not
those of ``torch.median`` (which takes the lower middle element) or of
``torch.quantile`` (which refuses such inputs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.delta import delta_signs
from ..ops.binary_matmul import binary_matmul, matmul_f32
from ..ops.packing import pack_signs, unpack_signs, unpack_to_pm1


class LoRADelta(NamedTuple):
    """Rank-r factorization of the delta: ``delta ~ a @ b``.
    a: ``(K, r)``, b: ``(r, N)``."""

    a: torch.Tensor
    b: torch.Tensor


def quantize_lora(base: torch.Tensor, finetune: torch.Tensor,
                  rank: int = 16) -> LoRADelta:
    """The exact SVD of the fp32 diff, truncated to ``rank``. The factors
    are unique only up to signs (and within a subspace of equal singular
    values); ``a @ b`` is what JAX and the port share.

    On the card the SVD is cuSOLVER's QR-based ``gesvd``: torch's default
    there, the Jacobi ``gesvdj``, stops short of fp32's precision (on an
    H100, ``a @ b`` of a rank-4 delta 5e-5 of its scale off an fp64 SVD,
    against gesvd's 6e-7 and LAPACK's 3e-6; scripts/svd_drivers.py)."""
    diff = finetune.to(torch.float32) - base.to(torch.float32)
    driver = {"driver": "gesvd"} if diff.is_cuda else {}
    u, s, vt = torch.linalg.svd(diff, full_matrices=False, **driver)
    r = min(rank, s.shape[0])
    a = u[:, :r] * s[:r][None, :]
    return LoRADelta(a=a.contiguous(), b=vt[:r, :].contiguous())


def dequantize_lora(delta: LoRADelta, dtype=torch.float32) -> torch.Tensor:
    return matmul_f32(delta.a, delta.b).to(dtype)


def apply_lora(base: torch.Tensor, delta: LoRADelta) -> torch.Tensor:
    return (base.to(torch.float32) + dequantize_lora(delta)).to(base.dtype)


def lora_nbytes(delta: LoRADelta) -> int:
    return (delta.a.numel() + delta.b.numel()) * delta.a.element_size()


class TernaryDelta(NamedTuple):
    """{-1, 0, +1} delta: two packed planes + an fp32 scale.

    plus / minus are int32-packed boolean masks (ops/packing layout):
    value = scale * (plus - minus).
    """

    plus: torch.Tensor
    minus: torch.Tensor
    scale: torch.Tensor


def _quantile(a: torch.Tensor, q: float, method: str) -> torch.Tensor:
    """``jnp.quantile(a, q, method=method)`` over every element, in
    JAX's arithmetic: any NaN makes the result NaN; on a sorted flat fp32
    copy the position ``q * (n - 1)`` is taken in fp32 (``n`` itself
    rounded to fp32), then its floor and ceil are clamped to ``n - 1``
    (also fp32) and gathered, an index past the end clamped to the last
    element as XLA's gather clamps it. Not ``torch.quantile``: it refuses
    more than 2^24 elements. ``method``: ``"linear"`` or
    ``"midpoint"`` (``jnp.median``)."""
    flat = a.reshape(-1).to(torch.float32)
    size = flat.numel()
    flat = torch.where(torch.isnan(flat).any(),
                       torch.full_like(flat, float("nan")), flat)
    srt = torch.sort(flat).values
    f32 = dict(dtype=torch.float32, device=flat.device)
    n = torch.tensor(float(size), **f32)
    pos = torch.tensor(q, **f32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    zero = torch.zeros((), **f32)
    low = torch.clamp(torch.maximum(low, zero), max=n - 1)
    high = torch.clamp(torch.maximum(high, zero), max=n - 1)
    low_value = srt[low.to(torch.int64).clamp(max=size - 1)]
    high_value = srt[high.to(torch.int64).clamp(max=size - 1)]
    if method == "linear":
        # XLA contracts this sum into one fused multiply-add of the high
        # term, fma(high_value, high_weight, low_value * low_weight): the
        # fp32 product is exact in fp64, and the sum is rounded to fp32
        # (once, but for a double-rounding tie). A position of 2^23 or
        # more is an integer in fp32: the high weight is 0 and the result
        # is the low value.
        low_term = (low_value * low_weight).to(torch.float64)
        high_term = (high_value.to(torch.float64)
                     * high_weight.to(torch.float64))
        return (low_term + high_term).to(torch.float32)
    if method == "midpoint":
        return (low_value + high_value) * 0.5
    raise ValueError(f"unknown quantile method {method!r}")


def quantize_ternary(base: torch.Tensor, finetune: torch.Tensor,
                     fraction: float = 0.5,
                     binary_median: bool = False) -> TernaryDelta:
    """Keep the largest-|delta| ``fraction`` of entries as ±1, zero the
    rest; scale = mean |delta| over the kept entries.

    ``binary_median=True``: every entry keeps its sign (no zeros), and the
    scale is |delta|'s median (``jnp.median``'s midpoint rule).
    """
    diff = finetune.to(torch.float32) - base.to(torch.float32)
    mag = diff.abs()
    if binary_median:
        scale = _quantile(mag, 0.5, "midpoint")
        plus = diff >= 0
        minus = diff < 0
    else:
        # 1.0 - fraction in Python (float64), then fp32, as in JAX.
        thresh = _quantile(mag, 1.0 - fraction, "linear")
        keep = mag >= thresh
        scale = (mag * keep).sum() / torch.clamp(keep.sum(), min=1)
        plus = keep & (diff >= 0)
        minus = keep & (diff < 0)
    return TernaryDelta(plus=pack_signs(plus), minus=pack_signs(minus),
                        scale=scale.to(torch.float32))


def dequantize_ternary(delta: TernaryDelta,
                       dtype=torch.float32) -> torch.Tensor:
    plus = unpack_signs(delta.plus).to(torch.float32)
    minus = unpack_signs(delta.minus).to(torch.float32)
    return (delta.scale * (plus - minus)).to(dtype)


def apply_ternary(base: torch.Tensor, delta: TernaryDelta) -> torch.Tensor:
    return (base.to(torch.float32)
            + dequantize_ternary(delta)).to(base.dtype)


class ColumnScaleDelta(NamedTuple):
    """1-bit signs + one fp32 scale per OUTPUT COLUMN.

    packed: int32 ``(*, K//32, N)`` sign bits (the layout of
    :class:`~bitdelta_torch.core.delta.BinaryDelta`).
    scale:  fp32 ``(*, N)``: ``mean_k |diff[:, n]|``, the L2-optimal
    1-bit scale of each column, so the reconstruction error is never
    worse than one scale a matrix.
    """

    packed: torch.Tensor
    scale: torch.Tensor


def quantize_column(base: torch.Tensor, finetune: torch.Tensor, *,
                    zero_sign: str = "positive") -> ColumnScaleDelta:
    """Per-column 1-bit quantization of ``finetune - base``; the fp32 diff
    feeds both the column scales and the sign packing."""
    diff = finetune.to(torch.float32) - base.to(torch.float32)
    scale = diff.abs().mean(dim=-2)  # (*, N)
    return ColumnScaleDelta(packed=pack_signs(delta_signs(diff, zero_sign)),
                            scale=scale)


def dequantize_column(delta: ColumnScaleDelta,
                      dtype=torch.float32) -> torch.Tensor:
    pm1 = unpack_to_pm1(delta.packed, torch.float32)
    return (delta.scale[..., None, :] * pm1).to(dtype)


def apply_column(base: torch.Tensor, delta: ColumnScaleDelta) -> torch.Tensor:
    return (base.to(torch.float32)
            + dequantize_column(delta)).to(base.dtype)


def column_delta_linear(x: torch.Tensor, base_w: torch.Tensor,
                        delta: ColumnScaleDelta, *,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ W_base + (x @ sign) * scale[None, :]``: the per-column scale
    rides on the output of the plain binary matmul at scale 1."""
    y_base = matmul_f32(x.to(compute_dtype), base_w.to(compute_dtype))
    y_sign = binary_matmul(x, delta.packed, 1.0,
                           compute_dtype=compute_dtype).to(torch.float32)
    y = y_base + y_sign * delta.scale[..., None, :]
    return y.to(x.dtype)


def fuse_variant_model(base_params, finetuned_params, kind: str, **kw):
    """Whole-model delta-fidelity ablation: compress every projection with
    the chosen variant and return DENSE fused params for the PPL
    evaluator (the reference's ablations all evaluate through dense
    fusion).

    kind: ``"binary"`` (the production 1-bit path, through
    ``core.compress``), ``"binary_median"`` (takes no extra kwargs),
    ``"ternary"`` (``fraction=``), ``"lora"`` (``rank=``), or
    ``"column"`` (per-output-column scales). Embeddings / norms / head
    carry the fine-tuned values, as ``compress_model``'s extras do.

    Works on both param layouts: llama-family (PROJ_NAMES, stacked
    ``(L, K, N)``) and Mixtral (attention projections, expert stacks
    ``(L, E, K, N)`` and the router, detected by the ``w1`` layer key);
    the variants quantize one matrix at a time over every leading axis.
    """
    from ..core.compress import compress_model, fuse_compressed
    from ..models.llama import PROJ_NAMES

    moe = "w1" in base_params["layers"]
    if kind == "binary":
        if moe:
            from ..models.mixtral import compress_mixtral as compress
        else:
            compress = compress_model
        return fuse_compressed(
            base_params, compress(base_params, finetuned_params, **kw))

    quantize_apply = {
        "binary_median": (lambda b, f: quantize_ternary(
            b, f, binary_median=True), apply_ternary),
        "ternary": (lambda b, f: quantize_ternary(b, f, **kw),
                    apply_ternary),
        "lora": (lambda b, f: quantize_lora(b, f, **kw), apply_lora),
        "column": (lambda b, f: quantize_column(b, f, **kw), apply_column),
    }
    if kind not in quantize_apply:
        raise ValueError(f"unknown variant kind: {kind!r}")
    if kind == "binary_median" and kw:
        # A silently dropped kwarg in an ablation tool gives wrong
        # comparisons; binary_median is parameterless by construction.
        raise TypeError(f"binary_median takes no extra kwargs, got "
                        f"{sorted(kw)}")
    quantize, apply_ = quantize_apply[kind]

    def per_matrix(b, f):
        """Quantize + apply one 2-D matrix at a time over any leading
        stack axes, into one preallocated output."""
        out = torch.empty_like(b)
        flat_out = out.reshape((-1,) + tuple(b.shape[-2:]))
        flat_b = b.reshape(flat_out.shape)
        flat_f = f.reshape(flat_out.shape)
        for i in range(flat_out.shape[0]):
            flat_out[i] = apply_(flat_b[i], quantize(flat_b[i], flat_f[i]))
        return out

    if moe:
        from ..models.mixtral import MOE_PARTS as names
    else:
        names = PROJ_NAMES
    params = dict(finetuned_params)
    params["layers"] = dict(finetuned_params["layers"])
    for name in names:
        params["layers"][name] = per_matrix(base_params["layers"][name],
                                            finetuned_params["layers"][name])
    return params
