"""Peaks of one NVIDIA H100 SXM and the work each measured kernel and
each whole step needs, counted from the model's shapes and the batch's
composition (never from what a kernel happens to read), so a later kernel
or an unfused path is held to the same work.

The peaks are NVIDIA's data sheet figures for the SXM part at 700 W,
dense rates without sparsity. A roofline share is the least time the
chip could take (the larger of bytes over bandwidth and operations over
the compute peak) divided by the kernels' device time.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_BYTES_S = 3.35e12        # HBM3 bandwidth
PEAK_BF16_S = 989e12          # dense bf16 / fp16 tensor-core rate
PEAK_FP32_S = 67e12           # fp32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float, peak_ops: float = PEAK_BF16_S
            ) -> float:
    """Least seconds for ``n_bytes`` moved and ``n_ops`` operations."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / peak_ops)


def pair_delta_work(k: int, n: int, live_rows: int, matrices: int,
                    x_bytes: int = 2) -> Tuple[float, float]:
    """Row 1 (``tenant_delta_matmul_pair``; ``pair_prep_kernel`` +
    ``pair_delta_tc_kernel``): ``Y[b] = s[id_b] * (x_b @ sign(W[id_b]))``
    over the live rows. Bytes: each distinct routed matrix's sign words
    (K*N/8), its column sums (4 N) and scale once, each live row's x once
    and its fp32 output once. Operations: 2 K N a live row."""
    n_bytes = (matrices * (k * n / 8 + 4 * n + 4)
               + live_rows * (k * x_bytes + 4 * n))
    return n_bytes, 2.0 * live_rows * k * n


def flash_decode_work(lengths: Iterable[int], n_heads: int, n_kv: int,
                      head_dim: int, kv_bytes: int = 2,
                      q_bytes: int = 2) -> Tuple[float, float]:
    """Row 2 (``flash_decode_attention``; ``flash_decode_split_kernel`` +
    ``flash_decode_merge_kernel``) over the live lanes of one layer:
    each live key's K and V once, each lane's query and output once.
    Operations: 4 * heads * head_dim a live key (QK and PV)."""
    lengths = list(lengths)
    keys, lanes = sum(lengths), len(lengths)
    n_bytes = (keys * 2 * n_kv * head_dim * kv_bytes
               + lanes * 2 * n_heads * head_dim * q_bytes)
    return n_bytes, 4.0 * n_heads * head_dim * keys


def binary_matmul_work(m: int, k: int, n: int, x_bytes: int = 2
                       ) -> Tuple[float, float]:
    """Row 5 (``binary_matmul``: ``binary_matmul_kernel`` +
    ``binary_splits_kernel``), ``scale * (x @ sign(W))`` with x ``(M,
    K)``: the sign words once, x once, the fp32 output once; 2 M K N
    operations on the bf16 tensor cores. Row 6 (``binary_matmul_t``,
    ``g @ sign(W).T`` with g ``(M, N)``, ``binary_matmul_t_kernel``) has
    the same counts with K and N in each other's place for x and the
    output: call it with ``(m, n, k)``."""
    n_bytes = k * n / 8 + m * k * x_bytes + m * n * 4
    return n_bytes, 2.0 * m * k * n


def dense_params_per_token(shapes: Dict[str, int]) -> float:
    """Weights a token's forward runs through in the dense fine-tune: the
    attention projections, the MLP (the routed experts and the router for
    a mixture of experts) and the head; the embedding is a lookup."""
    d, hd = shapes["hidden"], shapes["head_dim"]
    q, kv = shapes["heads"] * hd, shapes["kv_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    mlp = 3 * d * shapes["intermediate"]
    experts = shapes.get("experts", 0)
    if experts:
        mlp = mlp * shapes["experts_per_token"] + d * experts
    return shapes["layers"] * (attn + mlp) + d * shapes["vocab"]


def attention_flops(shapes: Dict[str, int], queries: int, keys: float
                    ) -> float:
    """QK and PV of ``queries`` queries over ``keys`` keys each (summed
    over queries when ``keys`` is a total), every layer."""
    per = 4.0 * shapes["heads"] * shapes["head_dim"]
    return shapes["layers"] * per * queries * keys


def decode_token_flops(shapes: Dict[str, int], context: int) -> float:
    """One decoded token at ``context`` keys (itself included)."""
    return (2.0 * dense_params_per_token(shapes)
            + attention_flops(shapes, 1, context))


def prefill_flops(shapes: Dict[str, int], length: int) -> float:
    """A prompt of ``length`` tokens, causal: query i sees i + 1 keys."""
    keys = length * (length + 1) / 2.0
    return (2.0 * dense_params_per_token(shapes) * length
            + attention_flops(shapes, 1, keys))


def distill_step_flops(shapes: Dict[str, int], batch: int, length: int
                       ) -> float:
    """One scale-distillation step of the dense fine-tune's work: the
    teacher's forward, the student's forward and the student's backward
    to its activations (as much again as a forward)."""
    return 3.0 * batch * prefill_flops(shapes, length)
