"""Numerics of the tensor-core W4 kernel (row 8,
``bitdelta_torch/csrc/int4_gemm.cu::w4_matmul_tc_kernel``) on the CPU,
before the card.

The kernel turns each packed word into bf16 pairs in registers: the word
XORed with 0x88888888, then for i = 0..3 ``((q >> 4i) & 0x000F000F) |
0x43004300`` (the bf16 pair 128 + q), minus 136 by one bf16x2 FMA; so
register i holds nibbles (i, i + 4). A numpy model of that conversion is
held bit for bit against ``_unpack_nibbles`` of both packages. The kernel
lets each nibble sit where the conversion puts it and permutes K to
match: lane t of K step j = 2u + h reads word row (and x octet) 4u + t,
and MMA K positions 2t, 2t + 1, 2t + 8, 2t + 9 take registers 2h (low,
high) and 2h + 1 (low, high); x's octet is turned into the pairs
(x_i, x_{i+4}) by ``byte_perm`` with selectors 0x5410 and 0x7632. A model
of the lanes checks that every position of A and B holds the same K and
that the 128 K of a group are each taken once.

A plain-torch model of the kernel's arithmetic (weights from the
conversion model, K in the kernel's order, bf16 products, each K step's
16 products summed in fp32 into a per-group accumulator that starts from
zero, the group's sum times its scale rounded to fp32 and added to the
running sum, the K splits of ``ops/int4.py::_splits`` added in split
order) is held against interpret-mode ``w4_matmul_pallas`` and the
port's ``int4_matmul`` on the same numpy-seeded inputs. Tolerance: 1e-4
of the reference's largest |value|, as the card holds the kernel against
its plain version (both sum exact products in fp32, in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.ops.pallas_int4 import w4_matmul_pallas
from bitdelta_tpu.research import quantized_base as jqb
from bitdelta_torch.ops import int4 as ti
from bitdelta_torch.research import quantized_base as tqb

GROUP = 128
EDGE_WORDS = (0x00000000, 0x88888888, 0xFFFFFFFF, 0x77777777, 0x01234567,
              0xFEDCBA98)


def convert_words(words):
    """The kernel's conversion of uint32 ``words`` (any shape): float32
    values ``(..., 4, 2)``, ``[..., i, 0]`` from the low half of
    register i and ``[..., i, 1]`` from its high half."""
    q = words.astype(np.uint32) ^ np.uint32(0x88888888)
    regs = []
    for i in range(4):
        b = ((q >> np.uint32(4 * i)) & np.uint32(0x000F000F)) \
            | np.uint32(0x43004300)
        halves = np.stack([b & 0xFFFF, b >> 16], -1).astype(np.uint16)
        pair = torch.from_numpy(halves.view(np.int16)).view(torch.bfloat16)
        # fma.rn.bf16x2(pair, 1.0, -136.0): the exact result rounded to
        # bf16 once.
        regs.append((pair.float() - 136.0).to(torch.bfloat16).float())
    return torch.stack(regs, -2).numpy()


def nibble_of(i, half):
    """The nibble (K row within the word) in half ``half`` of register
    ``i``."""
    return i + 4 * half


def byte_perm(a, b, sel):
    """CUDA's ``__byte_perm(a, b, sel)`` on uint32 scalars."""
    src = int(a) | (int(b) << 32)
    out = 0
    for n in range(4):
        pick = (sel >> (4 * n)) & 0x7
        out |= ((src >> (8 * pick)) & 0xFF) << (8 * n)
    return out


def x_pairs(octet_bits):
    """The kernel's B registers from one x octet (8 bf16 as 16-bit
    patterns): ``(x_i, x_{i+4})`` for i = 0..3 as (low, high) patterns."""
    w = [int(octet_bits[2 * j]) | (int(octet_bits[2 * j + 1]) << 16)
         for j in range(4)]
    regs = [byte_perm(w[0], w[2], 0x5410), byte_perm(w[0], w[2], 0x7632),
            byte_perm(w[1], w[3], 0x5410), byte_perm(w[1], w[3], 0x7632)]
    return [(r & 0xFFFF, r >> 16) for r in regs]


def group_k_order():
    """``order[j]``: the 16 K rows (within a group) of K step j, in MMA
    position order 0..15, from the A side (word row and nibble of each
    lane's registers)."""
    order = np.zeros((8, 16), dtype=np.int64)
    for j in range(8):
        u, h = divmod(j, 2)
        for t in range(4):
            row = 4 * u + t
            for p, (i, half) in ((2 * t, (2 * h, 0)), (2 * t + 1, (2 * h, 1)),
                                 (2 * t + 8, (2 * h + 1, 0)),
                                 (2 * t + 9, (2 * h + 1, 1))):
                order[j, p] = 8 * row + nibble_of(i, half)
    return order


def _words(seed, count=4096):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2 ** 32, size=count, dtype=np.uint64)
    return np.concatenate([np.array(EDGE_WORDS, dtype=np.uint64),
                           rand]).astype(np.uint32)


@pytest.mark.parametrize("unpack", ["jax", "torch"])
def test_conversion_matches_unpack_nibbles(unpack):
    words = _words(0)
    packed = words.view(np.int32).reshape(1, -1)
    if unpack == "jax":
        want = np.asarray(jqb._unpack_nibbles(jnp.asarray(packed)))
    else:
        want = tqb._unpack_nibbles(torch.from_numpy(packed)).numpy()
    got = convert_words(words)                         # (W, 4, 2)
    for i in range(4):
        for half in range(2):
            s = nibble_of(i, half)
            np.testing.assert_array_equal(got[:, i, half], want[s])


def test_conversion_edge_words():
    got = convert_words(np.array([0x00000000, 0x88888888, 0xFFFFFFFF],
                                 dtype=np.uint32))
    np.testing.assert_array_equal(got[0], np.zeros((4, 2)))
    np.testing.assert_array_equal(got[1], np.full((4, 2), -8.0))
    np.testing.assert_array_equal(got[2], np.full((4, 2), -1.0))


def test_k_permutation_pairs_weights_with_their_x():
    order = group_k_order()
    assert sorted(order.ravel().tolist()) == list(range(GROUP))
    # x of the group: element k holds the bf16 pattern of float k (exact
    # below 256), so a B half names the K it came from.
    marks = torch.arange(GROUP, dtype=torch.float32).to(torch.bfloat16)
    bits = marks.view(torch.int16).numpy().view(np.uint16)
    for j in range(8):
        u, h = divmod(j, 2)
        for t in range(4):
            octet = 4 * u + t
            pairs = x_pairs(bits[8 * octet:8 * octet + 8])
            b0, b1 = pairs[2 * h], pairs[2 * h + 1]
            for p, pattern in ((2 * t, b0[0]), (2 * t + 1, b0[1]),
                               (2 * t + 8, b1[0]), (2 * t + 9, b1[1])):
                k_of_x = torch.from_numpy(np.array(
                    [pattern], dtype=np.uint16).view(np.int16)).view(
                    torch.bfloat16).item()
                assert k_of_x == order[j, p], (j, t, p)


def kernel_model(x, packed, scale):
    """The tensor-core kernel's arithmetic in plain torch. x ``(M, K)``
    bf16, packed ``(K/8, N)`` int32, scale ``(K/128, N)`` fp32; returns
    ``(M, N)`` fp32."""
    m, k = x.shape
    n = packed.shape[1]
    n_groups = k // GROUP
    vals = convert_words(packed.numpy().view(np.uint32))  # (K/8, N, 4, 2)
    w = np.zeros((k, n), dtype=np.float32)
    for i in range(4):
        for half in range(2):
            w[nibble_of(i, half)::8] = vals[:, :, i, half]
    w = torch.from_numpy(w)
    xf = x.float()
    order = torch.from_numpy(group_k_order())
    n_split = ti._splits(n, n_groups)
    out = torch.zeros((m, n))
    for s in range(n_split):
        g0, g1 = s * n_groups // n_split, (s + 1) * n_groups // n_split
        tot = torch.zeros((m, n))
        for g in range(g0, g1):
            acc = torch.zeros((m, n))
            for j in range(8):
                rows = g * GROUP + order[j]
                # bf16 x nibble products are exact in fp32.
                prod = xf[:, rows, None] * w[rows][None]      # (M, 16, N)
                acc = acc + prod.sum(1)
            tot = tot + acc * scale[g]
        out = out + tot
    return out


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("k", [128, 1024])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_kernel_arithmetic_matches_pallas_and_int4_matmul(m, k, n):
    rng = np.random.default_rng(1000 * m + k + n)
    w = tqb.quantize_int4(torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.02).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(torch.bfloat16)
    got = kernel_model(x, w.packed, w.scale)
    pallas = np.asarray(w4_matmul_pallas(
        jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16),
        jnp.asarray(w.packed.numpy()), jnp.asarray(w.scale.numpy()),
        interpret=True, out_dtype=jnp.float32))
    plain = tqb.int4_matmul(x, w, compute_dtype=torch.bfloat16,
                            out_dtype=torch.float32)
    for want in (torch.from_numpy(pallas.copy()), plain):
        tol = 1e-4 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol
