"""Numerics of the tensor-core pair kernel (row 1,
``bitdelta_torch/csrc/binary_gemm.cu::pair_prep_kernel`` and
``pair_delta_tc_kernel``) on the CPU, before the card.

The main kernel runs the 1-bit MMA
``mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc``: A (16 output
columns x 256 K) is the sign bits themselves, B (256 K x 8) bit planes of
x's 12-bit grid, and D = popc(A & B) counts, exactly. Lane (g, t) holds K
32t .. 32t + 31 of its A row (registers a0 low column, a1 high column)
and 128 + 32t .. (a2, a3); a pair word holds 16 K of a low and a high
column, so ``prmt(w[2t], w[2t + 1], 0x5410)`` (the low halves) is a0 and
``0x7632`` (the high halves) a1, from the chunk's words 8 + 2t, 9 + 2t a2
and a3: K keeps its natural order. The prep writes each 32 K of x as
twelve words (word p: plane p, bit i for K + i, one warp ballot each),
a chunk's 32-K groups j = 0..7 one after the other; lane t reads plane P
of groups t (its b0) and t + 4 (b1). B's 8 columns in tile
(r4, pp) are planes 2pp + e of row slot 4*r4 + i at column 2i + e, so
the lane holding C columns 2t, 2t + 1 holds planes of its own slot and
``S = sum_p 2^p * D_p`` adds up in registers.

A numpy model of the lanes checks that every (column, K) of a chunk is
taken once, that A and B agree on K and that C's columns are the slots and
planes B's loads put there; a model of the prep (planes, sxq, a1, a2) is
held bit for bit against ``_pair_quantize`` of both packages; and a model
of the kernel's integer arithmetic (a launch a slab of 64 rows,
per-split popcounts, the planes weighted and added, one block column per
distinct tenant of the slab and group of rows, the K splits (1, 2 or 8;
the card picks the count from its multiprocessors) added in a cluster's
rank order, row 1's fp32 epilogue) is held bit for bit against
``tenant_delta_matmul_pair_plain`` and against interpret-mode
``tenant_delta_matmul_pair_pallas`` within 4 ulp of ``alpha * (xmax -
xmin) * K`` (the tolerance of tests/test_torch_kernels.py: JAX adds each
2048- or 4096-K block's ``2 * a1 * S`` in fp32, and those cancelling
epilogue terms set the rounding) plus ``2 * a1`` for each x grid point
that JAX's compiled step puts one level apart: under ``jit`` XLA divides
by 4095 as a multiply by its reciprocal, where ``_pair_quantize`` run op
by op (held bit for bit here) divides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.core.delta import BinaryDelta as JBinaryDelta
from bitdelta_tpu.core.delta import pair_delta as jpair_delta
from bitdelta_tpu.ops import pallas_binary_gemm as jpb
from bitdelta_tpu.ops.packing import pack_signs as jpack
from bitdelta_torch.ops import binary_gemm as tbg

PLANES = 12                # bits of the x grid
CHUNK = 256                # K of one 1-bit MMA
SLAB = 64                  # rows a main-kernel launch takes
EDGE_WORDS = (0x00000000, 0xFFFFFFFF, 0x80000001, 0x0000FFFF, 0xFFFF0000,
              0x12345678)


def byte_perm(a, b, sel):
    """CUDA's ``__byte_perm(a, b, sel)`` on uint32 arrays."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    src = [(a >> np.uint64(8 * i)) & np.uint64(255) for i in range(4)] + \
          [(b >> np.uint64(8 * i)) & np.uint64(255) for i in range(4)]
    out = np.zeros_like(a)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 0x7] << np.uint64(8 * n)
    return out.astype(np.uint32)


def lane_a(words, lane):
    """Lane ``lane``'s A registers (a0, a1, a2, a3) from the 16 word rows
    of one chunk of a pair column: ``words`` ``(..., 16)`` uint32."""
    w = np.asarray(words, np.uint32)
    t = lane
    return (byte_perm(w[..., 2 * t], w[..., 2 * t + 1], 0x5410),
            byte_perm(w[..., 2 * t], w[..., 2 * t + 1], 0x7632),
            byte_perm(w[..., 8 + 2 * t], w[..., 9 + 2 * t], 0x5410),
            byte_perm(w[..., 8 + 2 * t], w[..., 9 + 2 * t], 0x7632))


def bits(r):
    r = np.asarray(r, np.uint64)
    return np.stack([(r >> np.uint64(i)) & np.uint64(1) for i in range(32)],
                    -1).astype(np.uint8)


def a_bits(words):
    """A of one chunk as the lanes hold it: ``(..., 2 halves, 256)``;
    K position 32t + i of a row is bit i of lane t's a0 (low column) or a1
    (high column), 128 + 32t + i bit i of a2 / a3."""
    out = np.zeros(np.shape(words)[:-1] + (2, CHUNK), np.uint8)
    for t in range(4):
        a0, a1, a2, a3 = lane_a(words, t)
        out[..., 0, 32 * t:32 * t + 32] = bits(a0)
        out[..., 1, 32 * t:32 * t + 32] = bits(a1)
        out[..., 0, 128 + 32 * t:160 + 32 * t] = bits(a2)
        out[..., 1, 128 + 32 * t:160 + 32 * t] = bits(a3)
    return out


def b_bits(chunk, plane):
    """B of one chunk and plane as lane t reads it: ``chunk`` ``(..., 96)``
    uint32 as the prep stores a chunk (12 plane words for each of its 8
    32-K groups); b0 (K 32t + i) is word 12t + plane, b1 (K 128 + 32t +
    i) word 12(t + 4) + plane. Returns ``(..., 256)``."""
    chunk = np.asarray(chunk, np.uint32)
    out = np.zeros(chunk.shape[:-1] + (CHUNK,), np.uint8)
    for t in range(4):
        out[..., 32 * t:32 * t + 32] = bits(chunk[..., PLANES * t + plane])
        out[..., 128 + 32 * t:160 + 32 * t] = bits(
            chunk[..., PLANES * (t + 4) + plane])
    return out


def _words(seed, count=512):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2 ** 32, size=(count, 16), dtype=np.uint64)
    edge = np.repeat(np.array(EDGE_WORDS, np.uint64)[:, None], 16, 1)
    return np.concatenate([edge, rand]).astype(np.uint32)


def natural_bits(words):
    """``(..., 2, 256)``: the chunk's sign bits of the low (0) and high (1)
    column in natural K order, straight from the pair layout (word r holds
    K 16r .. 16r + 15 of the low column in bits 0-15, of the high one in
    16-31)."""
    b = bits(words)                                    # (..., 16, 32)
    low = b[..., :16].reshape(b.shape[:-2] + (CHUNK,))
    high = b[..., 16:].reshape(b.shape[:-2] + (CHUNK,))
    return np.stack([low, high], -2)


# --- the word -> A fragment conversion ---------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_fragments_hold_the_chunk_in_natural_order(seed):
    words = _words(seed)
    np.testing.assert_array_equal(a_bits(words), natural_bits(words))


def test_edge_words():
    ones = np.full(16, 0xFFFFFFFF, np.uint32)
    zeros = np.zeros(16, np.uint32)
    np.testing.assert_array_equal(a_bits(ones), 1)
    np.testing.assert_array_equal(a_bits(zeros), 0)
    w = np.full(16, 0x80000001, np.uint32)        # low K 0, high K 15
    want = np.zeros((2, CHUNK), np.uint8)
    want[0, 0::16] = 1
    want[1, 15::16] = 1
    np.testing.assert_array_equal(a_bits(w), want)


@pytest.mark.parametrize("row", range(16))
def test_one_hot_bits_land_once(row):
    # Each bit of each word row alone: exactly one A bit is set, in its
    # own column half and at its K.
    for bit in range(32):
        w = np.zeros(16, np.uint32)
        w[row] = np.uint32(1 << bit)
        got = a_bits(w)
        half, k = divmod(bit, 16)
        want = np.zeros((2, CHUNK), np.uint8)
        want[half, 16 * row + k] = 1
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mt_count", [1, 2, 4])
def test_every_column_and_k_taken_once_in_a_warp(mt_count):
    # The PTX fragment layout of m16n8k256 .b1: A a0 (row g, K 32t + i),
    # a1 (row g + 8, same K), a2 / a3 (K 128 + 32t + i); B b0 (K 32t + i,
    # column g), b1 (K 128 + 32t + i); C c0 / c1 (row g, columns 2t,
    # 2t + 1), c2 / c3 (row g + 8). The kernel's maps: m-tile mt row g is
    # the low column of pair column mt_count*g + mt, row g + 8 its high
    # column; tile (r4, pp) column n is plane 2pp + n%2 of slot 4r4 + n//2.
    seen = set()
    for mt in range(mt_count):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for reg in range(4):
                half = reg % 2
                for i in range(32):
                    key = (mt_count * g + mt, half, 128 * (reg // 2)
                           + 32 * t + i)
                    assert key not in seen
                    seen.add(key)
    assert seen == {(c, h, k) for c in range(8 * mt_count)
                    for h in range(2) for k in range(CHUNK)}
    # B's column n of tile (r4, pp), as lane g = n loads it, and C's
    # column 2t + e, as lane (g', t) holds it, name the same slot / plane.
    for r4 in range(4):
        for pp in range(6):
            for n in range(8):
                b_slot, b_plane = 4 * r4 + n // 2, 2 * pp + n % 2
                t, e = divmod(n, 2)
                assert (b_slot, b_plane) == (4 * r4 + t, 2 * pp + e)
    # B's K at each position: bit 0 of group j's plane-p word is K 32j.
    for j in range(8):
        for p in (0, 5, 11):
            chunk = np.zeros(8 * PLANES, np.uint32)
            chunk[PLANES * j + p] = 1
            assert np.flatnonzero(b_bits(chunk, p)).tolist() == [32 * j]
            assert not b_bits(chunk, (p + 1) % PLANES).any()


# --- the prep kernel ---------------------------------------------------------

def prep_planes(xq):
    """The prep kernel's bit planes of integer rows ``xq`` ``(B, K)``:
    ``(B, chunks, 96)`` uint32 as stored (for each 32-K group of a chunk,
    its 12 plane words), K past the end zero."""
    bsz, k = xq.shape
    n_chunks = -(-k // CHUNK)
    q = np.zeros((bsz, n_chunks * CHUNK), np.int64)
    q[:, :k] = xq
    q = q.reshape(bsz, n_chunks, 8, 32)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    out = np.zeros((bsz, n_chunks, 8, PLANES), np.uint32)
    for p in range(PLANES):
        plane = ((q >> p) & 1).astype(np.uint64)
        out[..., p] = (plane * weights).sum(-1).astype(np.uint32)
    return out.reshape(bsz, n_chunks, 8 * PLANES)


def prep_model(x, scales, ids):
    """The prep kernel's arithmetic in numpy float32: ``(planes, xq,
    sxq, a1, a2)``."""
    xf = np.asarray(x, np.float32)
    lo = xf.min(1)
    hi = xf.max(1)
    step = np.maximum((hi - lo) / np.float32(tbg.PAIR_Q_LEVELS),
                      np.float32(1e-30)).astype(np.float32)
    xq = np.rint((xf - lo[:, None]) / step[:, None]).astype(np.int64)
    alpha = np.asarray(scales, np.float32)[ids]
    return (prep_planes(xq), xq, xq.sum(1).astype(np.float32),
            (alpha * step).astype(np.float32),
            (alpha * lo).astype(np.float32))


def _hard_rows(rng, k):
    """Rows with ties (an exact 0..4095 range and half-integer values),
    a constant row, a tiny range, +-1e30 and ordinary values."""
    ties = rng.integers(0, 4095, k).astype(np.float32) + np.float32(0.5)
    ties[:2] = 0.0, 4095.0
    const = np.full(k, -3.25, np.float32)
    tiny = np.full(k, 1.0, np.float32)
    tiny[::7] = np.nextafter(np.float32(1.0), np.float32(2.0))
    large = rng.standard_normal(k).astype(np.float32) * np.float32(1e30)
    normal = rng.standard_normal(k).astype(np.float32)
    return np.stack([ties, const, tiny, large, normal])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [64, 4096])
def test_prep_matches_pair_quantize_of_both_packages(dtype, k):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(_hard_rows(rng, k)).to(dtype)
    xf = x.float().numpy()
    scales = np.asarray([0.7, 1.3, 0.011], np.float32)
    ids = np.asarray([2, 0, 1, 1, 0], np.int64)
    planes, xq, sxq, a1, a2 = prep_model(xf, scales, ids)
    # The planes hold xq: every K once, read back through the lanes.
    back = np.zeros((len(ids), planes.shape[1] * CHUNK), np.int64)
    for p in range(PLANES):
        back += b_bits(planes, p).reshape(len(ids), -1).astype(
            np.int64) << p
    np.testing.assert_array_equal(back[:, :k], xq)
    np.testing.assert_array_equal(back[:, k:], 0)
    assert xq.min() >= 0 and xq.max() <= tbg.PAIR_Q_LEVELS
    t_xq, t_sxq, t_a1, t_a2 = tbg._pair_quantize(
        x, torch.from_numpy(scales), torch.from_numpy(ids))
    j_xq, j_sxq, j_a1, j_a2 = jpb._pair_quantize(
        jnp.asarray(xf), jnp.asarray(scales), jnp.asarray(ids))
    for got, want in ((xq, t_xq.numpy()),
                      (xq, np.asarray(j_xq).reshape(len(ids), k))):
        np.testing.assert_array_equal(got, want)
    for got, t_want, j_want in ((sxq, t_sxq, j_sxq), (a1, t_a1, j_a1),
                                (a2, t_a2, j_a2)):
        np.testing.assert_array_equal(got, t_want.numpy())
        np.testing.assert_array_equal(got, np.asarray(j_want))


def test_ties_round_half_to_even():
    x = np.zeros((1, 32), np.float32)
    x[0, 0], x[0, 1] = 0.0, 4095.0
    x[0, 2:6] = 0.5, 1.5, 2.5, 4094.5
    _, xq, _, _, _ = prep_model(x, np.ones(1, np.float32), np.zeros(1, int))
    assert xq[0, :6].tolist() == [0, 4095, 0, 2, 2, 4094]
    t_xq = tbg._pair_quantize(torch.from_numpy(x), torch.ones(1),
                              torch.zeros(1, dtype=torch.int64))[0]
    np.testing.assert_array_equal(t_xq.numpy(), xq)


# --- the main kernel's arithmetic --------------------------------------------

def distinct_tenants(ids):
    """Distinct tenants in order of first occurrence (the blocks' d)."""
    out = []
    for t in ids:
        if t not in out:
            out.append(int(t))
    return out


def block_rows(slab):
    """Rows one block takes in a launch of ``slab`` rows (16 / MT)."""
    return 4 if slab <= 4 else 8 if slab <= 8 else 16


def kernel_model(x, pairs, colsum, scales, ids, splits=2):
    """The launches' arithmetic in numpy: the prep's planes; for each slab
    of SLAB rows, each (column tile, K split, tenant, group of rows) block
    counting popc(A & B) per 256-K chunk, the planes weighted by 2^p and
    added, kept for that group's rows; the ``splits`` of a cluster added
    in rank order; the fp32 epilogue, written in natural column order.
    Returns ``(B, N)`` float32."""
    bsz, k = x.shape
    t_count, k16, n2 = pairs.shape
    n = 2 * n2
    n_chunks = -(-k // CHUNK)
    planes, _, sxq, a1, a2 = prep_model(x, scales, ids)
    xb = np.stack([b_bits(planes, p) for p in range(PLANES)],
                  2).astype(np.int64)                     # (B, C, 12, 256)
    words = np.zeros((t_count, n_chunks * 16, n2), np.uint32)
    words[:, :k16] = pairs.view(np.uint32)                # zero rows past K
    words = words.reshape(t_count, n_chunks, 16, n2)
    splits = min(splits, n_chunks)
    weight = np.int64(1) << np.arange(PLANES, dtype=np.int64)
    parts = np.zeros((splits, bsz, 2, n2), np.int64)
    taken = np.zeros((bsz, splits), np.int64)
    for row0 in range(0, bsz, SLAB):
        slab = ids[row0:row0 + SLAB]
        tenants = distinct_tenants(slab)
        assert len(tenants) <= min(len(slab), t_count)  # the grid's extent
        group = block_rows(len(slab))
        for t in tenants:
            mine = row0 + np.flatnonzero(slab == t)
            # (chunks, pair columns, 2 halves, 256 K) of the tenant.
            a = a_bits(words[t].transpose(0, 2, 1)).astype(np.int64)
            for q in range(0, len(mine), group):
                rows = mine[q:q + group]
                for sp in range(splits):
                    c0 = sp * n_chunks // splits
                    c1 = (sp + 1) * n_chunks // splits
                    # D[r, p, j, h] = popc(A & B) over the split's chunks.
                    d = np.einsum("cjhk,rcpk->rpjh", a[c0:c1],
                                  xb[rows, c0:c1])
                    part = np.einsum("rpjh,p->rhj", d, weight)
                    assert part.max() < 2 ** 31
                    parts[sp, rows] = part
                    taken[rows, sp] += 1
    assert (taken == 1).all()              # every row, every split, once
    sums = np.zeros((bsz, 2, n2), np.int64)
    for sp in range(splits):               # the cluster's rank order
        sums += parts[sp]
    assert sums.max() < 2 ** 31
    f32 = np.float32
    two_a1 = (f32(2.0) * a1)[:, None]
    off = (a1 * sxq)[:, None]
    cs = colsum[ids].reshape(bsz, n // 256, 2, 128).transpose(0, 2, 1, 3)
    cs = cs.reshape(bsz, 2, n2)
    y = np.zeros((bsz, 2, n2), np.float32)
    for h in range(2):
        y[:, h] = two_a1 * sums[:, h].astype(np.float32) + (
            a2[:, None] * cs[:, h] - off)
    return y.reshape(bsz, 2, n // 256, 128).transpose(0, 2, 1, 3).reshape(
        bsz, n)


def _world(seed, bsz, t, k, n, ids):
    rng = np.random.default_rng(seed)
    signs = rng.integers(0, 2, (t, k, n)).astype(bool)
    scales = rng.uniform(0.001, 0.02, (t,)).astype(np.float32)
    pd = jpair_delta(JBinaryDelta(packed=jpack(jnp.asarray(signs)),
                                  scale=jnp.asarray(scales)))
    x = torch.from_numpy(rng.standard_normal((bsz, k)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    return (x, np.array(pd.packed_pairs), np.array(pd.colsum), scales,
            np.asarray(ids, np.int64))


# Duplicate tenants, absent tenants (T > distinct), one row, all rows on
# one tenant, every row its own tenant, and more rows of one tenant than a
# block takes (two groups of 16 at B = 20).
CASES = [(1, 4, [3]), (3, 6, [4, 0, 4]), (8, 3, [0, 1, 2, 0, 1, 2, 0, 0]),
         (8, 5, [2, 2, 2, 2, 2, 2, 2, 2]),
         (11, 12, [0, 2, 2, 5, 7, 0, 9, 11, 2, 5, 10]),
         (20, 2, [1] * 17 + [0] * 3)]


# K = 96: one chunk, partly past the end.
@pytest.mark.parametrize("k", [4096, 14336, 96])
@pytest.mark.parametrize("bsz,t,ids", CASES)
def test_kernel_model_matches_plain_exactly(bsz, t, ids, k):
    x, pairs, colsum, scales, ids = _world(bsz + k, bsz, t, k, 256, ids)
    got = kernel_model(x, pairs, colsum, scales, ids)
    want = tbg.tenant_delta_matmul_pair_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pairs),
        torch.from_numpy(colsum), torch.from_numpy(scales),
        torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("bsz,t,ids", [CASES[0], CASES[1], CASES[2],
                                       CASES[4]])
def test_kernel_model_matches_pallas(bsz, t, ids, k):
    x, pairs, colsum, scales, ids = _world(7 * bsz + k, bsz, t, k, 256, ids)
    got = kernel_model(x, pairs, colsum, scales, ids)
    want = np.asarray(jpb.tenant_delta_matmul_pair_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(pairs),
        jnp.asarray(colsum), jnp.asarray(scales),
        jnp.asarray(ids, jnp.int32), interpret=True,
        out_dtype=jnp.float32))
    term = float(scales.max()) * float(np.ptp(x, axis=1).max()) * k
    # Compiled, JAX's step is (xmax - xmin) * fl(1/4095) (XLA turns the
    # division by a constant into a multiply), not the IEEE quotient of
    # its source, the port and the kernel; each x grid point where the
    # two steps round apart moves a column by 2 * a1 at most.
    _, xq, _, a1, _ = prep_model(x, scales, ids)
    j_xq = np.asarray(jax.jit(jpb._pair_quantize)(
        jnp.asarray(x), jnp.asarray(scales),
        jnp.asarray(ids, jnp.int32))[0]).reshape(xq.shape)
    moved = np.abs(j_xq - xq)
    assert moved.max() <= 1
    tol = 4 * float(np.spacing(np.float32(term))) \
        + 2 * np.abs(a1) * moved.sum(1)
    assert (np.abs(got - want) <= tol[:, None]).all()


# More rows than a launch takes: Mistral at 72 slots (a tenant across the
# slab boundary), 130 rows over 4 tenants (three launches, the last of two
# rows) and Mixtral's routed rows at 33 slots (66 rows, (tenant, expert)
# stack entries of 2 tenants x 8 experts), each at 1, 2 and 8 K splits.
SLAB_CASES = [(72, 3, None), (130, 4, None), (66, 16, None)]


@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("bsz,t,ids", SLAB_CASES)
def test_kernel_model_over_slabs_matches_plain_exactly(bsz, t, ids, splits):
    rng = np.random.default_rng(bsz * t)
    ids = rng.integers(0, t, bsz) if ids is None else ids
    x, pairs, colsum, scales, ids = _world(bsz + t, bsz, t, 2048, 256, ids)
    got = kernel_model(x, pairs, colsum, scales, ids, splits=splits)
    want = tbg.tenant_delta_matmul_pair_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pairs),
        torch.from_numpy(colsum), torch.from_numpy(scales),
        torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_distinct_tenants_in_order_of_first_occurrence():
    assert distinct_tenants(np.array([2, 0, 2, 5, 0])) == [2, 0, 5]
    assert distinct_tenants(np.array([1] * 70)) == [1]
