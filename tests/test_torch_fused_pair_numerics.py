"""Numerics of row 10's tensor-core kernel
(``bitdelta_torch/csrc/binary_gemm.cu::fused_pair_tc_kernel``, after row
1's ``pair_prep_kernel``) on the CPU, before the card.

A block owns FP_BJ pair columns (2 * FP_BJ natural columns: the low
halves of one 128-column pair group, then the high halves), every row of
a slab of up to 32 and one K split; a warp owns 8 pair columns, one m16
tile. Two products share that tile:

* the base on ``mma.sync.m16n8k16`` (bf16, fp32 sums), W as the A
  operand by ``ldmatrix.trans`` from a shared tile of W rows (each shared
  row one K at the block's natural columns), the slab's x rows as B by
  ``ldmatrix``; m16 row g is the low natural column of pair column
  8 * warp + g, row g + 8 its high column, so they are the rows of row
  1's 1-bit A fragment for that pair column;
* the delta on ``m16n8k256 .and.popc``: a ring stage is half a 256-K
  chunk, so an MMA takes two tenants, tenant j's words in A's first 128 K
  and tenant j + 1's in the second, with B the same bit planes twice,
  each masked to the row slots of its tenant. Row slots are the slab's
  rows ordered by tenant (order of first occurrence).

Each stage's base sums start from zero and are added to a running fp32
sum; each stage's popcounts are weighted by their planes and added to
integer sums. The D fragments meet in shared memory (base: lane (g, t)
holds batch rows 8nt + 2t, + 1; delta: slot 4r4 + t), the K splits of a
tile add their partials in rank order, and the epilogue is row 1's.

Numpy models here check the ldmatrix fragments against the PTX layouts,
the column maps, the two-tenant 1-bit fragments, the meeting of the D
fragments and the rank-ordered cluster sum, lane by lane; and a model of
the kernel's arithmetic (slabs, stages, passes of 4 tenants, slot groups
and masks, splits) is held against ``fused_base_pair_matmul_plain``: its
integer sums exactly (the delta alone bit for bit against
``tenant_delta_matmul_pair_plain``), the output within 1e-4 of its
largest |value| (the fp32 base sums run in another order), at K = 1040
(a multiple of 16, not 32: the prep's 16-wide tail), B = 9 and B = 65
(three launches). Against interpret-mode ``fused_base_pair_matmul_pallas``
(which takes K a multiple of 32 only) the same 1e-4, plus 2 * a1 for each
x grid point that JAX's compiled step puts one level apart (as
tests/test_torch_pair_numerics.py explains).
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

FP_BJ = 32                 # pair columns a block
FP_KS = 128                # K a ring stage (half a 256-K chunk)
SLAB = 32                  # rows a main-kernel launch takes
DT = 4                     # tenants' words a stage holds
PLANES = 12                # bits of the x grid
CHUNK = 256                # K of one 1-bit MMA
TOL = 1e-4                 # of the output's largest |value|


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


def bits(r):
    r = np.asarray(r, np.uint64)
    return np.stack([(r >> np.uint64(i)) & np.uint64(1) for i in range(32)],
                    -1).astype(np.uint8)


def natural_col(pc, high):
    """Natural column of pair column ``pc``'s low (0) or high (1) half."""
    return (pc // 128) * 256 + pc % 128 + 128 * high


# --- ldmatrix and the m16n8k16 fragments ------------------------------------

def ldsm_x4(tile, rows, cols, trans):
    """``ldmatrix.sync.aligned.m8n8.x4[.trans].b16`` over a 2-D shared
    ``tile``: lane l gives the address (rows[l], cols[l]) of row l % 8 of
    matrix l // 8 (8 contiguous elements). Returns ``(32, 4, 2)``: lane
    (g, t) register m holds (M[g][2t], M[g][2t + 1]), or (M[2t][g],
    M[2t + 1][g]) transposed, with M[i][j] = tile[rows[8m + i],
    cols[8m + i] + j]."""
    out = np.zeros((32, 4, 2), tile.dtype)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for m in range(4):
            for e in range(2):
                i, j = (2 * t + e, g) if trans else (g, 2 * t + e)
                out[lane, m, e] = tile[rows[8 * m + i], cols[8 * m + i] + j]
    return out


def w_lane_addr(warp, kk):
    """The kernel's ldmatrix.trans addresses of W for k16 step kk: lane l
    gives stage row 16kk + (l / 16) * 8 + l % 8 at the warp's low (l / 8
    even) or high shared columns."""
    lane = np.arange(32)
    rows = 16 * kk + (lane // 16) * 8 + lane % 8
    cols = ((lane // 8) % 2) * FP_BJ + 8 * warp
    return rows, cols


def x_lane_addr(nt, kk):
    """The kernel's ldmatrix addresses of x for k16 steps kk, kk + 1 of
    n8 tile nt: lane l gives slab row 8nt + l % 8 at K 16kk + 8 (l / 8)."""
    lane = np.arange(32)
    return nt * 8 + lane % 8, 16 * kk + (lane // 8) * 8


def a_frag(a):
    """The PTX A fragment of a 16x16 ``a`` (m16n8k16, row): ``(32, 4, 2)``,
    lane (g, t): a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3
    (g + 8, 2t + 8..)."""
    out = np.zeros((32, 4, 2), a.dtype)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for m, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            out[lane, m] = a[r, c:c + 2]
    return out


def b_frag(b):
    """The PTX B fragment of a 16x8 ``b`` (col): ``(32, 2, 2)``, lane
    (g, t): b0 (2t.., g), b1 (2t + 8.., g)."""
    out = np.zeros((32, 2, 2), b.dtype)
    for lane in range(32):
        g, t = divmod(lane, 4)
        out[lane, 0] = b[2 * t:2 * t + 2, g]
        out[lane, 1] = b[2 * t + 8:2 * t + 10, g]
    return out


def mma_16816(afr, b0b1):
    """D (16x8) of m16n8k16 from lane fragments, returned as the PTX D
    fragment ``(32, 4)``: c0, c1 (g, 2t..), c2, c3 (g + 8, 2t..)."""
    a = np.zeros((16, 16), np.float64)
    b = np.zeros((16, 8), np.float64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for m, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            a[r, c:c + 2] = afr[lane, m]
        b[2 * t:2 * t + 2, g] = b0b1[lane, 0]
        b[2 * t + 8:2 * t + 10, g] = b0b1[lane, 1]
    d = a @ b
    out = np.zeros((32, 4))
    for lane in range(32):
        g, t = divmod(lane, 4)
        out[lane] = d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t], \
            d[g + 8, 2 * t + 1]
    return out


@pytest.mark.parametrize("warp", range(FP_BJ // 8))
def test_base_a_fragment_is_w_transposed(warp):
    # The shared W stage holds value 1000 * k + c at (row k, column c).
    tile = (1000 * np.arange(FP_KS)[:, None]
            + np.arange(2 * FP_BJ)[None, :]).astype(np.int64)
    for kk in range(FP_KS // 16):
        got = ldsm_x4(tile, *w_lane_addr(warp, kk), trans=True)
        # A[row][k] = W[16kk + k][the shared column of m16 row ``row``].
        cols = np.r_[8 * warp + np.arange(8), FP_BJ + 8 * warp + np.arange(8)]
        a = tile[16 * kk:16 * kk + 16][:, cols].T
        np.testing.assert_array_equal(got, a_frag(a))


@pytest.mark.parametrize("nt", range(4))
def test_base_b_fragments_are_x_rows(nt):
    # Shared x: value 1000 * row + k. One ldmatrix.x4 gives b0, b1 of k16
    # steps kk and kk + 1, with B[k][n] = x[8nt + n][16kk + k].
    tile = (1000 * np.arange(32)[:, None]
            + np.arange(FP_KS)[None, :]).astype(np.int64)
    for kk in range(0, FP_KS // 16, 2):
        got = ldsm_x4(tile, *x_lane_addr(nt, kk), trans=False)
        for step in range(2):
            b = tile[8 * nt:8 * nt + 8, 16 * (kk + step):
                     16 * (kk + step) + 16].T
            np.testing.assert_array_equal(got[:, 2 * step:2 * step + 2],
                                          b_frag(b))


@pytest.mark.parametrize("seed", range(3))
def test_base_mma_from_shared_tiles(seed):
    # W and x through the kernel's ldmatrix addresses into m16n8k16: D
    # holds x @ W at (m16 row = natural column, n8 column = batch row).
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((FP_KS, 2 * FP_BJ))
    x = rng.standard_normal((8, FP_KS))
    for warp in range(FP_BJ // 8):
        d = np.zeros((32, 4))
        for kk in range(0, FP_KS // 16, 2):
            xb = ldsm_x4(x, *x_lane_addr(0, kk), trans=False)
            for step in range(2):
                a = ldsm_x4(w, *w_lane_addr(warp, kk + step), trans=True)
                d += mma_16816(a, xb[:, 2 * step:2 * step + 2])
        want = x @ w                                   # (rows, columns)
        for lane in range(32):
            g, t = divmod(lane, 4)
            lo, hi = 8 * warp + g, FP_BJ + 8 * warp + g
            np.testing.assert_allclose(
                d[lane], [want[2 * t, lo], want[2 * t + 1, lo],
                          want[2 * t, hi], want[2 * t + 1, hi]],
                rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [256, 1024, 14336])
def test_m16_rows_are_the_pair_columns_of_the_1bit_a(n):
    # Block tile pc0 = FP_BJ * tile: its shared column c < FP_BJ is natural
    # column nlo + c, c >= FP_BJ natural nlo + 128 + c - FP_BJ; m16 row g of
    # warp w is shared column 8w + g, row g + 8 shared column FP_BJ + 8w +
    # g. The 1-bit A row g reads the word of pair column pc0 + 8w + g, row
    # g + 8 its high half: the same natural columns. Every natural column
    # belongs to one (tile, warp, row) only.
    seen = np.zeros(n, int)
    for tile in range(n // 2 // FP_BJ):
        pc0 = tile * FP_BJ
        nlo = (pc0 // 128) * 256 + pc0 % 128
        for w in range(FP_BJ // 8):
            for g in range(8):
                lo = nlo + 8 * w + g
                hi = nlo + 128 + (FP_BJ + 8 * w + g - FP_BJ)
                assert lo == natural_col(pc0 + 8 * w + g, 0)
                assert hi == natural_col(pc0 + 8 * w + g, 1)
                seen[[lo, hi]] += 1
    assert (seen == 1).all()


# --- the 1-bit product over half chunks, two tenants an MMA -------------------

def half_a(words_j, words_j1, lane):
    """Lane ``lane``'s A registers for one pair column in a stage: a0 / a1
    from tenant j's word rows 2t, 2t + 1 of the half chunk (its 8 word
    rows ``words_j``), a2 / a3 from tenant j + 1's."""
    t = lane % 4
    wj = np.asarray(words_j, np.uint32)
    wk = np.asarray(words_j1, np.uint32)
    return (byte_perm(wj[2 * t], wj[2 * t + 1], 0x5410),
            byte_perm(wj[2 * t], wj[2 * t + 1], 0x7632),
            byte_perm(wk[2 * t], wk[2 * t + 1], 0x5410),
            byte_perm(wk[2 * t], wk[2 * t + 1], 0x7632))


def half_a_bits(words_j, words_j1):
    """A's 256 K positions for the low (0) and high (1) column: positions
    32t + i from a0 / a1 (tenant j), 128 + 32t + i from a2 / a3."""
    out = np.zeros((2, CHUNK), np.uint8)
    for t in range(4):
        a0, a1, a2, a3 = half_a(words_j, words_j1, t)
        out[0, 32 * t:32 * t + 32] = bits(a0)
        out[1, 32 * t:32 * t + 32] = bits(a1)
        out[0, 128 + 32 * t:160 + 32 * t] = bits(a2)
        out[1, 128 + 32 * t:160 + 32 * t] = bits(a3)
    return out


def natural_half_bits(words):
    """A stage's sign bits of a pair column in natural K order, ``(2,
    128)``: word row r holds K 16r .. 16r + 15, low half then high."""
    b = bits(words)                                     # (8, 32)
    return np.stack([b[:, :16].reshape(-1), b[:, 16:].reshape(-1)])


@pytest.mark.parametrize("seed", range(4))
def test_two_tenants_fill_one_mma(seed):
    rng = np.random.default_rng(seed)
    wj = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    wk = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    got = half_a_bits(wj, wk)
    np.testing.assert_array_equal(got[:, :128], natural_half_bits(wj))
    np.testing.assert_array_equal(got[:, 128:], natural_half_bits(wk))


@pytest.mark.parametrize("seed", range(3))
def test_masked_planes_count_each_slot_against_its_own_tenant(seed):
    # One group of 4 slots over tenants (d, d + 1): B column 2i + e is
    # plane 2pp + e of slot i, given twice (b0 for positions < 128, b1 for
    # the rest) and masked by the slot's tenant. popc(A & B) then counts
    # each slot's bits against its own tenant's words only.
    rng = np.random.default_rng(seed)
    wj = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    wk = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
    a = half_a_bits(wj, wk).astype(np.int64)             # (2, 256)
    xbits = rng.integers(0, 2, (4, PLANES, 128))          # slot, plane, K
    slot_t = rng.integers(0, 3, 4)                        # 0: j, 1: j+1, 2
    for pp in range(6):
        for n in range(8):
            i, e = divmod(n, 2)
            plane = xbits[i, 2 * pp + e]
            b = np.r_[plane * (slot_t[i] == 0), plane * (slot_t[i] == 1)]
            d = a @ b                                     # low, high
            own = (natural_half_bits(wj) if slot_t[i] == 0 else
                   natural_half_bits(wk) if slot_t[i] == 1 else
                   np.zeros((2, 128), np.uint8)).astype(np.int64)
            np.testing.assert_array_equal(d, own @ plane)


# --- slots, the meeting of the D fragments, the cluster's sum ----------------

def slot_plan(ids):
    """The kernel's bookkeeping for one slab: each row's tenant rank d
    (order of first occurrence), the slots (rows by d, then row), each
    slot's d, the distinct tenants, and each group of 4 slots' bitmask of
    the d it holds."""
    ids = [int(i) for i in ids]
    first = [ids.index(i) for i in ids]
    d = [sum(first[j] == j for j in range(f)) for f in first]
    order = sorted(range(len(ids)), key=lambda r: (d[r], r))
    slot_d = [d[r] for r in order]
    tenants = [ids[r] for r in range(len(ids)) if first[r] == r]
    groups = -(-len(ids) // 4)
    gmask = [0] * groups
    for s, dd in enumerate(slot_d):
        gmask[s // 4] |= 1 << dd
    return order, slot_d, tenants, gmask


def test_slots_order_rows_by_tenant():
    order, slot_d, tenants, gmask = slot_plan([0, 1, 2, 0, 1, 2, 0, 0])
    assert order == [0, 3, 6, 7, 1, 4, 2, 5]
    assert slot_d == [0, 0, 0, 0, 1, 1, 2, 2]
    assert tenants == [0, 1, 2] and gmask == [0b001, 0b110]
    order, slot_d, tenants, gmask = slot_plan([5, 5, 3, 9, 3])
    assert order == [0, 1, 2, 4, 3] and tenants == [5, 3, 9]
    assert slot_d == [0, 0, 1, 1, 2] and gmask == [0b011, 0b100]


@pytest.mark.parametrize("ids", [[0, 1, 2, 0, 1, 2, 0, 0], list(range(9)),
                                 [4] * 32, [3, 1, 3, 1, 0, 2, 2, 2, 1, 0, 3]])
def test_d_fragments_meet_in_the_epilogue(ids):
    # The base D puts lane (g, t)'s tot[nt][e] at (row 8nt + 2t + e, low
    # column 8w + g) and tot[nt][2 + e] at the high column FP_BJ + 8w + g;
    # the delta puts s_lo / s_hi of group r4 at (the row of slot 4r4 + t,
    # the same two columns). Every (row, column) of the slab gets one of
    # each, from the same lane of the same warp.
    slab = len(ids)
    nt_count = 1 if slab <= 8 else 2 if slab <= 16 else 4
    order, *_ = slot_plan(ids)
    base = {}
    delta = {}
    for w in range(FP_BJ // 8):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for nt in range(nt_count):
                for e in range(2):
                    r = nt * 8 + 2 * t + e
                    for c in (8 * w + g, FP_BJ + 8 * w + g):
                        assert (r, c) not in base
                        base[(r, c)] = (w, g)
            for r4 in range(2 * nt_count):
                slot = 4 * r4 + t
                if slot < slab:
                    for c in (8 * w + g, FP_BJ + 8 * w + g):
                        key = (order[slot], c)
                        assert key not in delta
                        delta[key] = (w, g)
    cells = {(r, c) for r in range(slab) for c in range(2 * FP_BJ)}
    assert set(delta) == cells
    assert cells <= set(base)
    assert all(base[key] == delta[key] for key in cells)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_cluster_sum_in_rank_order(splits):
    # Block q of the cluster reduces columns q * slice .. for every row,
    # adding rank 0, 1, .. in order: every column once, and the sum is the
    # sequential fp32 one whichever block does it.
    rng = np.random.default_rng(splits)
    parts = (rng.standard_normal((splits, 5, 2 * FP_BJ))
             * 10.0 ** rng.integers(-3, 4, (splits, 5, 2 * FP_BJ))
             ).astype(np.float32)
    slice_ = 2 * FP_BJ // splits
    out = np.full((5, 2 * FP_BJ), np.nan, np.float32)
    for q in range(splits):
        cols = slice(q * slice_, (q + 1) * slice_)
        acc = parts[0, :, cols].copy()
        for r in range(1, splits):
            acc = (acc + parts[r, :, cols]).astype(np.float32)
        assert np.isnan(out[:, cols]).all()
        out[:, cols] = acc
    want = parts[0].copy()
    for r in range(1, splits):
        want = (want + parts[r]).astype(np.float32)
    np.testing.assert_array_equal(out, want)


# --- the kernel's arithmetic --------------------------------------------------

def prep_model(x, scales, ids):
    """Row 1's prep in numpy float32 for any K that is a multiple of 16:
    ``(xq (B, K) int64, sxq, a1, a2)``."""
    xf = np.asarray(x, np.float32)
    lo, hi = xf.min(1), xf.max(1)
    step = np.maximum((hi - lo) / np.float32(tbg.PAIR_Q_LEVELS),
                      np.float32(1e-30)).astype(np.float32)
    xq = np.rint((xf - lo[:, None]) / step[:, None]).astype(np.int64)
    alpha = np.asarray(scales, np.float32)[ids]
    return (xq, xq.sum(1).astype(np.float32),
            (alpha * step).astype(np.float32),
            (alpha * lo).astype(np.float32))


def pair_signs(pairs):
    """``(T, K/16, N/2)`` pair words -> ``(T, K, N)`` sign bits."""
    t, k16, n2 = pairs.shape
    b = bits(pairs.view(np.uint32))                      # (T, K16, N2, 32)
    low = b[..., :16].transpose(0, 1, 3, 2).reshape(t, 16 * k16, n2)
    high = b[..., 16:].transpose(0, 1, 3, 2).reshape(t, 16 * k16, n2)
    n = 2 * n2
    out = np.zeros((t, 16 * k16, n), np.uint8)
    cols = np.arange(n2)
    out[:, :, natural_col(cols, 0)] = low
    out[:, :, natural_col(cols, 1)] = high
    return out


def kernel_model(x, w, pairs, colsum, scales, ids, splits=2):
    """The launches' arithmetic in numpy: for each slab of SLAB rows and
    K split, each stage's base product (float32) added to a running fp32
    sum; each stage's 1-bit product for each pass of DT tenants and group
    of 4 slots, two tenants an MMA with the planes masked to their slots,
    the popcounts weighted by 2^p; the splits added in rank order; row
    1's epilogue and one add. Returns ``(y (B, N) float32, S (B, N)
    int64)``."""
    bsz, k = x.shape
    t_count, k16, n2 = pairs.shape
    n = 2 * n2
    xq, sxq, a1, a2 = prep_model(x, scales, ids)
    n_st = -(-k // FP_KS)
    kp = n_st * FP_KS
    xqp = np.zeros((bsz, kp), np.int64)
    xqp[:, :k] = xq
    xbits = np.stack([(xqp >> p) & 1 for p in range(PLANES)], 1)  # B, P, K
    signs = np.zeros((t_count, kp, n), np.int64)
    signs[:, :k] = pair_signs(pairs)
    x32 = np.zeros((bsz, kp), np.float32)
    x32[:, :k] = x
    w32 = np.zeros((kp, n), np.float32)
    w32[:k] = w
    weight = np.int64(1) << np.arange(PLANES, dtype=np.int64)
    splits = min(splits, n_st)
    y = np.zeros((bsz, n), np.float32)
    s_all = np.zeros((bsz, n), np.int64)
    for row0 in range(0, bsz, SLAB):
        rows = np.arange(row0, min(bsz, row0 + SLAB))
        order, slot_d, tenants, gmask = slot_plan(ids[rows])
        slot_rows = rows[order]
        base_parts = np.zeros((splits, len(rows), n), np.float32)
        s_parts = np.zeros((splits, len(rows), n), np.int64)
        for sp in range(splits):
            h0, h1 = sp * n_st // splits, (sp + 1) * n_st // splits
            tot = np.zeros((len(rows), n), np.float32)
            s_slot = np.zeros((len(rows), n), np.int64)
            for p0 in range(0, len(tenants), DT):     # passes
                for h in range(h0, h1):
                    ks = slice(h * FP_KS, (h + 1) * FP_KS)
                    if p0 == 0:
                        acc = x32[rows, ks] @ w32[ks]
                        tot = (tot + acc).astype(np.float32)
                    for r4, gm in enumerate(gmask):
                        slots = np.arange(4 * r4, min(4 * r4 + 4, len(rows)))
                        for jp in range(0, DT, 2):
                            if not (gm >> p0 >> jp) & 3:
                                continue
                            d = np.zeros((len(slots), PLANES, n), np.int64)
                            for j in (jp, jp + 1):
                                if p0 + j >= len(tenants):
                                    continue
                                mask = np.array([slot_d[s] == p0 + j
                                                 for s in slots])
                                xb = xbits[slot_rows[slots]][:, :, ks] \
                                    * mask[:, None, None]
                                d += np.einsum("spk,kn->spn", xb,
                                               signs[tenants[p0 + j], ks])
                            s_slot[slots] += np.einsum("spn,p->sn", d,
                                                       weight)
            base_parts[sp] = tot
            s_parts[sp][order] = s_slot                # slot -> slab row
        base = base_parts[0]
        s_sum = s_parts[0].copy()
        for sp in range(1, splits):                    # rank order
            base = (base + base_parts[sp]).astype(np.float32)
            s_sum += s_parts[sp]
        assert np.abs(s_sum).max() < 2 ** 31
        f32 = np.float32
        two_a1 = (f32(2.0) * a1[rows])[:, None]
        off = (a1[rows] * sxq[rows])[:, None]
        delta = (two_a1 * s_sum.astype(np.float32)
                 + (a2[rows][:, None] * colsum[ids[rows]] - off))
        y[rows] = (base + delta).astype(np.float32)
        s_all[rows] = s_sum
    return y, s_all


def pair_world(seed, bsz, t, k, n, ids=None):
    """bf16-valued x and W, random pair words (any K a multiple of 16),
    their colsum, scales and ids."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, k)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    w = torch.from_numpy((0.02 * rng.standard_normal((k, n))).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    pairs = rng.integers(0, 2 ** 32, (t, k // 16, n // 2),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    colsum = (2.0 * pair_signs(pairs).sum(1) - k).astype(np.float32)
    scales = rng.uniform(0.001, 0.02, (t,)).astype(np.float32)
    ids = rng.integers(0, t, bsz) if ids is None else np.asarray(ids)
    return x, w, pairs, colsum, scales, ids.astype(np.int64)


def torch_args(x, w, pairs, colsum, scales, ids):
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(pairs),
            torch.from_numpy(colsum), torch.from_numpy(scales),
            torch.from_numpy(ids))


def test_pair_world_matches_the_packages_pair_layout():
    # The words built here pair up as both packages' pair_delta does.
    rng = np.random.default_rng(0)
    signs = rng.integers(0, 2, (2, 64, 512)).astype(bool)
    pd = jpair_delta(JBinaryDelta(packed=jpack(jnp.asarray(signs)),
                                  scale=jnp.ones(2)))
    np.testing.assert_array_equal(
        pair_signs(np.asarray(pd.packed_pairs)), signs.astype(np.uint8))
    np.testing.assert_array_equal(
        (2.0 * signs.sum(1) - 64).astype(np.float32), np.asarray(pd.colsum))


# (B, T, K, N, ids, splits): K = 1040 (the prep's 16-wide tail, a
# stage cut short), B = 9 (two n8 tiles), B = 65 (launches of 32, 32 and
# 1 rows), one tenant, every row its own (passes of 4 tenants), 32
# distinct tenants in one slab (8 passes).
CASES = [(9, 3, 1040, 256, None, 2), (65, 3, 1040, 256, None, 8),
         (8, 3, 4096, 512, [0, 1, 2, 0, 1, 2, 0, 0], 4),
         (8, 2, 1040, 768, [1] * 8, 1), (11, 11, 528, 256, list(range(11)), 2),
         (32, 32, 272, 256, list(range(31, -1, -1)), 1),
         (20, 6, 2064, 256, None, 8)]


@pytest.mark.parametrize("bsz,t,k,n,ids,splits", CASES)
def test_kernel_model_matches_plain(bsz, t, k, n, ids, splits):
    world = pair_world(bsz * 7 + k, bsz, t, k, n, ids)
    x, w, pairs, colsum, scales, ids = world
    y, s = kernel_model(*world, splits=splits)
    # The integer sums, exactly: S[b, n] = sum_k bit[t_b, k, n] * xq[b, k].
    xq = prep_model(x, scales, ids)[0]
    signs = pair_signs(pairs).astype(np.int64)
    want_s = np.einsum("bk,bkn->bn", xq, signs[ids])
    np.testing.assert_array_equal(s, want_s)
    args = torch_args(*world)
    want = tbg.fused_base_pair_matmul_plain(*args).numpy()
    assert np.abs(y - want).max() <= TOL * np.abs(want).max()
    # Over a zero W the model is the delta alone, bit for bit the plain one.
    y0, _ = kernel_model(x, np.zeros_like(w), pairs, colsum, scales, ids,
                         splits=splits)
    want0 = tbg.tenant_delta_matmul_pair_plain(
        args[0], *args[2:]).numpy()
    np.testing.assert_array_equal(y0, want0)


@pytest.mark.parametrize("bsz,t,k,n,ids", [(9, 3, 1024, 256, None),
                                           (8, 3, 4096, 256,
                                            [0, 1, 2, 0, 1, 2, 0, 0]),
                                           (65, 4, 1024, 256, None)])
def test_kernel_model_matches_pallas(bsz, t, k, n, ids):
    world = pair_world(bsz + 3 * k, bsz, t, k, n, ids)
    x, w, pairs, colsum, scales, ids = world
    y, _ = kernel_model(*world, splits=4)
    want = np.asarray(jpb.fused_base_pair_matmul_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(pairs), jnp.asarray(colsum), jnp.asarray(scales),
        jnp.asarray(ids, jnp.int32), interpret=True,
        out_dtype=jnp.float32))
    # JAX's compiled step may put an x grid point one level from the
    # IEEE one (tests/test_torch_pair_numerics.py): 2 * a1 a moved point.
    xq, _, a1, _ = prep_model(x, scales, ids)
    j_xq = np.asarray(jax.jit(jpb._pair_quantize)(
        jnp.asarray(x), jnp.asarray(scales),
        jnp.asarray(ids, jnp.int32))[0]).reshape(xq.shape)
    moved = np.abs(j_xq - xq)
    assert moved.max() <= 1
    tol = TOL * np.abs(want).max() + 2 * np.abs(a1) * moved.sum(1)
    assert (np.abs(y - want) <= tol[:, None]).all()


def test_stages_cover_k_once_per_split():
    # Stage h of split sp covers K 128h .. 128h + 127; the splits' stage
    # ranges partition the stages, whatever the split count.
    for k in (16, 1040, 4096, 14336):
        n_st = -(-k // FP_KS)
        for splits in (1, 2, 4, 8):
            splits_ = min(splits, n_st)
            seen = np.zeros(n_st, int)
            for sp in range(splits_):
                seen[sp * n_st // splits_:(sp + 1) * n_st // splits_] += 1
            assert (seen == 1).all()
