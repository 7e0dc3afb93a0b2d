"""Numerics of row 3's tensor-core kernel
(``bitdelta_torch/csrc/binary_gemm.cu::tenant_dense_tc_kernel``) on the
CPU, before the card; and the port's mixed-dtype dense matmul against
interpret-mode JAX.

``Y[b] = x[b] @ W[ids[b]]``, x ``(B, K)`` bf16, W ``(T, K, N)`` bf16, fp32
out. A launch takes a slab of up to 128 rows. A work unit is one
distinct tenant (rank d, order of first occurrence) and up to R = 8 NT of
its rows in row order (NT = 1, 2 or 4 n8 tiles by the slab's size); a
block owns one unit, one K split and 128 columns (two 64-column W boxes;
a warp 16 columns, one m16 tile). W arrives by TMA through a 3-D tensor
map over (N, K, T) with the 128-byte swizzle, box {64, 128, 1}; the
unit's x rows by cp.async. On ``mma.sync.m16n8k16`` W is the A operand
by ``ldmatrix.trans`` and the unit's rows the n8 side by ``ldmatrix``;
each 128-deep stage sums into a fresh fp32 accumulator that is added to
a running fp32 sum; a tile's K splits add their partials in rank order.

Numpy models here check, lane by lane, the swizzled W fragments against
W transposed (and free of bank conflicts), the x fragments against the
unit's rows, the device's unit bookkeeping against a plain plan, the 3-D
map's zeros past K, the partials' layout and the rank-ordered split sum;
and a model of the kernel's arithmetic is held against
``tenant_dense_matmul_plain`` and interpret-mode
``tenant_dense_matmul_pallas`` within 1e-4 of the output's largest
|value| (products of bf16 values are exact in fp32; the sums run in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.ops import pallas_binary_gemm as jpb
from bitdelta_torch.ops import binary_gemm as tbg
from tests.test_torch_fused_pair_numerics import (a_frag, b_frag, ldsm_x4,
                                                  mma_16816, slot_plan)

BOX = 64                   # columns of a W box (128 bytes: one swizzle span)
BOXES = 2                  # W boxes a block
COLS = BOX * BOXES         # output columns a block
KS = 128                   # K a ring stage
SLAB = 128                 # rows a launch takes
XROW = KS * 2 + 16         # bytes of a shared x row
PSTRIDE = COLS + 4         # floats of a partials row
MAX_SPLITS = 8
TOL = 1e-4                 # of the output's largest |value|


def nt_of(slab):
    return 1 if slab <= 8 else 2 if slab <= 16 else 4


# --- W by TMA, 128-byte swizzle, into ldmatrix.trans ------------------------

def swizzled(tile):
    """A ``(rows, 64)`` box as TMA's 128-byte swizzle stores it: row r's
    16-byte chunk c at chunk c ^ (r % 8)."""
    out = np.zeros_like(tile)
    for r in range(tile.shape[0]):
        for c in range(8):
            p = c ^ (r % 8)
            out[r, 8 * p:8 * p + 8] = tile[r, 8 * c:8 * c + 8]
    return out


def stage_w(tile):
    """The stage's W boxes side by side, each swizzled on its own."""
    return np.concatenate([swizzled(tile[:, BOX * b:BOX * (b + 1)])
                           for b in range(BOXES)], axis=1)


def w_lane_addr(warp, kk):
    """The kernel's ldmatrix.trans addresses of W for k16 step kk: lane l
    gives stage row 16kk + (l / 16) * 8 + l % 8, chunk 2 (warp % 4) +
    (l / 8) % 2 of box warp / 4, stored at that chunk ^ (l % 8)."""
    lane = np.arange(32)
    rows = 16 * kk + (lane // 16) * 8 + lane % 8
    chunk = 2 * (warp % 4) + (lane // 8) % 2
    cols = (warp // 4) * BOX + 8 * (chunk ^ (lane % 8))
    return rows, cols


def x_lane_addr(nt, kk):
    """The kernel's ldmatrix addresses of x for k16 steps kk, kk + 1 of n8
    tile nt: lane l gives slot 8nt + l % 8 at K 16kk + 8 (l / 8)."""
    lane = np.arange(32)
    return nt * 8 + lane % 8, 16 * kk + (lane // 8) * 8


@pytest.mark.parametrize("warp", range(4 * BOXES))
def test_w_a_fragment_is_w_transposed(warp):
    # The shared W stage holds value 1000 * k + c at (row k, column c).
    tile = (1000 * np.arange(KS)[:, None]
            + np.arange(COLS)[None, :]).astype(np.int64)
    phys = stage_w(tile)
    c0 = BOX * (warp // 4) + 16 * (warp % 4)
    for kk in range(KS // 16):
        got = ldsm_x4(phys, *w_lane_addr(warp, kk), trans=True)
        # A[m][k] = W[16kk + k][the warp's column m].
        a = tile[16 * kk:16 * kk + 16, c0:c0 + 16].T
        np.testing.assert_array_equal(got, a_frag(a))


@pytest.mark.parametrize("warp", range(4 * BOXES))
def test_ldmatrix_reads_are_free_of_bank_conflicts(warp):
    # Each 8-lane matrix of one ldmatrix reads 8 rows of 16 bytes: a box
    # row is 128 bytes, so the 8 must sit in 8 distinct 16-byte bank
    # groups. Likewise the x rows, 272 bytes apart.
    for kk in range(KS // 16):
        rows, cols = w_lane_addr(warp, kk)
        addr = (cols // BOX) * KS * 128 + rows * 128 + (cols % BOX) * 2
        for m in range(4):
            groups = (addr[8 * m:8 * m + 8] // 16) % 8
            assert len(set(groups.tolist())) == 8
    for nt in range(4):
        for kk in range(0, KS // 16, 2):
            rows, cols = x_lane_addr(nt, kk)
            addr = rows * XROW + cols * 2
            for m in range(4):
                groups = (addr[8 * m:8 * m + 8] // 16) % 8
                assert len(set(groups.tolist())) == 8


@pytest.mark.parametrize("ids", [[0, 1, 2, 0, 1, 2, 0, 0], [5] * 13,
                                 [3, 1, 3, 1, 0, 2, 2, 2, 1, 0, 3]])
def test_x_b_fragments_are_the_units_rows(ids):
    # The unit's rows staged by slot (slots past the unit zero); one
    # ldmatrix.x4 gives b0, b1 of k16 steps kk and kk + 1 with B[k][n] =
    # x[row of slot 8nt + n][16kk + k].
    rng = np.random.default_rng(len(ids))
    x = rng.integers(-99, 99, (len(ids), KS))
    r = 8 * nt_of(len(ids))
    for t, rows in unit_plan(ids, r):
        stage = np.zeros((r, KS), np.int64)
        stage[:len(rows)] = x[rows]
        assert all(ids[row] == t for row in rows)
        for nt in range(r // 8):
            want_rows = np.zeros((8, KS), np.int64)
            n_here = max(0, min(8, len(rows) - 8 * nt))
            want_rows[:n_here] = x[rows[8 * nt:8 * nt + n_here]]
            for kk in range(0, KS // 16, 2):
                got = ldsm_x4(stage, *x_lane_addr(nt, kk), trans=False)
                for step in range(2):
                    b = want_rows[:, 16 * (kk + step):
                                  16 * (kk + step) + 16].T
                    np.testing.assert_array_equal(
                        got[:, 2 * step:2 * step + 2], b_frag(b))


@pytest.mark.parametrize("seed", range(3))
def test_mma_from_swizzled_shared_tiles(seed):
    # W (swizzled) and x through the kernel's ldmatrix addresses into
    # m16n8k16: D holds x @ W at (m16 row = column, n8 column = slot).
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((KS, COLS))
    x = rng.standard_normal((8, KS))
    phys = stage_w(w)
    want = x @ w
    for warp in range(4 * BOXES):
        d = np.zeros((32, 4))
        for kk in range(0, KS // 16, 2):
            xb = ldsm_x4(x, *x_lane_addr(0, kk), trans=False)
            for step in range(2):
                a = ldsm_x4(phys, *w_lane_addr(warp, kk + step), trans=True)
                d += mma_16816(a, xb[:, 2 * step:2 * step + 2])
        col = BOX * (warp // 4) + 16 * (warp % 4)
        for lane in range(32):
            g, t = divmod(lane, 4)
            np.testing.assert_allclose(
                d[lane], [want[2 * t, col + g], want[2 * t + 1, col + g],
                          want[2 * t, col + 8 + g],
                          want[2 * t + 1, col + 8 + g]],
                rtol=1e-12, atol=1e-12)


# --- units: the per-block assignment of tenants and rows ---------------------

def unit_plan(ids, r):
    """The units of one slab: tenants by rank (order of first
    occurrence), each cut into ceil(count / r) units of r rows in row
    order. Returns ``[(tenant, [rows]), ...]`` in unit order."""
    order, slot_d, tenants, _ = slot_plan(ids)
    units = []
    for d, t in enumerate(tenants):
        rows = [order[s] for s in range(len(order)) if slot_d[s] == d]
        units += [(t, rows[c:c + r]) for c in range(0, len(rows), r)]
    return units


def unit_bound(slab, t, r):
    """The host's grid x: the most units a slab of valid ids can hold."""
    lead = min(slab, t)
    return lead + (slab - lead) // r


def device_unit(ids, unit, r):
    """Block ``unit``'s bookkeeping as the kernel's threads compute it
    (first occurrence, rank d, place within the tenant, units a rank,
    units before it); ``(tenant, slot_row)`` or None where the block
    exits."""
    slab = len(ids)
    first = [next(f for f in range(slab) if ids[f] == ids[i])
             for i in range(slab)]
    sd = [sum(j < first[i] and first[j] == j for j in range(i))
          for i in range(slab)]
    srank = [sum(first[j] == first[i] for j in range(i))
             for i in range(slab)]
    units_of = {}
    for i in range(slab):
        if first[i] == i:
            count = sum(first[j] == i for j in range(i, slab))
            units_of[sd[i]] = -(-count // r)
    found = None
    for i in range(slab):
        if first[i] == i:
            before = sum(units_of[e] for e in range(sd[i]))
            if before <= unit < before + units_of[sd[i]]:
                found = (ids[i], sd[i], unit - before)
    if found is None:
        return None
    t, d, c = found
    slot_row = [-1] * r
    for i in range(slab):
        if sd[i] == d and srank[i] // r == c:
            slot_row[srank[i] % r] = i
    return t, slot_row


ID_PATTERNS = [[0, 1, 2, 0, 1, 2, 0, 0], [2], [4] * 8, list(range(8)),
               [1] * 40 + [0] * 12 + [2] * 12, [0] * 128, list(range(128)),
               [3, 1, 3, 1, 0, 2, 2, 2, 1, 0, 3], [7] * 9 + [1] * 33]


@pytest.mark.parametrize("ids", ID_PATTERNS)
def test_units_cover_every_row_once(ids):
    t = max(ids) + 1
    r = 8 * nt_of(len(ids))
    units = unit_plan(ids, r)
    seen = sorted(row for _, rows in units for row in rows)
    assert seen == list(range(len(ids)))
    for tenant, rows in units:
        assert 1 <= len(rows) <= r and all(ids[i] == tenant for i in rows)
    assert len(units) <= unit_bound(len(ids), t, r)
    # A tenant's head is read once for each R of its rows.
    for tenant in set(ids):
        reads = sum(u == tenant for u, _ in units)
        assert reads == -(-ids.count(tenant) // r)


@pytest.mark.parametrize("ids", ID_PATTERNS)
def test_device_bookkeeping_matches_the_plan(ids):
    t = max(ids) + 1
    r = 8 * nt_of(len(ids))
    units = unit_plan(ids, r)
    for unit in range(unit_bound(len(ids), t, r)):
        got = device_unit(ids, unit, r)
        if unit >= len(units):
            assert got is None                 # the block exits
            continue
        tenant, rows = units[unit]
        assert got == (tenant, rows + [-1] * (r - len(rows)))


@pytest.mark.parametrize("slab,t", [(8, 3), (16, 16), (64, 3), (128, 8),
                                    (128, 200), (33, 1)])
def test_unit_bound_is_reached(slab, t):
    # The bound is tight: min(slab, t) tenants, all but one holding one
    # row, the last the rest.
    r = 8 * nt_of(slab)
    lead = min(slab, t)
    ids = list(range(lead - 1)) + [lead - 1] * (slab - lead + 1)
    assert len(unit_plan(ids, r)) == unit_bound(slab, t, r)


# --- the 3-D tensor map -------------------------------------------------------

def tma_box_3d(w, c0, k0, t):
    """Box {BOX, KS, 1} at {c0, k0, t} of the (N, K, T) map over a (T, K,
    N) stack: elements past K or N read as zeros."""
    _, k, n = w.shape
    out = np.zeros((KS, BOX), w.dtype)
    ks = np.arange(k0, k0 + KS)
    cs = np.arange(c0, c0 + BOX)
    kv, cv = ks < k, cs < n
    out[np.ix_(kv, cv)] = w[t][np.ix_(ks[kv], cs[cv])]
    return out


def tma_box_2d(w, c0, r0):
    """The same box from a 2-D map over (T K, N): rows run on into the
    next tenant."""
    tk = w.shape[0] * w.shape[1]
    flat = w.reshape(tk, -1)
    out = np.zeros((KS, BOX), w.dtype)
    rows = np.arange(r0, r0 + KS)
    cols = np.arange(c0, c0 + BOX)
    rv, cv = rows < tk, cols < flat.shape[1]
    out[np.ix_(rv, cv)] = flat[np.ix_(rows[rv], cols[cv])]
    return out


def test_rows_past_k_read_zero_in_the_3d_map():
    rng = np.random.default_rng(0)
    t_count, k, n = 3, 520, 1000
    w = rng.standard_normal((t_count, k, n)).astype(np.float32)
    k0 = (k // KS) * KS                        # the last stage, cut short
    for t in range(t_count):
        for c0 in (0, 960):                    # the last tile, cut short
            box = tma_box_3d(w, c0, k0, t)
            valid_c = min(BOX, n - c0)
            np.testing.assert_array_equal(box[:k - k0, :valid_c],
                                          w[t, k0:, c0:c0 + valid_c])
            assert not box[k - k0:].any() and not box[:, valid_c:].any()
            flat = tma_box_2d(w, c0, t * k + k0)
            if t + 1 < t_count:
                # The 2-D map would read tenant t + 1's first rows there.
                np.testing.assert_array_equal(
                    flat[k - k0:, :valid_c],
                    w[t + 1, :KS - (k - k0), c0:c0 + valid_c])
                assert flat[k - k0:].any()


# --- partials, splits, the rank-ordered sum ----------------------------------

def host_splits(tiles, units, n_st, live=3, sms=132, half=7):
    """The host's K split: the largest power of two (at most MAX_SPLITS
    and the stages) that keeps the grid within ``half / 2`` blocks a
    multiprocessor and within one wave of ``live`` resident blocks."""
    cap = min(n_st, MAX_SPLITS)
    aim = min(half, 2 * live) * sms
    splits = 1
    while splits * 2 <= cap and 2 * tiles * units * splits * 2 <= aim:
        splits *= 2
    return splits


def test_host_splits_at_the_head_and_narrow_widths():
    # Mistral-7B's head: 250 tiles x 3 units fill the card, no split.
    assert host_splits(250, 3, 32) == 1
    assert host_splits(250, 1, 32) == 1
    # A narrow head splits K, up to a portable cluster of 8.
    assert host_splits(2, 3, 32) == 8
    assert host_splits(8, 4, 112) == 8
    assert host_splits(32, 4, 112) == 2        # 3.5 blocks an SM at most
    assert host_splits(4, 3, 2) == 2           # never past the stages


def test_stages_cover_k_once_per_split():
    for k in (8, 520, 1024, 4096, 14336):
        n_st = -(-k // KS)
        for splits in (1, 2, 4, 8):
            splits_ = min(splits, n_st)
            seen = np.zeros(n_st, int)
            for sp in range(splits_):
                seen[sp * n_st // splits_:(sp + 1) * n_st // splits_] += 1
            assert (seen == 1).all()


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_d_fragments_fill_the_partials_once(nt):
    # Lane (g, t) of warp w holds tot[nt][e] at (slot 8nt + 2t + e, column
    # 64 (w / 4) + 16 (w % 4) + g) and tot[nt][2 + e] 8 columns on: every
    # (slot, column) of the block once; the padded row stride keeps one
    # store's 32 lanes in 32 banks.
    cells = {}
    for warp in range(4 * BOXES):
        col = BOX * (warp // 4) + 16 * (warp % 4)
        for e in range(2):
            for half in (0, 1):
                banks = set()
                for ntile in range(nt):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        key = (ntile * 8 + 2 * t + e, col + 8 * half + g)
                        assert key not in cells
                        cells[key] = True
                        if ntile == 0:
                            banks.add((key[0] * PSTRIDE + key[1]) % 32)
                assert len(banks) == 32
    assert len(cells) == 8 * nt * COLS


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_sum_in_rank_order(splits):
    # Block q of the cluster reduces columns q * COLS / splits .. for
    # every slot, adding ranks 0, 1, .. in order: every column once, the
    # sequential fp32 sum whichever block does it.
    rng = np.random.default_rng(splits)
    parts = (rng.standard_normal((splits, 8, COLS))
             * 10.0 ** rng.integers(-3, 4, (splits, 8, COLS))
             ).astype(np.float32)
    slice_ = COLS // splits
    out = np.full((8, COLS), np.nan, np.float32)
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

def kernel_model(x, w, ids, splits=None):
    """The launches' arithmetic in numpy: for each slab of SLAB rows, each
    unit, tile of COLS columns and K split, the stages' boxes from the 3-D
    map; each stage's product of the unit's x rows and W (float32, a
    fresh sum) added to a running fp32 sum; the splits added in rank
    order; the unit's rows written at columns below N. ``splits`` None
    takes the host's rule. Returns ``(y (B, N) float32, splits used)``."""
    bsz, k = x.shape
    t_count, _, n = w.shape
    n_st = -(-k // KS)
    tiles = -(-n // COLS)
    y = np.full((bsz, n), np.nan, np.float32)
    used = set()
    for row0 in range(0, bsz, SLAB):
        slab = min(SLAB, bsz - row0)
        r = 8 * nt_of(slab)
        units = unit_plan(list(ids[row0:row0 + slab]), r)
        sp_count = (host_splits(tiles, unit_bound(slab, t_count, r), n_st)
                    if splits is None else min(splits, n_st))
        used.add(sp_count)
        for t, rows in units:
            xs = np.zeros((r, n_st * KS), np.float32)
            xs[:len(rows), :k] = x[row0 + np.asarray(rows)]
            for tile in range(tiles):
                c0 = tile * COLS
                parts = np.zeros((sp_count, r, COLS), np.float32)
                for sp in range(sp_count):
                    tot = np.zeros((r, COLS), np.float32)
                    for h in range(sp * n_st // sp_count,
                                   (sp + 1) * n_st // sp_count):
                        box = np.concatenate(
                            [tma_box_3d(w, c0 + BOX * b, h * KS, t)
                             for b in range(BOXES)], axis=1)
                        acc = xs[:, h * KS:(h + 1) * KS] @ box
                        tot = (tot + acc).astype(np.float32)
                    parts[sp] = tot
                total = parts[0]
                for sp in range(1, sp_count):          # rank order
                    total = (total + parts[sp]).astype(np.float32)
                cols = min(COLS, n - c0)
                y[row0 + np.asarray(rows), c0:c0 + cols] = \
                    total[:len(rows), :cols]
    return y, used


def dense_world(seed, bsz, t, k, n, ids=None):
    """bf16-valued x and W (as float32 numpy) and ids (distinct tenants
    at most B)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, k)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    w = torch.from_numpy((0.02 * rng.standard_normal((t, k, n))).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    ids = rng.integers(0, t, bsz) if ids is None else np.asarray(ids)
    return x, w, ids.astype(np.int64)


def plain(x, w, ids):
    return tbg.tenant_dense_matmul_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16),
        torch.from_numpy(ids)).numpy()


def pallas(x, w, ids):
    return np.asarray(jpb.tenant_dense_matmul_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(ids, jnp.int32), interpret=True, out_dtype=jnp.float32))


def assert_close(y, want):
    assert not np.isnan(y).any()               # every output written
    assert np.abs(y - want).max() <= TOL * np.abs(want).max()


# (B, T, K, N, splits): K 520 (a stage cut short) and 1024, N 1000 (a tile
# cut short) and 256; B 1, 8, 9 (two n8 tiles), 65 (one tenant holding
# more than one unit's rows) and 129 (two launches); distinct tenants at
# most B.
@pytest.mark.parametrize("bsz,t,k,n,splits", [
    (1, 1, 520, 1000, None), (1, 8, 1024, 256, None),
    (8, 3, 520, 1000, None), (8, 8, 1024, 256, 2), (9, 3, 1024, 1000, 4),
    (9, 1, 520, 256, 8), (65, 3, 520, 256, None), (65, 8, 1024, 1000, 2),
    (129, 3, 520, 256, 1)])
def test_kernel_model_matches_plain(bsz, t, k, n, splits):
    x, w, ids = dense_world(bsz * 7 + k + n, bsz, t, k, n)
    y, _ = kernel_model(x, w, ids, splits)
    assert_close(y, plain(x, w, ids))


@pytest.mark.parametrize("bsz,ids", [
    (8, [0, 1, 2, 0, 1, 2, 0, 0]), (40, [2] * 40), (65, [0] * 40 + [1] * 25),
    (16, list(range(16)))])
def test_kernel_model_tenant_patterns(bsz, ids):
    x, w, ids = dense_world(bsz, bsz, max(ids) + 1, 1024, 256, ids)
    y, used = kernel_model(x, w, ids)
    assert min(used) > 1                       # a narrow head splits K
    assert_close(y, plain(x, w, ids))


@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("bsz", [1, 8, 9, 65])
@pytest.mark.parametrize("k", [520, 1024])
def test_kernel_model_matches_pallas(k, bsz, t):
    x, w, ids = dense_world(bsz + 3 * k + t, bsz, t, k, 256)
    y, _ = kernel_model(x, w, ids)
    assert_close(y, pallas(x, w, ids))


# --- the port's dense matmul on mixed dtypes ---------------------------------

@pytest.mark.parametrize("x_dtype,w_dtype,shape", [
    ("bfloat16", "float32", (1, 1, 8, 8)),     # the card once refused this
    ("bfloat16", "float32", (8, 3, 512, 256)),
    ("float32", "bfloat16", (8, 3, 512, 256)),
    ("float16", "float32", (5, 2, 256, 128)),
    ("bfloat16", "float16", (5, 2, 256, 128))])
def test_mixed_dtypes_match_pallas(x_dtype, w_dtype, shape):
    # JAX's kernel widens x and W to fp32 inside, so it takes any pair;
    # so does the port (the card's CUDA-core kernel does the same). fp32
    # sums in another order: 1e-4 of the output scale.
    bsz, t, k, n = shape
    rng = np.random.default_rng(bsz + k)
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    w = (0.05 * rng.standard_normal((t, k, n))).astype(np.float32)
    ids = rng.integers(0, t, bsz).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    jw = jnp.asarray(w, getattr(jnp, w_dtype))
    want = np.asarray(jpb.tenant_dense_matmul_pallas(
        jx, jw, jnp.asarray(ids), interpret=True, out_dtype=jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, w_dtype))
    got = tbg.tenant_dense_matmul(tx, tw, torch.from_numpy(ids),
                                  out_dtype=torch.float32).numpy()
    assert got.shape == (bsz, n)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    # Default out_dtype: x's, as JAX's.
    assert tbg.tenant_dense_matmul(tx, tw, torch.from_numpy(ids)).dtype \
        == tx.dtype
