"""Numerics of row 9's tensor-core kernel
(``bitdelta_torch/csrc/binary_gemm.cu::fused_tenant_tc_kernel``) on the
CPU, before the card.

``Y[b] = x[b] @ W + scales[ids[b]] * (x[b] @ sign(P[ids[b]]))``: x ``(B,
K)`` and W ``(K, N)`` bf16, P the canonical layout ``(T, K/32, N)`` int32
(bit s of word (kw, n) set: +1 at K = 32 kw + s), fp32 out. A launch
takes a slab of up to 32 rows; a block owns 128 columns (row 3's tile: two
64-column W boxes by TMA with the 128-byte swizzle, a warp 16 columns, one
m16 tile), every row of the slab and one K split. Both products run on
``mma.sync.m16n8k16`` (bf16, fp32 sums) and share the x fragment (the
slab's rows, staged by slot, as the n8 side):

* the base with W as A by ``ldmatrix.trans``;
* the delta with A the ±1 signs of one tenant, built in registers from
  the canonical words (lane (g, t) of k16 step e of a word: bits 16e + 2t,
  + 1 and 16e + 2t + 8, + 9 of the words of columns 16w + g and 16w + 8 +
  g, each an exact bf16 ±1), and B that x fragment with each lane's
  registers zeroed unless its slot belongs to the tenant.

Slots are the slab's rows ordered by tenant (order of first occurrence);
a stage holds the words of 4 tenants, and a slab with more walks its K
range again for each further 4 (words and x only). Each stage sums both
products into fresh fp32 accumulators added to running sums; a column
tile's K splits add their base and delta partials in rank order; then y
= base + scale * delta.

Numpy models here check, lane by lane, the sign fragments against
sign(P) transposed (two k16 steps a word), both products from the shared
tiles through the kernel's addresses, the masked B fragments, the slots
and each n8 tile's tenant mask, the partials' layout and the rank-ordered
split sum, the host's split rule and the stages' cover of K; and a model
of the kernel's arithmetic is held against ``fused_tenant_matmul_plain``
and interpret-mode ``fused_tenant_matmul_pallas`` within 1e-4 of the
output's largest |value| (bf16 products are exact in fp32; the sums run
in another order). The ring's constants are read from the source, so the
models follow the kernel as it is built.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.ops import pallas_binary_gemm as jpb
from bitdelta_torch.ops import binary_gemm as tbg
from bitdelta_torch.ops.packing import unpack_to_pm1
from tests.test_torch_fused_pair_numerics import (a_frag, bits, ldsm_x4,
                                                  mma_16816, slot_plan)
from tests.test_torch_tenant_dense_numerics import (stage_w, w_lane_addr,
                                                    x_lane_addr)

SOURCE = (Path(tbg.__file__).resolve().parents[1] / "csrc"
          / "binary_gemm.cu").read_text()


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


KS = constant("FT_KS")            # K a ring stage
DT = constant("FT_DT")            # tenants' words a stage holds
SLAB = constant("FT_SLAB")        # rows a launch takes
MAX_SPLITS = constant("FT_MAX_SPLITS")
COLS = 128                        # output columns a block
PSTRIDE = COLS + 4                # floats of a partials row
TOL = 1e-4                        # of the output's largest |value|


def nt_of(slab):
    return 1 if slab <= 8 else 2 if slab <= 16 else 4


def test_the_tile_is_row_3s():
    assert constant("FT_BOXES") * 64 == COLS
    assert KS % 32 == 0 and KS <= 256 and SLAB == 32 and DT >= 1
    assert MAX_SPLITS <= 8                     # a portable cluster


# --- the ±1 A fragment from canonical words ---------------------------------

def prmt(a, b, sel):
    """PTX ``prmt.b32`` (default mode) on uint32 scalars: result byte i is
    byte ``sel`` nibble i & 7 of (a, b), a bytes 0-3; where the nibble's
    bit 3 is set, that byte's bit 7 replicated over all 8 bits."""
    src = [(int(a) >> (8 * i)) & 255 for i in range(4)] + \
          [(int(b) >> (8 * i)) & 255 for i in range(4)]
    out = 0
    for i in range(4):
        nib = (sel >> (4 * i)) & 15
        byte = src[nib & 7]
        if nib & 8:
            byte = 255 if byte & 128 else 0
        out |= byte << (8 * i)
    return out


def sign_pair(w, t, j):
    """The kernel's ``sign_pair<j>`` for lane t of word ``w``: u = w << (7 -
    2t), v = w << (6 - 2t), one prmt with selector ((0xC + j) << 12) | ((8
    + j) << 4), and 0xBF80BF80 ^ (m & 0x80008000)."""
    w = int(w)
    u = (w << (7 - 2 * t)) & 0xFFFFFFFF
    v = (w << (6 - 2 * t)) & 0xFFFFFFFF
    m = prmt(u, v, ((0xC + j) << 12) | ((0x8 + j) << 4))
    return np.uint32(0xBF80BF80 ^ (m & 0x80008000))


def bf16_pair(reg):
    """A register's two bf16 halves as float64 ``(..., 2)``, low first."""
    reg = np.asarray(reg, np.uint32)
    halves = np.stack([reg & 0xFFFF, reg >> 16], -1).astype(np.int32)
    return torch.from_numpy(halves.astype(np.int16)).view(
        torch.bfloat16).double().numpy()


def sign_frags(words, warp):
    """Lane registers of the delta's A for one word row of a stage:
    ``words`` (COLS,) uint32 of the block's columns; returns ``(2, 32, 4,
    2)`` float64, k16 step e = 0, 1 of the word, lane (g, t): a0 (column
    16w + g, K 16e + 2t..), a1 (column 16w + 8 + g), a2 (K 16e + 2t + 8..),
    a3."""
    out = np.zeros((2, 32, 4, 2))
    for lane in range(32):
        g, t = divmod(lane, 4)
        wlo, whi = words[16 * warp + g], words[16 * warp + 8 + g]
        for e in range(2):
            regs = (sign_pair(wlo, t, 2 * e), sign_pair(whi, t, 2 * e),
                    sign_pair(wlo, t, 2 * e + 1), sign_pair(whi, t, 2 * e + 1))
            for m, reg in enumerate(regs):
                out[e, lane, m] = bf16_pair(reg)
    return out


def signs_of(words):
    """``(..., 32)`` ±1 of uint32 words, bit s at K s."""
    return 2.0 * bits(words) - 1.0


@pytest.mark.parametrize("fill", [0, 0xFFFFFFFF, 0x5A5A5A5A])
def test_sign_pair_is_an_exact_bf16_sign_pair(fill):
    # Pair j of lane t is bits 2t + 8j (low half) and 2t + 8j + 1: +1 where
    # set, -1 where clear, whatever the word's other bits.
    for t in range(4):
        for j in range(4):
            s = 2 * t + 8 * j
            for lo in (0, 1):
                for hi in (0, 1):
                    w = (fill & ~(3 << s)) | (lo << s) | (hi << (s + 1))
                    np.testing.assert_array_equal(
                        bf16_pair(sign_pair(w, t, j)),
                        [2 * lo - 1, 2 * hi - 1])


@pytest.mark.parametrize("warp", range(8))
def test_sign_fragment_is_sign_transposed(warp):
    # For each word row and both k16 steps it serves, the lane registers
    # are the PTX A fragment of A[m][k] = sign(P)[K 16e + k][column 16w +
    # m], m < 16.
    rng = np.random.default_rng(warp)
    for _ in range(4):
        words = rng.integers(0, 2 ** 32, COLS, dtype=np.uint64).astype(
            np.uint32)
        got = sign_frags(words, warp)
        pm = signs_of(words[16 * warp:16 * warp + 16])      # (16, 32)
        for e in range(2):
            np.testing.assert_array_equal(
                got[e], a_frag(pm[:, 16 * e:16 * e + 16]))


# --- both products from the shared tiles -------------------------------------

def stage_words(packed_t, kw0, c0):
    """A stage's word rows of one tenant at the block's columns, zeros
    past K32 and N (the zero-filled copies)."""
    k32, n = packed_t.shape
    out = np.zeros((KS // 32, COLS), np.uint32)
    for r in range(KS // 32):
        if kw0 + r < k32:
            cols = min(COLS, n - c0)
            out[r, :cols] = packed_t[kw0 + r, c0:c0 + cols]
    return out


@pytest.mark.parametrize("seed", range(3))
def test_both_products_share_the_x_fragment(seed):
    # W (swizzled), one tenant's words and 8 x rows through the kernel's
    # addresses: the base MMAs hold x @ W and the delta MMAs x @ sign(P),
    # both at (m16 row = column, n8 column = slot), from the same B.
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((KS, COLS))
    x = rng.standard_normal((8, KS))
    words = rng.integers(0, 2 ** 32, (KS // 32, COLS),
                         dtype=np.uint64).astype(np.uint32)
    sign = signs_of(words.T).transpose(1, 2, 0).reshape(KS, COLS)   # K, N
    phys = stage_w(w)
    for warp in range(8):
        db = np.zeros((32, 4))
        dd = np.zeros((32, 4))
        for kk in range(0, KS // 16, 2):
            xb = ldsm_x4(x, *x_lane_addr(0, kk), trans=False)
            s = sign_frags(words[kk // 2], warp)
            for step in range(2):
                a = ldsm_x4(phys, *w_lane_addr(warp, kk + step), trans=True)
                db += mma_16816(a, xb[:, 2 * step:2 * step + 2])
                dd += mma_16816(s[step], xb[:, 2 * step:2 * step + 2])
        for d, want in ((db, x @ w), (dd, x @ sign)):
            for lane in range(32):
                g, t = divmod(lane, 4)
                col = 16 * warp + g
                np.testing.assert_allclose(
                    d[lane], [want[2 * t, col], want[2 * t + 1, col],
                              want[2 * t, col + 8], want[2 * t + 1, col + 8]],
                    rtol=1e-12, atol=1e-12)


def test_word_reads_are_free_of_bank_conflicts():
    # A lane reads the words of columns 16w + g and 16w + 8 + g of one word
    # row: the four lanes t share an address (a broadcast), and the 8 g
    # sit in 8 banks.
    for warp in range(8):
        for off in (0, 32):
            addr = [(16 * warp + g) * 4 + off for g in range(8)]
            assert len({(a // 4) % 32 for a in addr}) == 8


# --- slots, tenant masks, masked B -------------------------------------------

def tile_masks(slot_d, nt):
    """Each n8 tile's bitmask of the tenant ranks its slots hold."""
    masks = [0] * nt
    for s, d in enumerate(slot_d):
        masks[s // 8] |= 1 << d
    return masks


@pytest.mark.parametrize("ids", [[0, 1, 2, 0, 1, 2, 0, 0], list(range(9)),
                                 [4] * 32, [3, 1, 3, 1, 0, 2, 2, 2, 1, 0, 3],
                                 list(range(31, -1, -1))])
def test_slots_group_tenants_into_tiles(ids):
    order, slot_d, tenants, _ = slot_plan(ids)
    nt = nt_of(len(ids))
    masks = tile_masks(slot_d, nt)
    assert sorted(order) == list(range(len(ids)))
    assert slot_d == sorted(slot_d)            # slots by tenant rank
    assert [ids[r] for r in order] == [tenants[d] for d in slot_d]
    # A tile's delta MMAs run for the tenants it holds: at most its slots,
    # and every distinct tenant meets its rows in some tile.
    for m in masks:
        assert bin(m).count("1") <= 8
    assert sum(bin(m).count("1") for m in masks) \
        >= len(tenants) and sum(masks) > 0
    # B = 8 over 3 tenants: one tile holding all three.
    if ids == [0, 1, 2, 0, 1, 2, 0, 0]:
        assert masks == [0b111]


@pytest.mark.parametrize("seed", range(4))
def test_masked_b_counts_each_slot_against_its_own_tenant(seed):
    # One n8 tile over up to 4 tenants: for each tenant d the tile holds,
    # an MMA of d's signs with B masked to d's slots; the sum over d is, in
    # each column, that slot's x against its own tenant's signs. A NaN in
    # one slot's x reaches that column alone.
    rng = np.random.default_rng(seed)
    slot_d = sorted(rng.integers(0, 4, 8).tolist())
    words = rng.integers(0, 2 ** 32, (4, COLS), dtype=np.uint64).astype(
        np.uint32)
    x = rng.standard_normal((8, 32))
    x[seed % 8, 5] = np.nan
    warp = seed
    d_all = np.zeros((32, 4))
    for d in set(slot_d):
        s = sign_frags(words[d], warp)
        xb = ldsm_x4(x, *x_lane_addr(0, 0), trans=False)
        mask = np.array([slot_d[lane // 4] == d for lane in range(32)])
        xb = np.where(mask[:, None, None], xb, 0.0)
        for step in range(2):
            d_all += mma_16816(s[step], xb[:, 2 * step:2 * step + 2])
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(2):
            slot = 2 * t + e
            for h, col in enumerate((16 * warp + g, 16 * warp + 8 + g)):
                want = x[slot] @ signs_of(words[slot_d[slot], col])
                got = d_all[lane, 2 * h + e]
                if np.isnan(want):
                    assert np.isnan(got) and slot == seed % 8
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-12,
                                               atol=1e-12)


# --- partials, splits ---------------------------------------------------------

@pytest.mark.parametrize("nt", [1, 2, 4])
def test_d_fragments_fill_the_partials_once(nt):
    # Lane (g, t) of warp w holds slots 8nt + 2t + e at columns 16w + g and
    # 16w + 8 + g, for the base and the delta alike: every (slot, column)
    # once, and one store's 32 lanes in 32 banks.
    cells = set()
    for warp in range(8):
        for e in range(2):
            for half in (0, 1):
                banks = set()
                for ntile in range(nt):
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        key = (ntile * 8 + 2 * t + e, 16 * warp + 8 * half + g)
                        assert key not in cells
                        cells.add(key)
                        if ntile == 0:
                            banks.add((key[0] * PSTRIDE + key[1]) % 32)
                assert len(banks) == 32
    assert len(cells) == 8 * nt * COLS


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 7, 8])
def test_split_sum_in_rank_order(splits):
    # Block q of the cluster reduces columns q * ceil(COLS / splits) .. (up
    # to COLS) of every slot for the base and the delta, adding ranks 0,
    # 1, .. in order, then
    # y = base + alpha * delta: every column once, and the result the
    # sequential fp32 one whichever block computes it.
    rng = np.random.default_rng(splits)
    f32 = np.float32
    scale = lambda shape: 10.0 ** rng.integers(-3, 4, shape)  # noqa: E731
    pb = (rng.standard_normal((splits, 8, COLS))
          * scale((splits, 8, COLS))).astype(f32)
    pd = (rng.standard_normal((splits, 8, COLS))
          * scale((splits, 8, COLS))).astype(f32)
    alpha = rng.uniform(0.001, 0.02, 8).astype(f32)
    slice_ = -(-COLS // splits)
    out = np.full((8, COLS), np.nan, f32)
    for q in range(splits):
        cols = slice(q * slice_, min(COLS, (q + 1) * slice_))
        base, delta = pb[0, :, cols].copy(), pd[0, :, cols].copy()
        for r in range(1, splits):
            base = (base + pb[r, :, cols]).astype(f32)
            delta = (delta + pd[r, :, cols]).astype(f32)
        assert np.isnan(out[:, cols]).all()
        out[:, cols] = (base + (alpha[:, None] * delta).astype(f32)).astype(
            f32)
    base, delta = pb[0].copy(), pd[0].copy()
    for r in range(1, splits):
        base = (base + pb[r]).astype(f32)
        delta = (delta + pd[r]).astype(f32)
    np.testing.assert_array_equal(
        out, (base + (alpha[:, None] * delta).astype(f32)).astype(f32))


def host_splits(tiles, n_st, live, fit=lambda sp: 10 ** 6, sms=132):
    """The host's K split (``fused_tenant_tc_plan``): the most (at most
    MAX_SPLITS and the stages) that keep the grid within one wave of
    ``live`` resident blocks a multiprocessor, and whose ``tiles``
    clusters the card holds at once (``fit(sp)`` clusters of sp
    blocks)."""
    cap = min(n_st, MAX_SPLITS)
    sp = max(1, min(cap, live * sms // tiles))
    while sp > 1 and fit(sp) < tiles:
        sp -= 1
    return sp


@pytest.mark.parametrize("live", [1, 2, 3, 4])
def test_host_splits_fill_the_card_in_one_wave(live):
    # The seven Mistral-7B projections: within a portable cluster and the
    # stages, one wave of resident blocks, the most that fit, and the
    # narrow k/v_proj (8 tiles) split the most.
    got = {}
    cap_blocks = live * 132
    for proj, k, n in (("q", 4096, 4096), ("kv", 4096, 1024),
                       ("gate", 4096, 14336), ("down", 14336, 4096)):
        tiles, n_st = -(-n // COLS), -(-k // KS)
        sp = host_splits(tiles, n_st, live)
        assert 1 <= sp <= min(MAX_SPLITS, n_st)
        assert sp == 1 or tiles * sp <= cap_blocks
        assert sp == min(MAX_SPLITS, n_st) or tiles * (sp + 1) > cap_blocks
        got[proj] = sp
    assert got["kv"] == max(got.values())


def test_host_splits_keep_every_cluster_in_one_wave():
    # A cluster's blocks share a GPC, so the card holds fewer clusters of 8
    # than its slots / 8: where the 32 tiles of q/o/down_proj would not all
    # fit as clusters of 8, they take the most splits whose clusters do.
    fit = {8: 30, 7: 36, 6: 44, 5: 52, 4: 66, 3: 88, 2: 132}.get
    assert host_splits(32, 32, 2, fit) == 7
    assert host_splits(32, 112, 2, fit) == 7
    assert host_splits(8, 32, 2, fit) == 8            # k/v_proj: 8 fit
    assert host_splits(112, 32, 2, fit) == 2          # gate/up: the aim
    assert host_splits(200, 32, 2, lambda sp: 100) == 1


def test_stages_cover_k_once_per_split():
    # Split sp takes stages sp * n_st / splits ..: the splits partition the
    # stages, whatever the split count; a stage h covers K h KS ..
    for k in (32, 1056, 4096, 14336):
        n_st = -(-k // KS)
        for splits in (1, 2, 4, 8):
            splits_ = min(splits, n_st)
            seen = np.zeros(n_st * KS, int)
            for sp in range(splits_):
                for h in range(sp * n_st // splits_,
                               (sp + 1) * n_st // splits_):
                    seen[h * KS:(h + 1) * KS] += 1
            assert (seen == 1).all()


# --- the kernel's arithmetic --------------------------------------------------

def kernel_model(x, w, packed, scales, ids, splits=2):
    """The launches' arithmetic in numpy: for each slab of SLAB rows (slots
    by tenant), tile of COLS columns and K split, each stage's base product
    (pass 0) and delta products (each pass of DT tenants, each tile's
    tenants, B masked to a tenant's slots) summed into fresh fp32 sums and
    added to running fp32 sums; the splits' partials added in rank order;
    y = base + alpha * delta in fp32, written at columns below N."""
    bsz, k = x.shape
    _, k32, n = packed.shape
    packed = packed.view(np.uint32)
    f32 = np.float32
    n_st = -(-k // KS)
    kp = n_st * KS
    x64 = np.zeros((bsz, kp))
    x64[:, :k] = x
    w64 = np.zeros((kp, -(-n // COLS) * COLS))
    w64[:k, :n] = w
    y = np.full((bsz, n), np.nan, f32)
    splits = min(splits, n_st)
    for row0 in range(0, bsz, SLAB):
        rows = np.arange(row0, min(bsz, row0 + SLAB))
        order, slot_d, tenants, _ = slot_plan(ids[rows])
        slot_d = np.asarray(slot_d)
        xs = x64[rows[order]]                       # the slots' x rows
        alpha = np.asarray(scales, f32)[ids[rows[order]]]
        for c0 in range(0, n, COLS):
            pb = np.zeros((splits, len(rows), COLS), f32)
            pd = np.zeros((splits, len(rows), COLS), f32)
            for sp in range(splits):
                tb = np.zeros((len(rows), COLS), f32)
                td = np.zeros((len(rows), COLS), f32)
                for p0 in range(0, len(tenants), DT):          # passes
                    for h in range(sp * n_st // splits,
                                   (sp + 1) * n_st // splits):
                        ks = slice(h * KS, (h + 1) * KS)
                        if p0 == 0:
                            ab = xs[:, ks] @ w64[ks, c0:c0 + COLS]
                            tb = (tb + ab.astype(f32)).astype(f32)
                        ad = np.zeros((len(rows), COLS))
                        for d in range(p0, min(p0 + DT, len(tenants))):
                            wd = stage_words(packed[tenants[d]], h * KS // 32,
                                             c0)           # (KS / 32, COLS)
                            sign = signs_of(wd.T).transpose(
                                1, 2, 0).reshape(KS, COLS)
                            mask = (slot_d == d)[:, None]
                            ad += np.where(mask, xs[:, ks], 0.0) @ sign
                        td = (td + ad.astype(f32)).astype(f32)
                pb[sp], pd[sp] = tb, td
            base, delta = pb[0], pd[0]
            for sp in range(1, splits):                # rank order
                base = (base + pb[sp]).astype(f32)
                delta = (delta + pd[sp]).astype(f32)
            out = (base + (alpha[:, None] * delta).astype(f32)).astype(f32)
            cols = min(COLS, n - c0)
            y[rows[order], c0:c0 + cols] = out[:, :cols]
    return y


def fused_world(seed, bsz, t, k, n, ids=None):
    """bf16-valued x and W (as float32 numpy), random canonical words,
    scales and ids."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, k)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    w = torch.from_numpy((0.02 * rng.standard_normal((k, n))).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    packed = rng.integers(0, 2 ** 32, (t, k // 32, n),
                          dtype=np.uint64).astype(np.uint32).view(np.int32)
    scales = rng.uniform(0.001, 0.02, (t,)).astype(np.float32)
    ids = rng.integers(0, t, bsz) if ids is None else np.asarray(ids)
    return x, w, packed, scales, ids.astype(np.int64)


def plain(x, w, packed, scales, ids):
    return tbg.fused_tenant_matmul_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(packed),
        torch.from_numpy(scales), torch.from_numpy(ids)).numpy()


def assert_close(y, want):
    assert y.shape == want.shape and not np.isnan(y).any()
    assert np.abs(y - want).max() <= TOL * np.abs(want).max()


def test_sign_layout_matches_the_packages_unpack():
    # signs_of reads words as unpack_to_pm1 does: bit s of word (kw, n) is
    # K = 32 kw + s.
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 2 ** 32, (2, 3, 40), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    want = unpack_to_pm1(torch.from_numpy(packed), torch.float32).numpy()
    got = signs_of(packed.view(np.uint32).transpose(0, 2, 1)).transpose(
        0, 2, 3, 1).reshape(2, 96, 40)
    np.testing.assert_array_equal(got, want)


# (B, T, K, N, ids, splits): K = 1056 (a stage cut short), N = 776 (a tile
# and a box cut short) in 3 splits, B = 9 (two n8 tiles), 33 and 65
# (launches of 32, 32 and 1 rows), one tenant, 8 and 32 distinct tenants
# in a slab (2 and 8 passes of 4 tenants' words), repeated ids.
CASES = [(9, 3, 1056, 776, None, 3), (65, 3, 1056, 256, None, 8),
         (8, 3, 4096, 256, [0, 1, 2, 0, 1, 2, 0, 0], 4),
         (8, 2, 1056, 384, [1] * 8, 1), (8, 8, 544, 256, list(range(8)), 2),
         (32, 32, 288, 128, list(range(31, -1, -1)), 1),
         (33, 6, 2080, 136, None, 8), (40, 2, 544, 200 - 8, [1] * 35 + [0] * 5,
                                       4)]


@pytest.mark.parametrize("bsz,t,k,n,ids,splits", CASES)
def test_kernel_model_matches_plain(bsz, t, k, n, ids, splits):
    world = fused_world(bsz * 7 + k, bsz, t, k, n, ids)
    assert_close(kernel_model(*world, splits=splits), plain(*world))


def test_kernel_model_keeps_a_nan_to_its_row():
    x, w, packed, scales, ids = fused_world(5, 9, 3, 544, 256)
    y = kernel_model(x, w, packed, scales, ids, splits=2)
    x[4, 100] = np.nan
    y_nan = kernel_model(x, w, packed, scales, ids, splits=2)
    want = plain(x, w, packed, scales, ids)
    assert np.isnan(y_nan[4]).all() and np.isnan(want[4]).all()
    keep = np.arange(9) != 4
    np.testing.assert_array_equal(y_nan[keep], y[keep])


@pytest.mark.parametrize("bsz,t,ids", [(9, 3, None),
                                       (8, 3, [0, 1, 2, 0, 1, 2, 0, 0]),
                                       (33, 5, None), (6, 6, list(range(6)))])
def test_kernel_model_matches_pallas(bsz, t, ids):
    k, n = 256, 256
    x, w, packed, scales, ids = fused_world(bsz + 3 * t, bsz, t, k, n, ids)
    y = kernel_model(x, w, packed, scales, ids, splits=2)
    want = np.asarray(jpb.fused_tenant_matmul_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(packed), jnp.asarray(scales),
        jnp.asarray(ids, jnp.int32), interpret=True, out_dtype=jnp.float32))
    assert_close(y, want)
