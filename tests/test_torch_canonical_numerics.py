"""Numerics of the tensor-core canonical tenant delta kernel (row 7,
``bitdelta_torch/csrc/binary_gemm.cu::canon_prep_kernel`` and
``canon_delta_tc_kernel``) on the CPU, before the card.

The main kernel runs the 1-bit MMA
``mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc``. A (16 output
columns x 256 K) is the canonical words themselves: a word holds 32
consecutive K of one column, LSB first, which is what lane (g, t) of the
A fragment holds, so for chunk c a0 = P[8c + t][col(g)], a1 = P[8c +
t][col(g + 8)], a2 / a3 the same at word row 8c + 4 + t (no permutes).
B (256 K x 8) holds bit planes of one row: tile h, column n is plane 8h +
n of the 16 two's-complement planes of xq (plane 15 weighs -2^15), so a
row costs two MMAs whatever the number of rows of its unit. The prep
writes a chunk's 128 plane words plane-major, group j's word of plane p
at 8p + 2 (j % 4) + j // 4, so lane t's b0 (group t) and b1 (group t + 4)
are one 8-byte load.

Numpy models of the lanes check that every (column, K) of a chunk is
taken once, that A and B agree on K, that C's columns are the planes B's
loads put there and that the shared-memory loads are free of bank
conflicts; a model of the prep (one global grid, the planes as the warp's
transposes and lane stores lay them out, the int64 row sums through their
owner blocks) is held bit for bit against the port's
``_canonical_quantize`` / ``_canonical_kernel_input`` and JAX's grid
written op by op; and a model of the kernel's arithmetic (a launch a slab
of 64 rows, one unit a distinct id and group of rows, per-split popcounts,
the planes weighted in int64 across a lane quad, the K splits added in a
cluster's rank order, the fp32 epilogue) is held bit for bit against
``tenant_delta_matmul_plain`` and against interpret-mode
``tenant_delta_matmul_pallas`` within 1e-5 of the output's largest
|value| (JAX sums each K block's products in fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.ops import pallas_binary_gemm as jpb
from bitdelta_tpu.ops.packing import pack_signs as jpack
from bitdelta_torch.ops import binary_gemm as tbg

PLANES = 16                # two's-complement planes of xq
CHUNK = 256                # K of one 1-bit MMA
SLAB = 64                  # rows a main-kernel launch takes
BN = 128                   # output columns a block
WROW = BN * 4 + 32         # bytes of a shared word row
PREP_BLOCKS, PREP_WARPS = 16, 16
MAX_SPLITS = 8
EDGE_WORDS = (0x00000000, 0xFFFFFFFF, 0x80000001, 0x0000FFFF, 0xFFFF0000,
              0x12345678)
WEIGHT = np.array([1 << p for p in range(PLANES - 1)] + [-(1 << 15)],
                  np.int64)


def bits(r):
    """``(..., 32)`` uint8: bit i of each uint32 in ``r``."""
    r = np.asarray(r, np.uint64)
    return ((r[..., None] >> np.arange(32, dtype=np.uint64)) & 1).astype(
        np.uint8)


def words_of(b):
    """Inverse of :func:`bits`: ``(..., 32)`` 0/1 -> ``(...,)`` uint32."""
    w = np.asarray(b, np.uint64) << np.arange(32, dtype=np.uint64)
    return w.sum(-1).astype(np.uint32)


# --- the word -> A fragment map ----------------------------------------------

def a_bits(w8):
    """A of one chunk and m-tile as the lanes hold it: ``w8`` ``(..., 8,
    16)`` uint32 (the chunk's 8 word rows at the m-tile's 16 columns, row
    order of the m-tile) -> ``(..., 16, 256)``: bit i of lane (g, t)'s a0
    is (row g, K 32t + i), a1 (row g + 8, 32t + i), a2 / a3 the same at K
    128 + 32t + i."""
    w8 = np.asarray(w8, np.uint32)
    out = np.zeros(w8.shape[:-2] + (16, CHUNK), np.uint8)
    for g in range(8):
        for t in range(4):
            a0, a1 = w8[..., t, g], w8[..., t, g + 8]
            a2, a3 = w8[..., 4 + t, g], w8[..., 4 + t, g + 8]
            out[..., g, 32 * t:32 * t + 32] = bits(a0)
            out[..., g + 8, 32 * t:32 * t + 32] = bits(a1)
            out[..., g, 128 + 32 * t:160 + 32 * t] = bits(a2)
            out[..., g + 8, 128 + 32 * t:160 + 32 * t] = bits(a3)
    return out


def natural_bits(w8):
    """``(..., 16, 256)``: column n's sign bits of the chunk in natural K
    order, straight from the canonical layout (K 32r + i is bit i of word
    row r)."""
    b = bits(w8)                                        # (..., 8, 16, 32)
    return np.moveaxis(b, -3, -2).reshape(b.shape[:-3] + (16, CHUNK))


def _words(seed, count=256):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2 ** 32, size=(count, 8, 16), dtype=np.uint64)
    edge = np.broadcast_to(np.array(EDGE_WORDS, np.uint64)[:, None, None],
                           (len(EDGE_WORDS), 8, 16))
    return np.concatenate([edge, rand]).astype(np.uint32)


@pytest.mark.parametrize("seed", range(3))
def test_fragments_are_the_words_in_natural_order(seed):
    words = _words(seed)
    np.testing.assert_array_equal(a_bits(words), natural_bits(words))


def test_edge_words():
    np.testing.assert_array_equal(
        a_bits(np.full((8, 16), 0xFFFFFFFF, np.uint32)), 1)
    np.testing.assert_array_equal(a_bits(np.zeros((8, 16), np.uint32)), 0)
    w = np.full((8, 16), 0x80000001, np.uint32)     # K 32r and 32r + 31
    want = np.zeros((16, CHUNK), np.uint8)
    want[:, 0::32] = 1
    want[:, 31::32] = 1
    np.testing.assert_array_equal(a_bits(w), want)


@pytest.mark.parametrize("row", range(8))
def test_one_hot_bits_land_once(row):
    # Each bit of each word row and column alone: exactly one A bit is
    # set, in its own column and at its K.
    for col in (0, 7, 8, 15):
        for bit in range(32):
            w = np.zeros((8, 16), np.uint32)
            w[row, col] = np.uint32(1 << bit)
            want = np.zeros((16, CHUNK), np.uint8)
            want[col, 32 * row + bit] = 1
            np.testing.assert_array_equal(a_bits(w), want)


def m_tile_columns(mt_count, warp, mt):
    """The block columns of m-tile ``mt`` of ``warp`` (rows 0..15):
    row g is the warp's column MT*g + mt, row g + 8 its 8MT + MT*g + mt."""
    base = 16 * mt_count * warp
    return np.array([base + mt_count * g + mt for g in range(8)]
                    + [base + 8 * mt_count + mt_count * g + mt
                       for g in range(8)])


@pytest.mark.parametrize("mt_count", [1, 2])
def test_every_column_and_k_taken_once_in_a_block(mt_count):
    # The PTX layout of m16n8k256 .b1: A a0 (row g, K 32t + i), a1 (row
    # g + 8), a2 / a3 (K 128 + 32t + i); B b0 (K 32t + i, column g), b1 (K
    # 128 + 32t + i); C c0 / c1 (row g, columns 2t, 2t + 1), c2 / c3 (row
    # g + 8). A block of 8 / MT warps covers its 128 columns once.
    seen = []
    for warp in range(8 // mt_count):
        for mt in range(mt_count):
            seen += m_tile_columns(mt_count, warp, mt).tolist()
    assert sorted(seen) == list(range(BN))
    # The lane's MT adjacent words (one load) are a0 of its MT m-tiles.
    for warp in range(8 // mt_count):
        for g in range(8):
            first = 16 * mt_count * warp + mt_count * g
            for mt in range(mt_count):
                assert m_tile_columns(mt_count, warp, mt)[g] == first + mt
                assert (m_tile_columns(mt_count, warp, mt)[g + 8]
                        == first + 8 * mt_count + mt)
    # B's column n of tile h, as lane g = n loads it, and C's column 2t + e
    # as lane (g', t) holds it, name the same plane: 8h + n.
    for h in range(2):
        for n in range(8):
            t, e = divmod(n, 2)
            assert 8 * h + n == 8 * h + 2 * t + e


def _banks(addresses, width):
    """Shared-memory wavefronts of one warp's load of ``width`` bytes a
    lane: the most lanes of one phase that hit one bank with different
    words (1 = conflict-free)."""
    per_phase = 128 // width                     # lanes a wavefront serves
    worst = 1
    for p0 in range(0, 32, per_phase):
        words = {}
        for a in addresses[p0:p0 + per_phase]:
            for w in range(a // 4, (a + width) // 4):
                words.setdefault(w % 32, set()).add(w)
        worst = max(worst, max(len(v) for v in words.values()))
    return worst


@pytest.mark.parametrize("mt_count", [1, 2])
def test_shared_loads_are_free_of_bank_conflicts(mt_count):
    for warp in range(8 // mt_count):
        for row0, col_off in ((0, 0), (0, 8 * mt_count), (4, 0)):
            addr = []
            for lane in range(32):
                g, t = divmod(lane, 4)
                col = 16 * mt_count * warp + mt_count * g + col_off
                addr.append((row0 + t) * WROW + 4 * col)
            assert _banks(addr, 4 * mt_count) == 1
    # B: lane (g, t) reads words 8(8h + g) + 2t and + 1 of the slot.
    for h in range(2):
        addr = [4 * (8 * (8 * h + lane // 4) + 2 * (lane % 4))
                for lane in range(32)]
        assert _banks(addr, 8) == 1


# --- the 16 two's-complement planes and the prep's layout ---------------------

def plane_bits(xq):
    """``(..., 16)``: bit p of each xq's 16-bit two's complement."""
    q = np.asarray(xq, np.int64)
    return ((q[..., None] >> np.arange(PLANES)) & 1).astype(np.int64)


def test_planes_hold_xq_with_a_negative_top_plane():
    xq = np.arange(-2 ** 14, 2 ** 14 + 1)
    np.testing.assert_array_equal(plane_bits(xq) @ WEIGHT, xq)
    assert plane_bits(np.array([2 ** 14]))[0].tolist() == [0] * 14 + [1, 0]
    assert plane_bits(np.array([-1]))[0].tolist() == [1] * 16
    assert plane_bits(np.array([-2 ** 14]))[0].tolist() == [0] * 14 + [1, 1]


def word_index(p, j):
    """Where the prep stores plane p of 32-K group j in a chunk's 128
    words."""
    return 8 * p + 2 * (j % 4) + j // 4


TRANSPOSE_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333,
                   0x55555555)


def warp_transpose32(x):
    """``warp_transpose32`` over a warp: ``x`` ``(..., 32)`` uint32, lane i
    holding row i of a 32 x 32 bit matrix; five butterfly stages, each
    taking lane i ^ s's word (the shuffle) and swapping the off-diagonal
    s x s blocks. Returns ``(..., 32)``: lane i holds column i."""
    x = np.asarray(x, np.uint64)
    lane = np.arange(32)
    full = np.uint64(0xFFFFFFFF)
    for s, m in zip((16, 8, 4, 2, 1), TRANSPOSE_MASKS):
        m = np.uint64(m)
        y = x[..., lane ^ s]
        hi = (x & (full ^ m)) | ((y >> np.uint64(s)) & m)
        lo = (x & m) | ((y << np.uint64(s)) & (full ^ m))
        x = np.where((lane & s) > 0, hi, lo) & full
    return x.astype(np.uint32)


def prep_chunk_words(q):
    """The prep warp on chunks ``q`` ``(..., 256)`` int64 (zeros past K;
    lane i holds K 32j + i of group j): groups 2m and 2m + 1 as the low
    and high 16 bits of each lane's word through one warp transpose, so
    lane l holds plane l % 16 of group 2m + l // 16; lane l stores
    (groups l // 16, 4 + l // 16) at word 8 (l % 16) + 2 (l // 16) and
    (groups 2 + .., 6 + ..) 4 words further. Returns ``(..., 128)``
    uint32."""
    q = np.asarray(q, np.int64).reshape(q.shape[:-1] + (8, 32))
    lanes = (q & 0xFFFF).astype(np.uint64)
    w = [warp_transpose32(lanes[..., 2 * m, :]
                          | (lanes[..., 2 * m + 1, :] << np.uint64(16)))
         for m in range(4)]
    out = np.zeros(q.shape[:-2] + (128,), np.uint32)
    for lane in range(32):
        base = 8 * (lane % 16) + 2 * (lane // 16)
        out[..., base] = w[0][..., lane]
        out[..., base + 1] = w[2][..., lane]
        out[..., base + 4] = w[1][..., lane]
        out[..., base + 5] = w[3][..., lane]
    return out


def test_warp_transpose_is_a_transpose():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 2 ** 32, (50, 32), dtype=np.uint64).astype(
        np.uint32)
    got = bits(warp_transpose32(rows))                  # (50, lane, bit)
    np.testing.assert_array_equal(got, bits(rows).transpose(0, 2, 1))


def b_bits(chunk):
    """B of one chunk as the lanes read it: ``chunk`` ``(..., 128)`` words
    -> ``(..., 16 planes, 256)``; lane (g, t) of tile h loads words 8(8h +
    g) + 2t (b0, K 32t + i) and + 1 (b1, K 128 + 32t + i)."""
    chunk = np.asarray(chunk, np.uint32)
    out = np.zeros(chunk.shape[:-1] + (PLANES, CHUNK), np.uint8)
    for h in range(2):
        for g in range(8):
            for t in range(4):
                w = 8 * (8 * h + g) + 2 * t
                out[..., 8 * h + g, 32 * t:32 * t + 32] = bits(chunk[..., w])
                out[..., 8 * h + g, 128 + 32 * t:160 + 32 * t] = bits(
                    chunk[..., w + 1])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_prep_layout_reads_back_through_the_lanes(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-2 ** 14, 2 ** 14 + 1, (64, CHUNK))
    q[0] = 2 ** 14
    q[1] = -2 ** 14
    q[2, ::2] = -1
    words = prep_chunk_words(q)
    # Plane p of group j at word 8p + 2(j % 4) + j // 4.
    pb = plane_bits(q.reshape(64, 8, 32))                  # (64, 8, 32, 16)
    for p in range(PLANES):
        for j in range(8):
            np.testing.assert_array_equal(words[:, word_index(p, j)],
                                          words_of(pb[:, j, :, p]))
    back = np.einsum("rpk,p->rk", b_bits(words).astype(np.int64), WEIGHT)
    np.testing.assert_array_equal(back, q)


def test_b_loads_take_each_group_once():
    # One set word at a time: exactly one (plane, K) of B.
    for p in (0, 7, 8, 15):
        for j in range(8):
            chunk = np.zeros(128, np.uint32)
            chunk[word_index(p, j)] = 1
            got = b_bits(chunk)
            assert np.flatnonzero(got[p]).tolist() == [32 * j]
            assert got.sum() == 1


# --- the prep: one grid for the whole input -----------------------------------

def prep_grid(xf):
    """The prep's grid in numpy float32: max |x| over the whole input,
    clamped at 1e-30, xscale = xmax / 2^14 and xq = rint(x / xscale), every
    division IEEE, rint half to even."""
    xf = np.asarray(xf, np.float32)
    xmax = np.maximum(np.abs(xf).max(), np.float32(1e-30))
    xscale = np.float32(xmax / np.float32(2 ** 14))
    return np.rint(xf / xscale).astype(np.int64), xscale


def prep_items(bsz, n_chunks):
    """Each prep warp's range of (row, chunk) items, row-major: warp w of
    the cluster's PREP_BLOCKS * PREP_WARPS takes [w I / W, (w + 1) I / W)."""
    total = PREP_BLOCKS * PREP_WARPS
    items = bsz * n_chunks
    return [range(w * items // total, (w + 1) * items // total)
            for w in range(total)]


def prep_model(xf):
    """The prep's outputs: ``(planes (B, chunks, 128) uint32, xq, sxq
    int64, xscale)``; the row sums added warp by warp into the owner
    block's slot (row r: block r % 16, slot r // 16)."""
    bsz, k = xf.shape
    xq, xscale = prep_grid(xf)
    n_chunks = -(-k // CHUNK)
    q = np.zeros((bsz, n_chunks * CHUNK), np.int64)
    q[:, :k] = xq
    planes = prep_chunk_words(q.reshape(bsz, n_chunks, CHUNK))
    slots = np.zeros((PREP_BLOCKS, -(-bsz // PREP_BLOCKS)), np.int64)
    chunk_sums = q.reshape(bsz, n_chunks, CHUNK).sum(-1)
    taken = np.zeros(bsz * n_chunks, np.int64)
    for rng_ in prep_items(bsz, n_chunks):
        acc, cur = 0, -1
        for it in rng_:
            r, c = divmod(it, n_chunks)
            if r != cur:
                if cur >= 0:
                    slots[cur % PREP_BLOCKS, cur // PREP_BLOCKS] += acc
                cur, acc = r, 0
            acc += int(chunk_sums[r, c])
            taken[it] += 1
        if cur >= 0:
            slots[cur % PREP_BLOCKS, cur // PREP_BLOCKS] += acc
    assert (taken == 1).all()
    sxq = np.array([slots[r % PREP_BLOCKS, r // PREP_BLOCKS]
                    for r in range(bsz)], np.int64)
    return planes, xq, sxq, xscale


def jax_grid(xf, dtype):
    """JAX's grid of ``tenant_delta_matmul_pallas`` (pallas_binary_gemm.py
    lines 226-229), op by op."""
    x = jnp.asarray(xf).astype(dtype)
    xj = x.astype(jnp.float32)
    xmax = jnp.maximum(jnp.max(jnp.abs(xj)), 1e-30)
    xscale = xmax / (2.0 ** jpb.X_QUANT_BITS)
    return np.asarray(jnp.round(xj / xscale).astype(jnp.int32)), \
        np.float32(xscale)


DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}


def _hard_rows(rng, k):
    """Rows that land on half-integer grid points (ties: xmax = 1, so the
    step is 2^-14 and m + 0.5 steps are exact in every dtype for small m),
    a row holding the max, zeros, one large element and ordinary values."""
    ties = (rng.integers(-8, 8, k) + 0.5).astype(np.float32) * 2.0 ** -14
    top = np.zeros(k, np.float32)
    top[rng.integers(0, k)] = 1.0
    one_large = rng.standard_normal(k).astype(np.float32) * 1e-3
    one_large[0] = -0.75
    normal = rng.standard_normal(k).astype(np.float32) * 0.1
    return np.stack([ties, top, np.zeros(k, np.float32), one_large,
                     normal])


def _check_prep(x):
    """The prep model on torch ``x`` against both packages' grids."""
    xf = x.float().numpy()
    planes, xq, sxq, xscale = prep_model(xf)
    t_xq, t_xscale = tbg._canonical_quantize(x)
    xq16, t_sxq, t_xscale2 = tbg._canonical_kernel_input(x)
    np.testing.assert_array_equal(xq, t_xq.numpy())
    np.testing.assert_array_equal(xq, xq16.numpy())
    np.testing.assert_array_equal(sxq, t_sxq.numpy())
    assert xscale == t_xscale.item() == t_xscale2.item()
    assert np.abs(xq).max() <= 2 ** 14
    j_xq, j_xscale = jax_grid(xf, DTYPES[x.dtype])
    np.testing.assert_array_equal(xq, j_xq)
    assert xscale == j_xscale
    # The planes read back through the lanes hold xq, zeros past K.
    back = np.einsum("rcpk,p->rck", b_bits(planes).astype(np.int64), WEIGHT)
    back = back.reshape(xq.shape[0], -1)
    np.testing.assert_array_equal(back[:, :xq.shape[1]], xq)
    np.testing.assert_array_equal(back[:, xq.shape[1]:], 0)
    return xq, sxq


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [96, 4096])
def test_prep_matches_both_grids(dtype, k):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(_hard_rows(rng, k)).to(dtype)
    xq, _ = _check_prep(x)
    # The ties row: every value half-way between two grid points.
    want = np.rint(x[0].float().numpy() * 2.0 ** 14)
    np.testing.assert_array_equal(xq[0], want)
    assert (np.abs(want - x[0].float().numpy() * 2.0 ** 14) == 0.5).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prep_all_zero_x_takes_the_clamp(dtype):
    x = torch.zeros((3, 64), dtype=dtype)
    xq, sxq = _check_prep(x)
    assert not xq.any() and not sxq.any()
    assert prep_grid(x.float().numpy())[1] == np.float32(
        np.float32(1e-30) / np.float32(2 ** 14))


# At K = 131072 with every |x| at the input's max each xq is +-2^14 and
# a row's sum +-2^31, one past int32 for the positive row (the three
# patterns of test_torch_kernels.py::test_canonical_kernel_input_sums_in_int64).
@pytest.mark.parametrize("pattern", ["all_max", "alternating", "random"])
def test_prep_sums_rows_in_int64_at_large_k(pattern):
    k = 131072
    x = torch.full((3, k), 0.75, dtype=torch.bfloat16)
    x[1] = -0.75
    if pattern == "alternating":
        x[2, ::2] = -0.75
    elif pattern == "random":
        g = torch.Generator().manual_seed(5)
        x[2] = torch.randn((k,), generator=g).clamp(-0.75, 0.75)
    xq, sxq = _check_prep(x)
    assert sxq[:2].tolist() == [2 ** 31, -2 ** 31]
    np.testing.assert_array_equal(sxq, xq.sum(1))


# --- the main kernel's bookkeeping --------------------------------------------

def distinct_ids(ids):
    """Distinct ids in order of first occurrence (the blocks' d)."""
    out = []
    for t in ids:
        if int(t) not in out:
            out.append(int(t))
    return out


def block_rows(slab):
    """Rows one block takes in a launch of ``slab`` rows: 4 up to 16 rows
    (4 warps up to 4 rows, else 8), 8 in larger slabs."""
    return 4 if slab <= 16 else 8


def units(ids, g):
    """Per slab: the launch's grid extent in z (min(slab, g) + (slab -
    min(slab, g)) // rows a block: D distinct ids of c_d rows make
    sum ceil(c_d / R) <= D + (slab - D) // R units) and the units ``(z,
    id, rows)`` as the blocks find them: units run over the distinct ids
    in order of first occurrence, ceil(c_d / R) each; a z past the last
    unit exits."""
    out = []
    for row0 in range(0, len(ids), SLAB):
        slab = np.asarray(ids[row0:row0 + SLAB])
        rows_a_block = block_rows(len(slab))
        n_d = min(len(slab), g)
        extent = n_d + (len(slab) - n_d) // rows_a_block
        seen = distinct_ids(slab)
        counts = [-(-int((slab == t).sum()) // rows_a_block) for t in seen]
        found = []
        for z in range(extent):
            u, d = z, 0
            while d < len(seen) and u >= counts[d]:
                u -= counts[d]
                d += 1
            if d == len(seen):
                continue                       # no such unit: exits
            mine = row0 + np.flatnonzero(slab == seen[d])
            rows = mine[u * rows_a_block:(u + 1) * rows_a_block]
            assert len(rows)
            found.append((z, seen[d], rows.tolist()))
        out.append((extent, found))
    return out


@pytest.mark.parametrize("pattern", ["random", "one_id", "distinct"])
@pytest.mark.parametrize("bsz,g", [(1, 4), (3, 8), (8, 2), (16, 16),
                                   (17, 2), (65, 3), (130, 2), (130, 16),
                                   (64, 64)])
def test_units_take_every_row_once(bsz, g, pattern):
    rng = np.random.default_rng(bsz * g)
    ids = {"one_id": np.full(bsz, g - 1),
           "distinct": np.arange(bsz) % g}.get(pattern,
                                              rng.integers(0, g, bsz))
    taken = np.zeros(bsz, np.int64)
    for extent, found in units(ids, g):
        for z, t, rows in found:
            assert z < extent
            assert (ids[rows] == t).all()
            taken[rows] += 1
    assert (taken == 1).all()
    assert len(units(ids, g)) == -(-bsz // SLAB)


def test_distinct_ids_in_order_of_first_occurrence():
    assert distinct_ids(np.array([2, 0, 2, 5, 0])) == [2, 0, 5]
    assert distinct_ids(np.array([1] * 70)) == [1]


def canon_splits(live, n_chunks, sms=132, per_sm=1):
    """The host's K split: the least power of two giving ``per_sm`` live
    blocks a multiprocessor, at most MAX_SPLITS and the chunks."""
    cap = min(n_chunks, MAX_SPLITS)
    splits = 1
    while splits * live < per_sm * sms and splits * 2 <= cap:
        splits *= 2
    return splits


def test_split_rule_at_the_mixtral_sites():
    # (distinct ids at most, column tiles, chunks): q/o, k/v, w1/w3, w2.
    assert canon_splits(2 * 32, 16) == 4
    assert canon_splits(2 * 8, 16) == 8
    assert canon_splits(16 * 112, 16) == 1
    assert canon_splits(16 * 32, 56) == 1
    assert canon_splits(1, 1) == 1                      # K = 96: one chunk
    assert canon_splits(1, 1024) == 8
    for n_chunks in (1, 3, 16, 56, 1024):
        for splits in (1, 2, 8):
            s = min(splits, n_chunks)
            ranges = [(sp * n_chunks // s, (sp + 1) * n_chunks // s)
                      for sp in range(s)]
            assert ranges[0][0] == 0 and ranges[-1][1] == n_chunks
            assert all(a < b for a, b in ranges)
            assert all(ranges[i][1] == ranges[i + 1][0]
                       for i in range(s - 1))


# --- the main kernel's arithmetic --------------------------------------------

def a_stack(words, n):
    """A of every chunk and column of one matrix ``(k32, n)`` through the
    lane model: the block's m-tiles (MT = 1) gathered, converted, put back
    by column. Returns ``(chunks, n_pad, 256)`` uint8, zeros past K and
    N."""
    k32 = words.shape[0]
    n_chunks = -(-k32 // 8)
    tiles = -(-n // BN)
    w = np.zeros((n_chunks * 8, tiles * BN), np.uint32)
    w[:k32, :n] = words.view(np.uint32)
    w = w.reshape(n_chunks, 8, tiles * BN)
    out = np.zeros((n_chunks, tiles * BN, CHUNK), np.uint8)
    for tile in range(tiles):
        for warp in range(8):
            cols = tile * BN + m_tile_columns(1, warp, 0)
            out[:, cols] = a_bits(w[:, :, cols])
    return out


def kernel_model(xf, packed, scales, ids, splits):
    """The launches' arithmetic in numpy: the prep's planes and sums; for
    each slab and unit (a distinct id and group of rows), each K split
    counting popc(A & B) over its chunks (A from the words, B the planes,
    both through the lane models), the planes weighted in int64 by the
    lane quads, the splits added in rank order, the fp32 epilogue
    ``(alpha * float(2 S - sxq)) * xscale``. Returns ``(B, N)`` float32."""
    bsz, k = xf.shape
    g, k32, n = packed.shape
    n_chunks = -(-k // CHUNK)
    planes, _, sxq, xscale = prep_model(xf)
    xb = b_bits(planes).astype(np.float64)            # (B, C, 16, 256)
    splits = min(splits, n_chunks)
    parts = np.zeros((splits, bsz, n), np.int64)
    taken = np.zeros((bsz, splits), np.int64)
    for _, found in units(ids, g):
        for _, t, rows in found:
            a = a_stack(packed[t], n)[:, :n].astype(np.float64)
            for sp in range(splits):
                c0 = sp * n_chunks // splits
                c1 = (sp + 1) * n_chunks // splits
                # D[r, p, col] = popc(A & B) over the split's chunks
                # (float64 sums of 0/1 products: exact).
                a2 = a[c0:c1].transpose(1, 0, 2).reshape(n, -1)
                b2 = xb[rows, c0:c1].transpose(0, 2, 1, 3).reshape(
                    len(rows) * PLANES, -1)
                d = (b2 @ a2.T).reshape(len(rows), PLANES, n).astype(
                    np.int64)
                assert d.max() < 2 ** 31                 # the s32 sums
                # Lane t's planes 8h + 2t + e, then the quad's shuffles.
                s = np.zeros((len(rows), n), np.int64)
                for tq in range(4):
                    lane = np.zeros((len(rows), n), np.int64)
                    for h in range(2):
                        for e in range(2):
                            p = 8 * h + 2 * tq + e
                            lane += WEIGHT[p] * d[:, p]
                    s += lane
                parts[sp, rows] = s
                taken[rows, sp] += 1
    assert (taken == 1).all()              # every row, every split, once
    total = np.zeros((bsz, n), np.int64)
    for sp in range(splits):               # the cluster's rank order
        total += parts[sp]
    dq = (2 * total - sxq[:, None]).astype(np.float32)
    alpha = np.asarray(scales, np.float32)[ids]
    return (alpha[:, None] * dq) * xscale


def _world(seed, bsz, g, k, n, ids=None, all_max=False):
    rng = np.random.default_rng(seed)
    signs = rng.integers(0, 2, (g, k, n)).astype(bool)
    packed = np.array(jpack(jnp.asarray(signs)))
    scales = rng.uniform(0.001, 0.02, (g,)).astype(np.float32)
    if ids is None:
        ids = rng.integers(0, g, bsz)
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    if all_max:
        x = np.where(rng.integers(0, 2, (bsz, k)) > 0, 0.75,
                     -0.75).astype(np.float32)
        x[0] = 0.75
    x = torch.from_numpy(x).to(torch.bfloat16)
    return x, packed, scales, np.asarray(ids, np.int64)


def routed_ids(rng, bsz, n_tenants=2, experts=8, topk=2):
    """Mixtral's flattened (tenant, expert) ids: ``bsz`` decode rows, row b
    of tenant b % n_tenants routed to ``topk`` distinct experts."""
    rows = [rng.permutation(experts)[:topk] for _ in range(bsz)]
    tenant = np.arange(bsz) % n_tenants
    return (tenant[:, None] * experts + np.stack(rows)).reshape(-1)


def _ids(kind, rng, bsz, g):
    """Attention rows (row b on matrix b % g), Mixtral's routed rows, or
    None (random ids)."""
    if kind == "attention":
        return np.arange(bsz) % g
    return routed_ids(rng, bsz // 2) if kind == "routed" else None


def _plain(x, packed, scales, ids):
    return tbg.tenant_delta_matmul_plain(
        x, torch.from_numpy(packed), torch.from_numpy(scales),
        torch.from_numpy(ids)).numpy()


# K = 96: one chunk, partly past the end; N = 200 and 8: ragged column
# tiles; B = 65 and 130: past one slab; Mixtral's routed rows over 16
# (tenant, expert) matrices; each at 1, 2 and 8 K splits.
MODEL_CASES = [(1, 4, 96, 200, None), (8, 2, 4096, 200, "attention"),
               (16, 16, 4096, 200, "routed"), (16, 16, 14336, 8, "routed"),
               (65, 3, 1024, 200, None), (130, 2, 512, 136, "attention"),
               (130, 16, 256, 200, "routed")]


@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("bsz,g,k,n,kind", MODEL_CASES)
def test_kernel_model_matches_plain_exactly(bsz, g, k, n, kind, splits):
    rng = np.random.default_rng(bsz + g + k)
    ids = _ids(kind, rng, bsz, g)
    x, packed, scales, ids = _world(bsz + k + splits, bsz, g, k, n, ids)
    got = kernel_model(x.float().numpy(), packed, scales, ids, splits)
    np.testing.assert_array_equal(got, _plain(x, packed, scales, ids))


# All-max x (every |x| the input's max): at K = 262144 a row's sum of xq
# reaches 2^32 and the sums pass int32; the splits' s32 popcounts stay
# below 2^31.
@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("bsz,k", [(1, 262144), (2, 14336)])
def test_kernel_model_exact_at_large_k(bsz, k, splits):
    x, packed, scales, ids = _world(k + bsz, bsz, 2, k, 8, all_max=True)
    xf = x.float().numpy()
    _, _, sxq, _ = prep_model(xf)
    if k == 262144:
        assert sxq[0] == 2 ** 14 * k == 2 ** 32
    got = kernel_model(xf, packed, scales, ids, splits)
    np.testing.assert_array_equal(got, _plain(x, packed, scales, ids))


@pytest.mark.parametrize("bsz,g,k,n,kind", [
    (8, 2, 4096, 128, "attention"), (16, 16, 1024, 128, "routed"),
    (3, 2, 3072, 128, None), (5, 4, 512, 200, None)])
def test_kernel_model_matches_pallas(bsz, g, k, n, kind):
    rng = np.random.default_rng(3 * bsz + k)
    ids = _ids(kind, rng, bsz, g)
    x, packed, scales, ids = _world(7 * bsz + k, bsz, g, k, n, ids)
    got = kernel_model(x.float().numpy(), packed, scales, ids, 2)
    want = np.asarray(jpb.tenant_delta_matmul_pallas(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(packed),
        jnp.asarray(scales), jnp.asarray(ids, jnp.int32), interpret=True,
        out_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
