"""PyTorch port, on the card: each hand-written CUDA kernel against its
plain PyTorch version (which tests/test_torch_kernels.py holds against
the JAX package on the CPU).

Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the pair kernel (its x prep, integer sums and fp32 epilogue)
and the canonical tenant delta kernel match their plain versions
exactly; the fp32 kernels
sum in another order (1e-4 of the output scale); the attention kernels
return bf16 (2e-2 absolute, about two bf16 ulps at these magnitudes;
the tensor-core flash prefill also rounds P to bf16, about 2^-9 of a
row's scale) or fp32 (1e-4 absolute, sums in another order). Gradients
through the autograd Functions are held against autograd of the plain
versions: in fp32 to 1e-4 of each tensor's largest |value|; in bf16
each (row, head) within one bf16 ulp of its own largest |value| (2^-7
of it), since both sides compute in fp32 and round once; d_scale to
1e-5 of sum |g * u|.
The W4 matmul sums in another order than its plain version (1e-4 of the
output scale); the int8 flash decode folds the scales where the plain
version dequantizes first (the attention tolerances). The fused base +
delta kernels (rows 9 and 10) sum the exact products of x and W (bf16
products are exact in fp32) and the ±x delta terms in another order than
cuBLAS and the plain version, in bf16 and fp32 alike: 1e-4 of the output
scale; row 10's integer pair sums and epilogue are exact."""

import time

import pytest
import torch

from bitdelta_torch.core.delta import BinaryDelta, pair_delta
from bitdelta_torch.ops import binary_gemm as tbg
from bitdelta_torch.ops import flash_decode as tfd
from bitdelta_torch.ops import flash_prefill as tfp
from bitdelta_torch.ops import int4 as ti
from bitdelta_torch.ops.binary_matmul import matmul_f32
from bitdelta_torch.ops.kv_quant import quantize_kv

# Output tolerance of the attention kernels per working dtype.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
PAIR_KERNEL_NAMES = ("pair_prep_kernel", "pair_delta_tc_kernel")


def _trace(run, want=()):
    """torch.profiler's event averages of ``run()`` on the card. The window
    opens 10 ms before the work and closes 10 ms after it: the profiler
    drops device records near its edges. On the H100 it still loses a
    trace's kernels now and then, so a trace that lacks any of the
    kernel names in ``want`` is taken again, three times at most."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            out = run()
            torch.cuda.synchronize()
            time.sleep(0.01)
        events = prof.key_averages()
        if all(any(name in evt.key for evt in events) for name in want):
            break
    return out, events


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_pair_delta_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    packed = torch.randint(-2**31, 2**31 - 1, (3, 1024 // 32, 512),
                           generator=g, device=cuda, dtype=torch.int32)
    scales = torch.rand((3,), generator=g, device=cuda) + 0.1
    pd = pair_delta(BinaryDelta(packed, scales))
    x = torch.randn((8, 1024), generator=g, device=cuda).to(torch.bfloat16)
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0], device=cuda)
    args = [pd.packed_pairs, pd.colsum, pd.scale, ids]
    got = tbg.tenant_delta_matmul_pair(x, *args, out_dtype=torch.float32)
    want = tbg.tenant_delta_matmul_pair_plain(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _pair_inputs(cuda, bsz, t, k, n, seed, ids=None, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    pairs = torch.randint(-2**31, 2**31 - 1, (t, k // 16, n // 2),
                          generator=g, device=cuda, dtype=torch.int32)
    colsum = torch.randint(-k, k + 1, (t, n), generator=g,
                           device=cuda).to(torch.float32)
    scales = torch.rand((t,), generator=g, device=cuda) * 0.01 + 0.001
    x = torch.randn((bsz, k), generator=g, device=cuda).to(dtype)
    if ids is None:
        ids = torch.randint(0, t, (bsz,), generator=g, device=cuda)
    else:
        ids = torch.tensor(ids, device=cuda)
    return x, [pairs, colsum, scales, ids]


# Row 1 at the Mistral-7B projections (q/o, k/v, gate/up, down) and the
# N = 32000 head, every row count from one to two MMA row tiles.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz", [1, 3, 8, 11, 16])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4096, 32000)])
def test_cuda_pair_delta_exact_at_mistral_shapes(cuda, bsz, k, n):
    x, args = _pair_inputs(cuda, bsz, 3, k, n, seed=bsz + k + n)
    before = tbg.tenant_delta_matmul_pair.launches
    got = tbg.tenant_delta_matmul_pair(x, *args, out_dtype=torch.float32)
    want = tbg.tenant_delta_matmul_pair_plain(x, *args)
    torch.cuda.synchronize()
    assert tbg.tenant_delta_matmul_pair.launches == before + 1
    assert got.shape == (bsz, n) and got.dtype == torch.float32
    assert torch.equal(got, want)


# Tenant patterns: all rows on one tenant, every row its own, more
# tenants than rows, int32 ids, fp32 x, up to 64 rows, a tenant with more
# rows than a block takes (35 of 40), K = 32 and K = 4128 (a 256-K chunk
# cut short).
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,t,k,n,ids,dtype", [
    (8, 3, 4096, 1024, [1] * 8, torch.bfloat16),
    (8, 8, 4096, 1024, list(range(8)), torch.bfloat16),
    (3, 7, 4096, 4096, [6, 0, 6], torch.bfloat16),
    (16, 16, 4096, 14336, list(range(15, -1, -1)), torch.bfloat16),
    (11, 5, 1024, 512, None, torch.float32),
    (33, 4, 2048, 768, None, torch.bfloat16),
    (64, 9, 1024, 512, None, torch.float32),
    (5, 2, 32, 256, [1, 0, 1, 1, 0], torch.bfloat16),
    (8, 3, 4128, 1024, None, torch.bfloat16),
    (40, 2, 1024, 512, [1] * 35 + [0] * 5, torch.bfloat16)])
def test_cuda_pair_delta_tenant_patterns(cuda, bsz, t, k, n, ids, dtype):
    x, args = _pair_inputs(cuda, bsz, t, k, n, seed=bsz * t + k, ids=ids,
                           dtype=dtype)
    got = tbg.tenant_delta_matmul_pair(x, *args, out_dtype=torch.float32)
    got32 = tbg.tenant_delta_matmul_pair(x, *args[:3],
                                         args[3].to(torch.int32),
                                         out_dtype=torch.float32)
    want = tbg.tenant_delta_matmul_pair_plain(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got32, want)


# One set sign bit at (kk, nn) of one tenant over all-clear words: the
# output moves from the all-clear output in column nn of that tenant's
# rows alone, and equals the plain version. A misplaced fragment, a wrong
# K permutation or a lost half moves it elsewhere.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("kk,nn", [(0, 0), (15, 128), (16, 255), (31, 1),
                                   (4095, 4095), (2049, 3000), (7, 2175)])
def test_cuda_pair_delta_one_hot_bit(cuda, kk, nn):
    from bitdelta_torch.ops.packing import pack_signs, repack_pairs

    k, n, t = 4096, 4096, 3
    g = torch.Generator(device=cuda).manual_seed(kk + nn)
    signs = torch.zeros((t, k, n), dtype=torch.bool, device=cuda)
    clear = repack_pairs(pack_signs(signs))
    signs[1, kk, nn] = True
    one = repack_pairs(pack_signs(signs))
    colsum = torch.zeros((t, n), device=cuda)
    scales = torch.tensor([0.5, 0.25, 0.75], device=cuda)
    x = torch.randn((8, k), generator=g, device=cuda).to(torch.bfloat16)
    ids = torch.tensor([0, 1, 2, 1, 0, 1, 2, 2], device=cuda)
    y0 = tbg.tenant_delta_matmul_pair(x, clear, colsum, scales, ids,
                                      out_dtype=torch.float32)
    y1 = tbg.tenant_delta_matmul_pair(x, one, colsum, scales, ids,
                                      out_dtype=torch.float32)
    want = tbg.tenant_delta_matmul_pair_plain(x, one, colsum, scales, ids)
    torch.cuda.synchronize()
    assert torch.equal(y1, want)
    moved = (y1 != y0).nonzero().tolist()
    rows = [b for b in range(8) if ids[b] == 1
            and tbg._pair_quantize(x[b:b + 1], scales, ids[b:b + 1])[0][
                0, kk] != 0]
    assert moved == [[b, nn] for b in rows]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,k,n", [(8, 4096, 1024), (16, 14336, 4096)])
def test_cuda_pair_delta_is_deterministic(cuda, bsz, k, n):
    # The K splits of a column tile add their integer sums through
    # distributed shared memory in rank order: no atomics, so equal.
    x, args = _pair_inputs(cuda, bsz, 3, k, n, seed=31)
    first = tbg.tenant_delta_matmul_pair(x, *args, out_dtype=torch.float32)
    second = tbg.tenant_delta_matmul_pair(x, *args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.requires_cuda
def test_cuda_pair_delta_launches_its_two_kernels_only(cuda):
    x, args = _pair_inputs(cuda, 8, 3, 4096, 1024, seed=32)
    tbg.tenant_delta_matmul_pair(x, *args, out_dtype=torch.float32)
    _, events = _trace(lambda: tbg.tenant_delta_matmul_pair(
        x, *args, out_dtype=torch.float32), want=PAIR_KERNEL_NAMES)
    names = sorted(evt.key for evt in events
                   if getattr(evt, "device_time_total",
                              getattr(evt, "cuda_time_total", 0)) > 0)
    assert len(names) == 2, names
    assert "pair_prep_kernel" in names[0] + names[1]
    assert "pair_delta_tc_kernel" in names[0] + names[1]


# More rows than one main-kernel launch takes (64): Mistral at 65 and 128
# slots (a tenant across the slab boundary), Mixtral's routed rows at 33
# slots (66 rows over 2 tenants x 8 experts, w1 / w3 and w2 shapes), and
# one row at K = 200704 (the prep's longest row range). Exact, and the
# profiler sees the prep once and the main kernel once a slab.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,t,k,n", [(65, 3, 4096, 4096),
                                       (128, 3, 4096, 14336),
                                       (66, 16, 4096, 14336),
                                       (66, 16, 14336, 4096),
                                       (1, 2, 200704, 256)])
def test_cuda_pair_delta_exact_past_one_launch(cuda, bsz, t, k, n):
    ids = [b % t for b in range(bsz)] if t == 3 else None
    x, args = _pair_inputs(cuda, bsz, t, k, n, seed=bsz + t, ids=ids)
    want = tbg.tenant_delta_matmul_pair_plain(x, *args)
    got, events = _trace(lambda: tbg.tenant_delta_matmul_pair(
        x, *args, out_dtype=torch.float32), want=PAIR_KERNEL_NAMES)
    assert torch.equal(got, want)
    counts = {}
    for evt in events:
        for name in ("pair_prep_kernel", "pair_delta_tc_kernel"):
            if name in evt.key:
                counts[name] = counts.get(name, 0) + evt.count
    assert counts == {"pair_prep_kernel": 1,
                      "pair_delta_tc_kernel": -(-bsz // 64)}


@pytest.mark.requires_cuda
def test_cuda_pair_delta_refuses_what_it_does_not_take(cuda):
    x, args = _pair_inputs(cuda, 8, 3, 1024, 512, seed=33)
    pairs, colsum, scales, ids = args
    bad = [
        (x.to(torch.float16), args),
        (x, [pairs, colsum.to(torch.bfloat16), scales, ids]),
        (x, [pairs, colsum, scales, ids.to(torch.int16)]),
        (x, [pairs[:, :, ::2], colsum[:, ::2], scales, ids]),
        (x[:, :1008], [pairs[:, :63].contiguous(), colsum, scales, ids]),
        (x.t().contiguous().t(), args),
    ]
    before = tbg.tenant_delta_matmul_pair.launches
    for xb, ab in bad:
        with pytest.raises((ValueError, TypeError)):
            tbg.tenant_delta_matmul_pair(xb, *ab, out_dtype=torch.float32)
    assert tbg.tenant_delta_matmul_pair.launches == before


# The plain prep on the card against the plain prep on the CPU: the step
# divides by a device tensor (IEEE), where a Python scalar divisor becomes
# a multiply by its reciprocal on the card. Rows with ties (an exact
# 0..4095 range and half-integer values), a constant row, a range of one
# ulp, +-1e30, ordinary values, and rows where the scalar form and the
# IEEE quotient differ.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pair_quantize_matches_the_cpu(cuda, dtype):
    g = torch.Generator().manual_seed(34)
    k = 4096
    ties = torch.randint(0, 4095, (k,), generator=g).float() + 0.5
    ties[:2] = torch.tensor([0.0, 4095.0])
    tiny = torch.ones(k)
    tiny[::7] = torch.nextafter(torch.tensor(1.0), torch.tensor(2.0))
    rows = [ties, torch.full((k,), -3.25), tiny,
            torch.randn((k,), generator=g) * 1e30]
    rows += list(torch.randn((60, k), generator=g)
                 * torch.rand((60, 1), generator=g) * 10)
    x = torch.stack(rows).to(dtype)
    scales = torch.rand((3,), generator=g) + 0.1
    ids = torch.randint(0, 3, (x.shape[0],), generator=g)
    cpu = tbg._pair_quantize(x, scales, ids)
    card = tbg._pair_quantize(x.to(cuda), scales.to(cuda), ids.to(cuda))
    for c, d in zip(cpu, card):
        assert torch.equal(c, d.cpu())
    # The form this replaced differs on the card (reported, not required).
    xf = x.to(cuda).float()
    rng = xf.max(1).values - xf.min(1).values
    old = torch.clamp(rng / tbg.PAIR_Q_LEVELS, min=1e-30)
    new = torch.clamp(rng / torch.full_like(rng, tbg.PAIR_Q_LEVELS),
                      min=1e-30)
    print("pair step: scalar-divisor rows off the IEEE quotient:",
          int((old != new).sum()), "of", rng.numel())


def _nan_row(call, plain, x, row, kk, exact):
    """One NaN at ``x[row, kk]``: row ``row`` NaN throughout in the call
    and the plain version; every other row bit-equal to the call on the
    clean x, and equal to the plain version (``exact``) or within 1e-4 of
    its largest |value|."""
    clean = call(x)
    xn = x.clone()
    xn[row, kk] = float("nan")
    got, want = call(xn), plain(xn)
    torch.cuda.synchronize()
    assert want[row].isnan().all() and got[row].isnan().all()
    keep = torch.arange(x.shape[0], device=x.device) != row
    assert not got[keep].isnan().any()
    assert torch.equal(got[keep], clean[keep])
    atol = 0.0 if exact else 1e-4 * want[keep].abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=atol, equal_nan=True)


# Row 1's prep keeps a NaN of x in its min and max, as the plain version's
# (and JAX's) min and max do: that row's output is NaN, every other row is
# as before. The NaN inside a 32-K step (row 1, K = 4096, exact against
# plain) and in the 16-value tail that only row 10 sends (K = 1040: the
# bf16 kernel shares row 1's prep; fp32 takes the plain-torch prep), at B
# = 8 and at B = 65 (row 64: the second slab of both main kernels).
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,row", [(8, 3), (65, 64)])
@pytest.mark.parametrize("where", ["step", "tail"])
def test_cuda_pair_delta_nan_in_x(cuda, dtype, bsz, row, where):
    if where == "step":
        x, args = _pair_inputs(cuda, bsz, 3, 4096, 1024, seed=bsz + row,
                               dtype=dtype)
        _nan_row(lambda xx: tbg.tenant_delta_matmul_pair(
                     xx, *args, out_dtype=torch.float32),
                 lambda xx: tbg.tenant_delta_matmul_pair_plain(xx, *args),
                 x, row, 100, exact=True)
    else:
        x, w, args = _fused_pair_inputs(cuda, dtype, bsz, 3, 1040, 1024,
                                        seed=bsz + row)
        _nan_row(lambda xx: tbg.fused_base_pair_matmul(
                     xx, w, *args, out_dtype=torch.float32),
                 lambda xx: tbg.fused_base_pair_matmul_plain(xx, w, *args),
                 x, row, 1030, exact=False)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n,rows", [(4096, 1024, 8), (14336, 4096, 16),
                                      (1024, 200, 5)])
def test_cuda_tenant_delta_matches_plain_exactly(cuda, dtype, k, n, rows):
    # Row 7: integer sums and the fp32 epilogue in the plain version's
    # order, so kernel and plain version agree bit for bit (N = 200
    # leaves a ragged last column tile).
    g = torch.Generator(device=cuda).manual_seed(9)
    packed = torch.randint(-2**31, 2**31 - 1, (16, k // 32, n),
                           generator=g, device=cuda, dtype=torch.int32)
    scales = torch.rand((16,), generator=g, device=cuda) + 0.1
    ids = torch.randint(0, 16, (rows,), generator=g, device=cuda)
    x = torch.randn((rows, k), generator=g, device=cuda).to(dtype)
    for xin in (x, torch.zeros_like(x)):
        got = tbg.tenant_delta_matmul(xin, packed, scales, ids,
                                      out_dtype=torch.float32)
        want = tbg.tenant_delta_matmul_plain(xin, packed, scales, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_tenant_dense_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((8, 512), generator=g, device=cuda).to(dtype)
    w = torch.randn((3, 512, 1000), generator=g, device=cuda).to(dtype)
    ids = torch.tensor([0, 2, 2, 1, 0, 0, 1, 2], device=cuda)
    got = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    want = tbg.tenant_dense_matmul_plain(x, w, ids)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _dense_inputs(cuda, bsz, t, k, n, seed, ids=None, x_dtype=torch.bfloat16,
                  w_dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((bsz, k), generator=g, device=cuda).to(x_dtype)
    w = (torch.randn((t, k, n), generator=g, device=cuda) * 0.02).to(w_dtype)
    if ids is None:
        ids = torch.randint(0, t, (bsz,), generator=g, device=cuda)
    else:
        ids = torch.tensor(ids, device=cuda)
    return x, w, ids


def _dense_close(got, want):
    # fp32 sums of exact products, in another order: 1e-4 of the output
    # scale.
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


# Row 3's tensor-core kernel: B from one row to a slab (16 and 32 rows an
# n8 side), K 520 (a stage cut short) and 1024, N 1000 (a tile cut short)
# and 4096, up to 8 tenants (distinct tenants at most B).
@pytest.mark.requires_cuda
@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("k,n", [(520, 1000), (520, 4096), (1024, 1000),
                                 (1024, 4096)])
@pytest.mark.parametrize("bsz", [1, 8, 9, 65, 128])
def test_cuda_tenant_dense_tc_matches_plain(cuda, bsz, k, n, t):
    x, w, ids = _dense_inputs(cuda, bsz, t, k, n, seed=bsz + k + n + t)
    before = tbg.tenant_dense_matmul.launches
    got = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    want = tbg.tenant_dense_matmul_plain(x, w, ids)
    torch.cuda.synchronize()
    _dense_close(got, want)
    assert tbg.tenant_dense_matmul.launches == before + 1


def _per_tenant(x, w, ids):
    """One fp32-summed matmul a distinct tenant on its rows (reads each
    head once; no (B, K, N) gather)."""
    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for t in torch.unique(ids).tolist():
        rows = (ids == t).nonzero()[:, 0]
        out[rows] = matmul_f32(x[rows], w[t])
    return out


# Mistral-7B's head: B 1 and 8 against the plain version; at B 65 and 128
# (65 slots and more, one tenant holding most rows) the gathering plain
# version would copy 17-34 GB, so each tenant's rows are held against one
# matmul on its head.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,ids", [
    (1, [2]), (8, [0, 1, 2, 0, 1, 2, 0, 0]),
    (65, [0] * 40 + [1] * 13 + [2] * 12),
    (128, [0] * 100 + [1, 2] * 14)])
def test_cuda_tenant_dense_tc_at_full_width(cuda, bsz, ids):
    x, w, ids = _dense_inputs(cuda, bsz, 3, 4096, 32000, seed=bsz, ids=ids)
    got = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    want = (tbg.tenant_dense_matmul_plain(x, w, ids) if bsz <= 8
            else _per_tenant(x, w, ids))
    torch.cuda.synchronize()
    _dense_close(got, want)


# Tenant patterns: every row on one tenant (one or several units of its
# rows), every row on its own tenant, ids as int32 and int64, a tenant
# whose rows are spread.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,t,ids", [
    (8, 4, [3] * 8), (65, 2, [1] * 65), (128, 1, [0] * 128),
    (8, 8, list(range(8))), (32, 32, list(range(31, -1, -1))),
    (128, 128, list(range(128))), (40, 5, [4, 0] * 20)])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_cuda_tenant_dense_tc_tenant_patterns(cuda, bsz, t, ids, ids_dtype):
    x, w, ids = _dense_inputs(cuda, bsz, t, 1024, 512, seed=bsz + t, ids=ids)
    ids = ids.to(ids_dtype)
    got = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    want = tbg.tenant_dense_matmul_plain(x, w, ids)
    torch.cuda.synchronize()
    _dense_close(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,k,n", [(8, 4096, 32000), (8, 4096, 256),
                                     (65, 14336, 512)])
def test_cuda_tenant_dense_tc_is_deterministic(cuda, bsz, k, n):
    # A narrow head splits K over a cluster, whose blocks add their
    # partials in rank order: no atomics, so two calls are equal.
    x, w, ids = _dense_inputs(cuda, bsz, 3, k, n, seed=k + n)
    first = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    second = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _dense_close(first, tbg.tenant_dense_matmul_plain(x, w, ids))


def _kernel_counts(events):
    counts = {}
    for evt in events:
        if getattr(evt, "device_time_total",
                   getattr(evt, "cuda_time_total", 0)) > 0:
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    return counts


# A bf16 call launches the tensor-core kernel once for each 128 rows and
# nothing else (no scratch, no split sum); fp32 and mixed pairs take the
# CUDA-core kernel and its split sum.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz", [8, 129])
def test_cuda_tenant_dense_launches_one_kernel(cuda, bsz):
    x, w, ids = _dense_inputs(cuda, bsz, 3, 4096, 4096, seed=bsz)
    tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    _, events = _trace(lambda: tbg.tenant_dense_matmul(
        x, w, ids, out_dtype=torch.float32), want=("tenant_dense_tc_kernel",))
    counts = _kernel_counts(events)
    main = sum(c for nm, c in counts.items() if "tenant_dense_tc_kernel" in nm)
    assert main == sum(counts.values()) == -(-bsz // 128), sorted(counts)
    _, events = _trace(lambda: tbg.tenant_dense_matmul(
        x, w.float(), ids, out_dtype=torch.float32),
        want=("tenant_dense_kernel",))
    keys = " ".join(_kernel_counts(events))
    assert "tenant_dense_kernel" in keys and "sum_splits_kernel" in keys
    assert "tenant_dense_tc_kernel" not in keys


# The CUDA-core kernel: x and W each bf16, fp16 or fp32 (the TPU kernel
# widens both to fp32), and a bf16 pair whose K or N is not a multiple of
# 8. An fp32 head under a bf16 compute dtype is the model's case.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("x_dtype,w_dtype,k,n", [
    (torch.bfloat16, torch.float32, 512, 1000),
    (torch.float32, torch.bfloat16, 512, 1000),
    (torch.float16, torch.float32, 512, 1000),
    (torch.bfloat16, torch.float16, 512, 1000),
    (torch.float16, torch.float16, 512, 1000),
    (torch.float32, torch.float32, 512, 1000),
    (torch.bfloat16, torch.bfloat16, 512, 1001),
    (torch.bfloat16, torch.bfloat16, 515, 1000),
    (torch.bfloat16, torch.float32, 4096, 32000)])
def test_cuda_tenant_dense_core_takes_every_dtype_pair(cuda, x_dtype,
                                                       w_dtype, k, n):
    x, w, ids = _dense_inputs(cuda, 8, 3, k, n, seed=k + n, x_dtype=x_dtype,
                              w_dtype=w_dtype)
    got = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    want = tbg.tenant_dense_matmul_plain(x, w, ids)
    torch.cuda.synchronize()
    _dense_close(got, want)
    _, events = _trace(lambda: tbg.tenant_dense_matmul(
        x, w, ids, out_dtype=torch.float32), want=("tenant_dense_kernel",))
    keys = " ".join(_kernel_counts(events))
    assert "tenant_dense_kernel" in keys and "tenant_dense_tc_kernel" \
        not in keys


# The smallest input the card once refused: x bf16 (1, 8), W fp32.
@pytest.mark.requires_cuda
def test_cuda_tenant_dense_smallest_mixed_input(cuda):
    x, w, ids = _dense_inputs(cuda, 1, 1, 8, 8, seed=0, w_dtype=torch.float32)
    got = tbg.tenant_dense_matmul(x, w, ids)
    assert got.dtype == torch.bfloat16
    want = tbg.tenant_dense_matmul_plain(x, w, ids)
    torch.cuda.synchronize()
    _dense_close(tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32),
                 want)


# Rows 5 and 6: M from one row to the training batch; (K, N) a ragged
# N = 200 (not a multiple of 16), k/v (split reduction) and down_proj.
BINARY_M = (1, 130, 512)
BINARY_KN = ((1024, 200), (4096, 1024), (14336, 4096))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", BINARY_KN)
@pytest.mark.parametrize("m", BINARY_M)
def test_cuda_binary_matmul_matches_plain(cuda, m, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    packed = torch.randint(-2**31, 2**31 - 1, (k // 32, n), generator=g,
                           device=cuda, dtype=torch.int32)
    scale = torch.tensor(0.37, device=cuda)
    before = tbg.binary_matmul.launches
    got = tbg.binary_matmul(x, packed, scale, out_dtype=torch.float32)
    want = tbg.binary_matmul_plain(x, packed, scale)
    torch.cuda.synchronize()
    assert tbg.binary_matmul.launches == before + 1
    assert got.shape == (m, n)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("kvh", [8, 32])
def test_cuda_flash_decode_matches_plain(cuda, window, dtype, kvh):
    """32 query heads over 8 KV heads (Mistral) or 32 (Llama-2-7B: the
    kernel's one-query-head-a-KV-head instance)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((4, 32, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((4, 512, kvh, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn_like(k)
    lengths = torch.tensor([512, 1, 300, 77], device=cuda)
    got = tfd.flash_decode_attention(q, k, v, lengths, window=window)
    want = tfd.flash_decode_attention_plain(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("kvh", [8, 32])
def test_cuda_flash_prefill_matches_plain(cuda, window, dtype, kvh):
    """32 query heads over 8 KV heads or 32, as flash decode's test."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((2, 128, 32, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 192, kvh, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn_like(k)
    lengths = torch.tensor([128, 70], device=cuda)
    got = tfp.flash_prefill_attention(q, k, v, lengths, window=window)
    want = tfp.flash_prefill_attention_plain(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    assert not got[1, 70:].any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", BINARY_KN + ((33 * 32, 200),))
@pytest.mark.parametrize("m", BINARY_M)
def test_cuda_binary_matmul_t_matches_plain(cuda, m, k, n, dtype):
    # K32 = 33 leaves a partial last 128-column output tile.
    g = torch.Generator(device=cuda).manual_seed(5)
    grad = torch.randn((m, n), generator=g, device=cuda).to(dtype)
    packed = torch.randint(-2**31, 2**31 - 1, (k // 32, n), generator=g,
                           device=cuda, dtype=torch.int32)
    scale = torch.tensor(0.37, device=cuda)
    before = tbg.binary_matmul_t.launches
    got = tbg.binary_matmul_t(grad, packed, scale, out_dtype=torch.float32)
    want = tbg.binary_matmul_t_plain(grad, packed, scale)
    torch.cuda.synchronize()
    assert tbg.binary_matmul_t.launches == before + 1
    assert got.shape == (m, k)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_binary_matmul_takes_odd_n_and_strided_rows(cuda, dtype):
    # Row 6 with N = 100 (the wrapper pads g's rows to a multiple of 8);
    # row 5 on a slice of a larger tensor, then on one that starts 2 bytes
    # off a 16-byte boundary (the wrapper copies it).
    g = torch.Generator(device=cuda).manual_seed(14)
    packed = torch.randint(-2**31, 2**31 - 1, (4, 100), generator=g,
                           device=cuda, dtype=torch.int32)
    scale = torch.tensor(0.5, device=cuda)
    grad = torch.randn((70, 100), generator=g, device=cuda).to(dtype)
    got = tbg.binary_matmul_t(grad, packed, scale, out_dtype=torch.float32)
    want = tbg.binary_matmul_t_plain(grad, packed, scale)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    big = torch.randn((3 * 70 * 128 + 1,), generator=g, device=cuda).to(dtype)
    for x in (big[:-1].view(3, 70, 128)[1], big[1:].view(3, 70, 128)[0]):
        got = tbg.binary_matmul(x, packed, scale, out_dtype=torch.float32)
        want = tbg.binary_matmul_plain(x, packed, scale)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max(
            ).item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 100])
def test_cuda_flash_decode_on_a_full_cache_matches_plain(cuda, window, int8):
    # A decode step on a full cache attends with length S + 1 (its own
    # write dropped): the kernel reads no key past slot S - 1, and the
    # window starts from S + 1 as in the plain version.
    g = torch.Generator(device=cuda).manual_seed(15)
    s = 512
    q = torch.randn((3, 32, 128), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((3, s, 8, 128), generator=g, device=cuda)
    v = torch.randn_like(k)
    scales = {}
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    lengths = torch.tensor([s + 1, s + 1, s], device=cuda)
    got = tfd.flash_decode_attention(q, k, v, lengths, window=window,
                                     **scales)
    want = tfd.flash_decode_attention_plain(q, k, v, lengths, window=window,
                                            **scales)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[
        torch.bfloat16]


def _grad_close(got, want, rows_of):
    """fp32: within 1e-4 of the largest |want|; bf16: each row of
    ``rows_of`` values within 2^-7 of that row's largest |want|."""
    got, want = got.float(), want.float()
    if rows_of is None:
        return (got - want).abs().max().item() <= 1e-4 * want.abs().max()
    diff = (got - want).reshape(-1, rows_of).abs().amax(-1)
    return bool((diff <= 2 ** -7 * want.reshape(-1, rows_of).abs().amax(-1)
                 ).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_binary_matmul_trainable_grads_match_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((512, 1024), generator=g, device=cuda).to(dtype)
    packed = torch.randint(-2**31, 2**31 - 1, (32, 384), generator=g,
                           device=cuda, dtype=torch.int32)
    gy = torch.randn((512, 384), generator=g, device=cuda).to(dtype)
    x1, s1 = x.clone().requires_grad_(), torch.tensor(
        0.02, device=cuda, requires_grad=True)
    x2, s2 = x.clone().requires_grad_(), torch.tensor(
        0.02, device=cuda, requires_grad=True)
    counts = (tbg.binary_matmul.launches, tbg.binary_matmul_t.launches)
    tbg.binary_matmul_trainable(x1, packed, s1).backward(gy)
    # The plain version under autograd, rounded to x's dtype as the
    # trainable forward is.
    tbg.binary_matmul_plain(x2, packed, s2).to(dtype).backward(gy)
    torch.cuda.synchronize()
    assert (tbg.binary_matmul.launches, tbg.binary_matmul_t.launches) == (
        counts[0] + 2, counts[1] + 1)
    assert x1.grad.dtype == dtype
    assert _grad_close(x1.grad, x2.grad,
                       None if dtype == torch.float32 else 1024)
    u = tbg.binary_matmul_plain(x, packed, torch.tensor(1.0, device=cuda))
    mag = (gy.float() * u).abs().sum().item()
    assert abs(s1.grad.item() - s2.grad.item()) <= 1e-5 * mag


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_prefill_grads_match_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((4, 128, 32, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((4, 128, 8, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn_like(k)
    gout = torch.randn((4, 128, 32 * 128), generator=g, device=cuda).to(dtype)
    lengths = torch.tensor([128, 128, 128, 77], device=cuda)
    ins1 = [t.clone().requires_grad_() for t in (q, k, v)]
    ins2 = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tfp.flash_prefill_attention.launches
    tfp.flash_prefill_attention(*ins1, lengths, window=100).backward(gout)
    tfp.flash_prefill_attention_plain(*ins2, lengths,
                                      window=100).backward(gout)
    torch.cuda.synchronize()
    assert tfp.flash_prefill_attention.launches == before + 1
    for a, b in zip(ins1, ins2):
        assert a.grad.dtype == dtype
        assert _grad_close(a.grad, b.grad,
                           None if dtype == torch.float32 else 128)
        assert not a.grad[3, 77:].any()


@pytest.mark.requires_cuda
def test_cuda_matmul_f32_carries_gradients(cuda):
    # cuBLAS with an fp32 output type has no derivative in torch; the
    # port's Function gives it the widened transpose.
    g = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn((64, 256), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((256, 96), generator=g, device=cuda).to(torch.bfloat16)
    gy = torch.randn((64, 96), generator=g, device=cuda)
    a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
    a2, w2 = a.clone().requires_grad_(), w.clone().requires_grad_()
    matmul_f32(a1, w1).backward(gy)
    torch.matmul(a2.float(), w2.float()).backward(gy)
    torch.cuda.synchronize()
    for got, want in ((a1.grad, a2.grad), (w1.grad, w2.grad)):
        assert got.dtype == torch.bfloat16
        assert _grad_close(got, want, want.shape[-1])


def _w4_inputs(cuda, m, k, n, dtype, seed):
    from bitdelta_torch.research.quantized_base import quantize_int4

    g = torch.Generator(device=cuda).manual_seed(seed)
    w = quantize_int4(torch.randn((k, n), generator=g, device=cuda) * 0.02)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    return x, w


# N = 1030: rows of 4120 bytes, not a multiple of 16 (narrow copies).
@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1024, 1030, 14336])
@pytest.mark.parametrize("k", [128, 4096, 14336])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 64])
def test_cuda_w4_matmul_matches_plain(cuda, m, dtype, k, n):
    x, w = _w4_inputs(cuda, m, k, n, dtype, seed=9)
    before = ti.w4_matmul.launches
    got = ti.w4_matmul(x, w.packed, w.scale, out_dtype=torch.float32)
    want = ti.w4_matmul_plain(x, w.packed, w.scale)
    torch.cuda.synchronize()
    assert ti.w4_matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# One nonzero nibble at (kk, nn) and x one-hot in kk: y is that nibble
# times its scale in column nn alone, exactly. A misplaced fragment or a
# wrong K permutation moves the value to another column or drops it.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,row", [(1, 0), (8, 5), (9, 8), (64, 37)])
@pytest.mark.parametrize("n", [1024, 1030])
@pytest.mark.parametrize("kk,nn,nib", [(0, 0, 7), (5, 3, -8), (130, 17, 3),
                                       (1023, -1, -1), (777, 514, 5),
                                       (4, 1, 1), (11, 6, -3)])
def test_cuda_w4_matmul_one_hot(cuda, dtype, m, row, n, kk, nn, nib):
    from bitdelta_torch.research.quantized_base import _pack_nibbles

    k, nn = 1024, nn % n                   # nn = -1: the last column
    q = torch.zeros((k, n), dtype=torch.int32, device=cuda)
    q[kk, nn] = nib
    scale = torch.full((k // 128, n), 0.5, device=cuda)
    scale[kk // 128, nn] = 0.375
    x = torch.zeros((m, k), dtype=dtype, device=cuda)
    x[row, kk] = 1.5
    got = ti.w4_matmul(x, _pack_nibbles(q), scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = torch.zeros((m, n), device=cuda)
    want[row, nn] = nib * 0.375 * 1.5
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n", [(8, 1024), (3, 1030), (64, 4096)])
def test_cuda_w4_matmul_is_deterministic(cuda, dtype, m, n):
    x, w = _w4_inputs(cuda, m, 4096, n, dtype, seed=11)
    first = ti.w4_matmul(x, w.packed, w.scale, out_dtype=torch.float32)
    second = ti.w4_matmul(x, w.packed, w.scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,want,not_want", [
    (torch.bfloat16, "w4_matmul_tc_kernel", "w4_matmul_fp32_kernel"),
    (torch.float32, "w4_matmul_fp32_kernel", "w4_matmul_tc_kernel")])
def test_cuda_w4_matmul_kernel_by_dtype(cuda, dtype, want, not_want):
    x, w = _w4_inputs(cuda, 8, 4096, 1024, dtype, seed=12)
    ti.w4_matmul(x, w.packed, w.scale)
    _, events = _trace(lambda: ti.w4_matmul(x, w.packed, w.scale),
                       want=("w4_matmul",))
    names = " ".join(evt.key for evt in events)
    assert want in names and not_want not in names, names


@pytest.mark.requires_cuda
def test_cuda_w4_group16_launches_nothing(cuda):
    # A 16-row-group weight (a GPTQ import) at a decode shape: the model's
    # dispatch keeps int4_matmul, and the kernel's wrapper refuses it.
    from bitdelta_torch.models.llama import _base_matmul
    from bitdelta_torch.research.quantized_base import (int4_matmul,
                                                        quantize_int4)

    g = torch.Generator(device=cuda).manual_seed(10)
    w = quantize_int4(torch.randn((1024, 512), generator=g, device=cuda),
                      group=16)
    x = torch.randn((8, 1024), generator=g, device=cuda).to(torch.bfloat16)
    before = ti.w4_matmul.launches
    got = _base_matmul(x, w, torch.bfloat16, kernel="cuda")
    want = int4_matmul(x, w, torch.bfloat16, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ti.w4_matmul.launches == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ti.w4_matmul(x, w.packed, w.scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 100])
def test_cuda_flash_decode_int8_matches_plain(cuda, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((4, 32, 128), generator=g, device=cuda).to(dtype)
    k8, ks = quantize_kv(torch.randn((4, 512, 8, 128), generator=g,
                                     device=cuda))
    v8, vs = quantize_kv(torch.randn((4, 512, 8, 128), generator=g,
                                     device=cuda))
    lengths = torch.tensor([512, 1, 300, 77], device=cuda)
    before = tfd.flash_decode_attention.launches
    got = tfd.flash_decode_attention(q, k8, v8, lengths, k_scale=ks,
                                      v_scale=vs, window=window)
    want = tfd.flash_decode_attention_plain(q, k8, v8, lengths, k_scale=ks,
                                            v_scale=vs, window=window)
    torch.cuda.synchronize()
    assert tfd.flash_decode_attention.launches == before + 1
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


def _fused_inputs(cuda, dtype, bsz, t, k, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((bsz, k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda) * 0.02).to(dtype)
    packed = torch.randint(-2**31, 2**31 - 1, (t, k // 32, n), generator=g,
                           device=cuda, dtype=torch.int32)
    scales = torch.rand((t,), generator=g, device=cuda) * 0.01 + 0.001
    ids = torch.randint(0, t, (bsz,), generator=g, device=cuda)
    return x, w, packed, scales, ids


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,k,n", [(8, 4096, 1024), (8, 14336, 4096),
                                     (11, 1024, 301)])
def test_cuda_fused_tenant_matches_plain(cuda, dtype, bsz, k, n):
    # Row 9 (N = 301 leaves a ragged, odd last tile; 11 rows two groups).
    x, w, packed, scales, ids = _fused_inputs(cuda, dtype, bsz, 3, k, n, 12)
    before = tbg.fused_tenant_matmul.launches
    got = tbg.fused_tenant_matmul(x, w, packed, scales, ids,
                                  out_dtype=torch.float32)
    want = tbg.fused_tenant_matmul_plain(x, w, packed, scales, ids)
    torch.cuda.synchronize()
    assert tbg.fused_tenant_matmul.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    with pytest.raises(ValueError):
        tbg.fused_tenant_matmul(x, w.to(torch.float16), packed, scales, ids)


FT_KERNEL = "fused_tenant_tc_kernel"


def _ft_inputs(cuda, bsz, t, k, n, seed, ids=None, dtype=torch.bfloat16):
    x, w, packed, scales, rand_ids = _fused_inputs(cuda, dtype, bsz, t, k,
                                                   n, seed)
    return x, w, packed, scales, (rand_ids if ids is None
                                  else torch.tensor(ids, device=cuda))


def _ft_close(x, w, packed, scales, ids):
    got = tbg.fused_tenant_matmul(x, w, packed, scales, ids,
                                  out_dtype=torch.float32)
    want = tbg.fused_tenant_matmul_plain(x, w, packed, scales, ids)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    return got


# Row 9's tensor-core kernel (bf16) at every row count from one n8 tile
# to five 32-row launches; K off the 128-K stage (1056) and the Mistral-7B
# depths; N off the 128-column tile and off a 64-column box (776).
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz", [1, 8, 9, 33, 65, 130])
@pytest.mark.parametrize("k,n", [(1056, 776), (4096, 1024), (14336, 4096)])
def test_cuda_fused_tenant_any_b(cuda, bsz, k, n):
    _ft_close(*_ft_inputs(cuda, bsz, 3, k, n, seed=bsz + k + n))


# Tenant patterns: one tenant, every row its own, more distinct tenants in
# a slab than a stage holds words of (4: the slab walks its K range again
# for each further 4), 32 distinct in one slab, repeated ids, int32 and
# int64 ids.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,t,ids", [
    (8, 3, [1] * 8), (8, 8, list(range(8))), (32, 32, list(range(31, -1, -1))),
    (20, 9, None), (5, 7, [6, 0, 6, 3, 3]), (40, 2, [1] * 35 + [0] * 5)])
@pytest.mark.parametrize("k,n", [(1056, 512), (4096, 1024)])
def test_cuda_fused_tenant_tenant_patterns(cuda, bsz, t, ids, k, n):
    x, w, packed, scales, ids_t = _ft_inputs(cuda, bsz, t, k, n,
                                             seed=bsz * t + k, ids=ids)
    got = _ft_close(x, w, packed, scales, ids_t)
    got32 = _ft_close(x, w, packed, scales, ids_t.to(torch.int32))
    assert torch.equal(got, got32)


# One set sign bit, or one nonzero W element, at (kk, nn) over all-clear
# words (every sign -1) and a zero W: with integer x the sums are exact, so
# the kernel equals the plain version bit for bit, and the output moves in
# column nn alone (of the rows of that tenant whose x[kk] is nonzero, or of
# every such row). A misplaced fragment or a wrong bit moves it elsewhere.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("kk,nn", [(0, 0), (31, 127), (32, 128), (16, 15),
                                   (1055, 775), (527, 700), (1024, 640)])
def test_cuda_fused_tenant_one_hot(cuda, kk, nn):
    k, n, t = 1056, 776, 3
    g = torch.Generator(device=cuda).manual_seed(kk + nn)
    x = torch.randint(-8, 9, (8, k), generator=g, device=cuda).to(
        torch.bfloat16)
    ids = torch.tensor([0, 1, 2, 1, 0, 1, 2, 2], device=cuda)
    scales = torch.tensor([0.5, 0.25, 0.75], device=cuda)
    clear = torch.zeros((t, k // 32, n), dtype=torch.int32, device=cuda)
    one = clear.clone()
    one[1, kk // 32, nn] = -2 ** 31 if kk % 32 == 31 else 1 << (kk % 32)
    w = torch.zeros((k, n), dtype=torch.bfloat16, device=cuda)

    def run(wt, words):
        got = tbg.fused_tenant_matmul(x, wt, words, scales, ids,
                                      out_dtype=torch.float32)
        want = tbg.fused_tenant_matmul_plain(x, wt, words, scales, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        return got

    y0 = run(w, clear)
    y1 = run(w, one)
    assert (y1 != y0).nonzero().tolist() == [
        [b, nn] for b in range(8) if ids[b] == 1 and x[b, kk] != 0]
    w[kk, nn] = 1.0
    y2 = run(w, clear)
    assert (y2 != y0).nonzero().tolist() == [
        [b, nn] for b in range(8) if x[b, kk] != 0]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,k,n", [(8, 4096, 1024), (65, 14336, 4096)])
def test_cuda_fused_tenant_is_deterministic(cuda, bsz, k, n):
    # The K splits of a column tile add their partials through distributed
    # shared memory in rank order: no atomics, so repeated calls are equal.
    x, w, packed, scales, ids = _ft_inputs(cuda, bsz, 3, k, n, seed=38)
    first = tbg.fused_tenant_matmul(x, w, packed, scales, ids,
                                    out_dtype=torch.float32)
    for _ in range(3):
        again = tbg.fused_tenant_matmul(x, w, packed, scales, ids,
                                        out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


# A bf16 call launches the tensor-core kernel once a slab of 32 rows and
# nothing else (no split sum); fp32 keeps the CUDA-core kernel and its
# split sum. The launches are the library's own count (a profiler trace
# may drop records); the trace only names the kernels that ran.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz", [8, 32, 65])
def test_cuda_fused_tenant_launches_one_kernel_a_slab(cuda, bsz):
    x, w, packed, scales, ids = _ft_inputs(cuda, bsz, 3, 4096, 1024,
                                           seed=39)
    tbg.fused_tenant_matmul(x, w, packed, scales, ids,
                            out_dtype=torch.float32)
    torch.cuda.synchronize()
    before = tbg.fused_tenant_tc_launched()
    tbg.fused_tenant_matmul(x, w, packed, scales, ids,
                            out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tbg.fused_tenant_tc_launched() - before == -(-bsz // 32)
    _, events = _trace(lambda: tbg.fused_tenant_matmul(
        x, w, packed, scales, ids, out_dtype=torch.float32), want=(FT_KERNEL,))
    names = sorted(_kernel_counts(events))
    assert names and all(FT_KERNEL in nm for nm in names), names
    before = tbg.fused_tenant_tc_launched()
    _, events = _trace(lambda: tbg.fused_tenant_matmul(
        x.float(), w.float(), packed, scales, ids, out_dtype=torch.float32),
        want=("fused_tenant_kernel",))
    keys = " ".join(evt.key for evt in events)
    assert "fused_tenant_kernel" in keys and "sum_splits_kernel" in keys
    assert FT_KERNEL not in keys
    assert tbg.fused_tenant_tc_launched() == before


# A NaN in one row's x makes that row NaN, as the plain version's (and
# JAX's masked per-row sum); every other row is as without it.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,row,kk", [(8, 3, 100), (65, 64, 4095)])
def test_cuda_fused_tenant_nan_in_x(cuda, dtype, bsz, row, kk):
    x, w, packed, scales, ids = _ft_inputs(cuda, bsz, 3, 4096, 1024,
                                           seed=row, dtype=dtype)
    _nan_row(lambda xx: tbg.fused_tenant_matmul(
                 xx, w, packed, scales, ids, out_dtype=torch.float32),
             lambda xx: tbg.fused_tenant_matmul_plain(xx, w, packed, scales,
                                                      ids),
             x, row, kk, exact=False)


@pytest.mark.requires_cuda
def test_cuda_fused_tenant_refuses_what_it_does_not_take(cuda):
    x, w, packed, scales, ids = _ft_inputs(cuda, 8, 3, 1024, 512, seed=40)
    bad = [
        (x.to(torch.float16), w.to(torch.float16), packed, scales, ids),
        (x, w.float(), packed, scales, ids),
        (x, w.cpu(), packed, scales, ids),
        (x, w, packed.cpu(), scales, ids),
        (x, w, packed.to(torch.int64), scales, ids),
        (x, w, packed, scales.cpu(), ids),
        (x, w, packed, scales, ids.cpu()),
        (x, w, packed, scales, ids[:4]),
        (x, w, packed, scales, ids.to(torch.float32)),
        (x[:, :1000], w[:1000], packed[:, :31].contiguous(), scales, ids),
    ]
    before = tbg.fused_tenant_matmul.launches
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            tbg.fused_tenant_matmul(*args, out_dtype=torch.float32)
    assert tbg.fused_tenant_matmul.launches == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,k,n", [(8, 4096, 1024), (8, 14336, 4096),
                                     (9, 1040, 768)])
def test_cuda_fused_base_pair_matches_plain(cuda, dtype, bsz, k, n):
    # Row 10 (K = 1040 is a multiple of 16, not of 32: the x prep's 16-wide
    # tail; 9 rows take two n8 tiles). Any colsum works for the comparison.
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((bsz, k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda) * 0.02).to(dtype)
    pairs = torch.randint(-2**31, 2**31 - 1, (3, k // 16, n // 2),
                          generator=g, device=cuda, dtype=torch.int32)
    colsum = torch.randint(-k, k + 1, (3, n), generator=g,
                           device=cuda).to(torch.float32)
    scales = torch.rand((3,), generator=g, device=cuda) * 0.01 + 0.001
    ids = torch.randint(0, 3, (bsz,), generator=g, device=cuda)
    args = [pairs, colsum, scales, ids]
    before = tbg.fused_base_pair_matmul.launches
    got = tbg.fused_base_pair_matmul(x, w, *args, out_dtype=torch.float32)
    want = tbg.fused_base_pair_matmul_plain(x, w, *args)
    torch.cuda.synchronize()
    assert tbg.fused_base_pair_matmul.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _fused_pair_inputs(cuda, dtype, bsz, t, k, n, seed, ids=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((bsz, k), generator=g, device=cuda).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda) * 0.02).to(dtype)
    pairs = torch.randint(-2**31, 2**31 - 1, (t, k // 16, n // 2),
                          generator=g, device=cuda, dtype=torch.int32)
    colsum = torch.randint(-k, k + 1, (t, n), generator=g,
                           device=cuda).to(torch.float32)
    scales = torch.rand((t,), generator=g, device=cuda) * 0.01 + 0.001
    if ids is None:
        ids = torch.randint(0, t, (bsz,), generator=g, device=cuda)
    else:
        ids = torch.tensor(ids, device=cuda)
    return x, w, [pairs, colsum, scales, ids]


# Row 10 at every row count from one n8 tile to four 32-row launches, K
# with the 16-wide tail (1040) and the Mistral-7B depths, bf16 (the
# tensor-core kernel) and fp32 (the CUDA-core kernel): within 1e-4 of the
# output scale; over a zero W the output is the delta alone, and equals
# the plain version exactly (the integer pair sums and the epilogue).
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz", [1, 8, 9, 65, 128])
@pytest.mark.parametrize("k,n", [(1040, 768), (4096, 1024), (14336, 4096)])
def test_cuda_fused_base_pair_any_b(cuda, dtype, bsz, k, n):
    x, w, args = _fused_pair_inputs(cuda, dtype, bsz, 3, k, n,
                                    seed=bsz + k + n)
    got = tbg.fused_base_pair_matmul(x, w, *args, out_dtype=torch.float32)
    want = tbg.fused_base_pair_matmul_plain(x, w, *args)
    torch.cuda.synchronize()
    assert got.shape == (bsz, n) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    del want
    zero = torch.zeros_like(w)
    got0 = tbg.fused_base_pair_matmul(x, zero, *args,
                                      out_dtype=torch.float32)
    want0 = tbg.fused_base_pair_matmul_plain(x, zero, *args)
    torch.cuda.synchronize()
    assert torch.equal(got0, want0)


# Tenant patterns of the bf16 kernel: one tenant, every row its own, more
# distinct tenants in a slab than a stage holds words of (4: the slab
# walks its K range again for each further 4), int32 ids.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,t,ids", [
    (8, 3, [1] * 8), (8, 8, list(range(8))), (32, 32, list(range(31, -1, -1))),
    (20, 9, None), (5, 7, [6, 0, 6, 3, 3])])
@pytest.mark.parametrize("k,n", [(1040, 512), (4096, 1024)])
def test_cuda_fused_base_pair_tenant_patterns(cuda, bsz, t, ids, k, n):
    x, w, args = _fused_pair_inputs(cuda, torch.bfloat16, bsz, t, k, n,
                                    seed=bsz * t + k, ids=ids)
    zero = torch.zeros_like(w)
    for ids_t in (args[3], args[3].to(torch.int32)):
        a = [*args[:3], ids_t]
        got = tbg.fused_base_pair_matmul(x, w, *a, out_dtype=torch.float32)
        want = tbg.fused_base_pair_matmul_plain(x, w, *a)
        got0 = tbg.fused_base_pair_matmul(x, zero, *a,
                                          out_dtype=torch.float32)
        want0 = tbg.tenant_delta_matmul_pair_plain(x, *a)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() \
            <= 1e-4 * want.abs().max().item()
        assert torch.equal(got0, want0)


# One set sign bit, or one nonzero W element, at (kk, nn) over zeros: the
# output moves in column nn alone (of the rows of that tenant, or of every
# row). A misplaced fragment or a wrong column map moves it elsewhere.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("kk,nn", [(0, 0), (15, 128), (16, 255), (31, 1),
                                   (1039, 1023), (527, 700), (7, 383)])
def test_cuda_fused_base_pair_one_hot(cuda, kk, nn):
    k, n, t = 1040, 1024, 3
    g = torch.Generator(device=cuda).manual_seed(kk + nn)
    x = torch.randn((8, k), generator=g, device=cuda).to(torch.bfloat16)
    ids = torch.tensor([0, 1, 2, 1, 0, 1, 2, 2], device=cuda)
    scales = torch.tensor([0.5, 0.25, 0.75], device=cuda)
    colsum = torch.zeros((t, n), device=cuda)
    clear = torch.zeros((t, k // 16, n // 2), dtype=torch.int32, device=cuda)
    # Natural column nn is pair column (nn // 256) * 128 + nn % 128, in the
    # low (nn % 256 < 128) or high half of the word for K kk.
    one = clear.clone()
    bit = kk % 16 + 16 * ((nn % 256) // 128)
    one[1, kk // 16, (nn // 256) * 128 + nn % 128] = (
        -2 ** 31 if bit == 31 else 1 << bit)
    w = torch.zeros((k, n), dtype=torch.bfloat16, device=cuda)
    y0 = tbg.fused_base_pair_matmul(x, w, clear, colsum, scales, ids,
                                    out_dtype=torch.float32)
    y1 = tbg.fused_base_pair_matmul(x, w, one, colsum, scales, ids,
                                    out_dtype=torch.float32)
    w[kk, nn] = 1.0
    y2 = tbg.fused_base_pair_matmul(x, w, clear, colsum, scales, ids,
                                    out_dtype=torch.float32)
    want = tbg.fused_base_pair_matmul_plain(x, w, one, colsum, scales, ids)
    got = tbg.fused_base_pair_matmul(x, w, one, colsum, scales, ids,
                                     out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    moved = (y1 != y0).nonzero().tolist()
    rows = [b for b in range(8) if ids[b] == 1
            and tbg._pair_quantize(x[b:b + 1], scales, ids[b:b + 1])[0][
                0, kk] != 0]
    assert moved == [[b, nn] for b in rows]
    moved = (y2 != y0).nonzero().tolist()
    assert moved == [[b, nn] for b in range(8) if x[b, kk] != 0]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,k,n", [(8, 4096, 1024), (65, 14336, 4096)])
def test_cuda_fused_base_pair_is_deterministic(cuda, bsz, k, n):
    # The K splits of a column tile add their partials through distributed
    # shared memory in rank order: no atomics, so two calls are equal.
    x, w, args = _fused_pair_inputs(cuda, torch.bfloat16, bsz, 3, k, n, 35)
    first = tbg.fused_base_pair_matmul(x, w, *args, out_dtype=torch.float32)
    second = tbg.fused_base_pair_matmul(x, w, *args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# A bf16 call launches row 1's prep once and the tensor-core kernel once
# a slab of 32 rows, and nothing else (no plain x prep, no epilogue
# kernel); fp32 keeps the CUDA-core kernel and its epilogue.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz", [8, 65])
def test_cuda_fused_base_pair_launches_prep_and_main_only(cuda, bsz):
    x, w, args = _fused_pair_inputs(cuda, torch.bfloat16, bsz, 3, 4096,
                                    1024, 36)
    tbg.fused_base_pair_matmul(x, w, *args, out_dtype=torch.float32)
    _, events = _trace(lambda: tbg.fused_base_pair_matmul(
        x, w, *args, out_dtype=torch.float32),
        want=("pair_prep_kernel", "fused_pair_tc_kernel"))
    counts = {}
    for evt in events:
        if getattr(evt, "device_time_total",
                   getattr(evt, "cuda_time_total", 0)) > 0:
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    # A slab of up to 8, 16 or 32 rows takes its own instantiation.
    prep = sum(c for nm, c in counts.items() if "pair_prep_kernel" in nm)
    main = sum(c for nm, c in counts.items()
               if "fused_pair_tc_kernel" in nm)
    assert prep + main == sum(counts.values()), sorted(counts)
    assert prep == 1 and main == -(-bsz // 32)
    _, events = _trace(lambda: tbg.fused_base_pair_matmul(
        x.float(), w.float(), *args, out_dtype=torch.float32),
        want=("fused_pair_kernel",))
    keys = " ".join(evt.key for evt in events)
    assert "fused_pair_kernel" in keys and "fused_pair_epilogue" in keys
    assert "fused_pair_tc_kernel" not in keys


@pytest.mark.requires_cuda
def test_cuda_fused_base_pair_refuses_what_it_does_not_take(cuda):
    x, w, args = _fused_pair_inputs(cuda, torch.bfloat16, 8, 3, 1024, 512,
                                    37)
    pairs, colsum, scales, ids = args
    bad = [
        (x.to(torch.float16), w.to(torch.float16), args),
        (x, w.float(), args),
        (x, w, [pairs, colsum.to(torch.bfloat16), scales, ids]),
        (x, w, [pairs, colsum, scales, ids.to(torch.int16)]),
        (x, w, [pairs, colsum, scales.to(torch.bfloat16), ids]),
        (x, w[:, :384], [pairs[:, :, :192].contiguous(),
                         colsum[:, :384].contiguous(), scales, ids]),
        (x[:, :1000], w[:1000], [pairs[:, :63].contiguous(), colsum, scales,
                                 ids]),
    ]
    before = tbg.fused_base_pair_matmul.launches
    for xb, wb, ab in bad:
        with pytest.raises((ValueError, TypeError)):
            tbg.fused_base_pair_matmul(xb, wb, *ab, out_dtype=torch.float32)
    assert tbg.fused_base_pair_matmul.launches == before


# Row 7 past the old K limit (K < 131072 and K * 2 <= 200 KB): the K
# splits' sums added in int64. K = 102432 (the smallest K the old limit
# refused) and K = 262144, B = 1 and 8, N = 256; an all-max x puts every
# xq at 2^14, so sxq = 2^14 * K passes 2^31 at K = 262144.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz", [1, 8])
@pytest.mark.parametrize("k", [102432, 262144])
def test_cuda_tenant_delta_exact_at_large_k(cuda, bsz, k):
    g = torch.Generator(device=cuda).manual_seed(k + bsz)
    n, t = 256, 3
    packed = torch.randint(-2**31, 2**31 - 1, (t, k // 32, n), generator=g,
                           device=cuda, dtype=torch.int32)
    scales = torch.rand((t,), generator=g, device=cuda) + 0.1
    ids = torch.randint(0, t, (bsz,), generator=g, device=cuda)
    x = torch.randn((bsz, k), generator=g, device=cuda).to(torch.bfloat16)
    top = torch.full_like(x, 0.75)
    for xin in (x, top, -top):
        got = tbg.tenant_delta_matmul(xin, packed, scales, ids,
                                      out_dtype=torch.float32)
        want = tbg.tenant_delta_matmul_plain(xin, packed, scales, ids)
        torch.cuda.synchronize()
        assert got.shape == (bsz, n) and torch.equal(got, want)
    sxq = tbg._canonical_kernel_input(top)[1]
    assert sxq.dtype == torch.int64
    assert (sxq == 2 ** 14 * k).all()


CANON_KERNEL_NAMES = ("canon_prep_kernel", "canon_delta_tc_kernel")


def _canon_inputs(cuda, bsz, g, k, n, seed, ids=None, dtype=torch.bfloat16):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    packed = torch.randint(-2**31, 2**31 - 1, (g, k // 32, n), generator=gen,
                           device=cuda, dtype=torch.int32)
    scales = torch.rand((g,), generator=gen, device=cuda) + 0.1
    if ids is None:
        ids = torch.randint(0, g, (bsz,), generator=gen, device=cuda)
    else:
        ids = torch.as_tensor(ids, device=cuda)
    x = torch.randn((bsz, k), generator=gen, device=cuda).to(dtype)
    return x, packed, scales, ids


def _canon_exact(x, packed, scales, ids):
    got = tbg.tenant_delta_matmul(x, packed, scales, ids,
                                  out_dtype=torch.float32)
    want = tbg.tenant_delta_matmul_plain(x, packed, scales, ids)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


# A call launches the prep and the 1-bit MMA kernel and nothing else.
@pytest.mark.requires_cuda
def test_cuda_tenant_delta_launches_its_two_kernels_only(cuda):
    x, packed, scales, ids = _canon_inputs(cuda, 8, 2, 4096, 1024, seed=40)
    tbg.tenant_delta_matmul(x, packed, scales, ids, out_dtype=torch.float32)
    _, events = _trace(lambda: tbg.tenant_delta_matmul(
        x, packed, scales, ids, out_dtype=torch.float32),
        want=CANON_KERNEL_NAMES)
    counts = _kernel_counts(events)
    assert len(counts) == 2, sorted(counts)
    keys = " ".join(counts)
    assert all(name in keys for name in CANON_KERNEL_NAMES), keys


# More rows than one main-kernel launch takes (64): Mixtral at 65 slots
# (130 routed rows over 16 (tenant, expert) matrices, and its attention's
# 130 rows over 2 tenants) and Mistral at 65 slots. Exact, the prep once
# and the main kernel once a slab.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,g,k,n", [(65, 3, 4096, 4096),
                                       (130, 16, 4096, 14336),
                                       (130, 16, 14336, 4096),
                                       (130, 2, 4096, 1024)])
def test_cuda_tenant_delta_exact_past_one_launch(cuda, bsz, g, k, n):
    ids = [b % g for b in range(bsz)] if g < 16 else None
    x, packed, scales, ids = _canon_inputs(cuda, bsz, g, k, n, seed=bsz + g,
                                           ids=ids)
    want = tbg.tenant_delta_matmul_plain(x, packed, scales, ids)
    got, events = _trace(lambda: tbg.tenant_delta_matmul(
        x, packed, scales, ids, out_dtype=torch.float32),
        want=CANON_KERNEL_NAMES)
    assert torch.equal(got, want)
    counts = {}
    for evt in events:
        for name in CANON_KERNEL_NAMES:
            if name in evt.key:
                counts[name] = counts.get(name, 0) + evt.count
    assert counts == {"canon_prep_kernel": 1,
                      "canon_delta_tc_kernel": -(-bsz // 64)}


# One id for every row (a unit of all the rows: groups of 8 or 4), every
# id distinct (units of one row), and mixes; int32 and int64 ids; B = 3
# and 4 take the 4-row blocks.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,g,ids", [
    (8, 4, [2] * 8), (16, 16, list(range(16))), (3, 5, [4, 0, 4]),
    (4, 6, [5, 5, 1, 5]), (20, 2, [1] * 17 + [0] * 3),
    (11, 12, [0, 2, 2, 5, 7, 0, 9, 11, 2, 5, 10])])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_cuda_tenant_delta_id_patterns(cuda, bsz, g, ids, ids_dtype):
    x, packed, scales, ids = _canon_inputs(
        cuda, bsz, g, 4096, 1024, seed=bsz * g,
        ids=torch.tensor(ids, dtype=ids_dtype))
    assert ids.dtype == ids_dtype
    _canon_exact(x, packed, scales, ids)


# Every x dtype the wrapper takes, read through any strides (a column
# slice and a transposed view), and the N the 16-byte copies cannot take
# (N = 201, 7) beside N = 200 and 8.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [200, 8, 201, 7])
def test_cuda_tenant_delta_dtypes_and_any_n(cuda, dtype, n):
    x, packed, scales, ids = _canon_inputs(cuda, 9, 4, 1024, n, seed=n,
                                           dtype=dtype)
    _canon_exact(x, packed, scales, ids)
    wide = torch.randn((9, 2048), device=cuda).to(dtype)
    _canon_exact(wide[:, 512:1536], packed, scales, ids)
    _canon_exact(wide.t().contiguous().t()[:, :1024], packed, scales, ids)


# One sign bit set alone (every other word zero), and one x at +-max with
# every other x zero: a single column and a single K of the sums.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("kk,nn", [(0, 0), (31, 127), (32, 128), (255, 5),
                                   (4095, 1023), (2015, 600)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cuda_tenant_delta_one_hot(cuda, kk, nn, sign):
    x, packed, scales, ids = _canon_inputs(cuda, 8, 2, 4096, 1024, seed=kk,
                                           ids=[0, 1] * 4)
    one = torch.zeros_like(packed)
    bit = 1 << (kk % 32)
    one[1, kk // 32, nn] = bit - 2 ** 32 if bit >= 2 ** 31 else bit
    _canon_exact(x, one, scales, ids)
    hot = torch.zeros_like(x)
    hot[3, kk] = sign * 2.5
    _canon_exact(hot, packed, scales, ids)
    _canon_exact(hot, one, scales, ids)


# A NaN in x makes the global grid NaN, so every output is NaN: the
# plain version's max over |x| keeps it, as JAX's does. Row 3's NaN is in
# a prep warp's register-cached items, row 129's past them.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz,row,kk", [(8, 3, 100), (130, 129, 4095)])
def test_cuda_tenant_delta_nan_in_x(cuda, dtype, bsz, row, kk):
    x, packed, scales, ids = _canon_inputs(cuda, bsz, 4, 4096, 1024,
                                           seed=row, dtype=dtype)
    x[row, kk] = float("nan")
    got = tbg.tenant_delta_matmul(x, packed, scales, ids,
                                  out_dtype=torch.float32)
    want = tbg.tenant_delta_matmul_plain(x, packed, scales, ids)
    torch.cuda.synchronize()
    assert want.isnan().all()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bsz,g,k,n", [(8, 2, 4096, 1024),
                                       (16, 16, 14336, 4096),
                                       (130, 16, 4096, 1000)])
def test_cuda_tenant_delta_is_deterministic(cuda, bsz, g, k, n):
    x, packed, scales, ids = _canon_inputs(cuda, bsz, g, k, n, seed=k)
    first = tbg.tenant_delta_matmul(x, packed, scales, ids,
                                    out_dtype=torch.float32)
    for _ in range(3):
        again = tbg.tenant_delta_matmul(x, packed, scales, ids,
                                        out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.requires_cuda
def test_cuda_tenant_delta_refuses_what_it_does_not_take(cuda):
    x, packed, scales, ids = _canon_inputs(cuda, 8, 3, 1024, 512, seed=41)
    bad = [
        (x, packed.cpu(), scales, ids),
        (x, packed, scales.cpu(), ids),
        (x, packed, scales, ids.cpu()),
        (x, packed.to(torch.int64), scales, ids),
        (x, packed[:, :, ::2], scales, ids),
        (x, packed, scales.to(torch.bfloat16), ids),
        (x, packed, scales, ids.to(torch.int16)),
        (x, packed, scales, ids[:4]),
        (x[:, :1000], packed[:, :31].contiguous(), scales, ids),
        (x.to(torch.int32), packed, scales, ids),
    ]
    before = tbg.tenant_delta_matmul.launches
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            tbg.tenant_delta_matmul(*args, out_dtype=torch.float32)
    assert tbg.tenant_delta_matmul.launches == before


# Row 4 on the tensor cores (bf16) and its fp32 CUDA-core branch: query
# lengths off the 64-row tile, Sk > Sq, a row of length 0, a row shorter
# than Sq, one past Sq, and a window narrower than a key tile.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq", [8, 24, 136, 512])
def test_cuda_flash_prefill_tiles_match_plain(cuda, sq, dtype, hd, window):
    g = torch.Generator(device=cuda).manual_seed(16)
    sk = sq + 40
    q = torch.randn((4, sq, 8, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((4, sk, 2, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn_like(k)
    lengths = torch.tensor([sq, 0, sq // 2 + 3, sk], device=cuda)
    before = tfp.flash_prefill_attention.launches
    got = tfp.flash_prefill_attention(q, k, v, lengths, window=window)
    want = tfp.flash_prefill_attention_plain(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert tfp.flash_prefill_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (4, sq, 8 * hd)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    for row, n in enumerate(lengths.tolist()):
        assert not got[row, n:].any(), "padding query rows must be zeros"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("window", [None, 40])
def test_cuda_flash_prefill_one_hot_values_land_in_their_columns(cuda,
                                                                 window):
    # V's row for key j is the unit vector of column j % hd, so each output
    # column sums the probabilities of its own keys: a P fragment paired
    # with the wrong keys moves mass to another column. Held per (row,
    # head) to 2^-7 of its largest value: P and the output are rounded to
    # bf16 once each (about 2^-9).
    g = torch.Generator(device=cuda).manual_seed(17)
    sq, hd = 136, 128
    q = torch.randn((2, sq, 8, hd), generator=g, device=cuda).to(
        torch.bfloat16)
    k = torch.randn((2, sq, 2, hd), generator=g, device=cuda).to(
        torch.bfloat16)
    eye = torch.eye(hd, device=cuda)[torch.arange(sq, device=cuda) % hd]
    v = eye[None, :, None, :].expand(2, sq, 2, hd).to(torch.bfloat16)
    lengths = torch.tensor([sq, 100], device=cuda)
    got = tfp.flash_prefill_attention(q, k, v, lengths, window=window)
    want = tfp.flash_prefill_attention_plain(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert _grad_close(got, want, hd)
    assert not got[1, 100:].any()


def _decode_cache(cuda, kind, bsz, s, hd, seed):
    """q and a (B, S, 8, hd) cache for row 2: ``kind`` is the q dtype and
    the cache's (``"int8"`` with either q dtype)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qdt = torch.float32 if kind.endswith("fp32") else torch.bfloat16
    q = torch.randn((bsz, 32, hd), generator=g, device=cuda).to(qdt)
    k = torch.randn((bsz, s, 8, hd), generator=g, device=cuda)
    v = torch.randn_like(k)
    if kind.startswith("int8"):
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return q, k, v, dict(k_scale=ks, v_scale=vs)
    return q, k.to(qdt), v.to(qdt), {}


# Row 2: lengths around the 64-key split (0, 1, 63 ... 129), a full
# 2048-key row, and S + 1 (a full cache's step); caches of 2048 and 8192
# slots; bf16, fp32 and int8 (with bf16 or fp32 q) caches.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("s", [2048, 8192])
@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8_bf16", "int8_fp32"])
def test_cuda_flash_decode_split_plan_matches_plain(cuda, kind, s, window):
    lens = [0, 1, 63, 64, 65, 127, 128, 129, 2048, s + 1]
    q, k, v, scales = _decode_cache(cuda, kind, len(lens), s, 128, 18)
    lengths = torch.tensor(lens, device=cuda)
    before = tfd.flash_decode_attention.launches
    got = tfd.flash_decode_attention(q, k, v, lengths, window=window,
                                     **scales)
    want = tfd.flash_decode_attention_plain(q, k, v, lengths, window=window,
                                            **scales)
    torch.cuda.synchronize()
    assert tfd.flash_decode_attention.launches == before + 1
    assert got.dtype == q.dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[
        q.dtype]
    assert not got[0].any(), "a row with no live key gives zeros"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["bf16", "int8_bf16"])
def test_cuda_flash_decode_head_dim_64_matches_plain(cuda, kind):
    q, k, v, scales = _decode_cache(cuda, kind, 4, 512, 64, 19)
    lengths = torch.tensor([512, 65, 1, 300], device=cuda)
    got = tfd.flash_decode_attention(q, k, v, lengths, **scales)
    want = tfd.flash_decode_attention_plain(q, k, v, lengths, **scales)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[
        q.dtype]


# ---------------------------------------------------------------------------
# The entry points on the card: a tiny checkpoint pair through the CLIs
# ---------------------------------------------------------------------------

def _tiny_checkpoints(root):
    """A tiny llama base and fine-tune (base + seeded noise) written as HF
    checkpoints by the port's own exporter (head_dim 64: flash prefill
    takes 64 or 128)."""
    from bitdelta_torch.core.export import save_full_model
    from bitdelta_torch.models import llama as tl
    from bitdelta_torch.models.config import tiny_test_config

    cfg = tiny_test_config(vocab_size=256, hidden_size=128,
                           intermediate_size=256, num_layers=2, num_heads=2,
                           num_kv_heads=1)
    g = torch.Generator().manual_seed(7)
    base = tl.init_params(cfg, g, torch.float32, scale=0.05, device="cpu")
    fine = dict(base, layers={
        n: w + 0.01 * torch.randn(w.shape, generator=g)
        if n in tl.PROJ_NAMES else w for n, w in base["layers"].items()})
    save_full_model(cfg, base, str(root / "base"))
    save_full_model(cfg, fine, str(root / "fine"))
    return cfg, str(root / "base"), str(root / "fine")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_load_hf_params_matches_the_cpu(cuda, tmp_path, dtype):
    from bitdelta_torch.models.hf_import import load_hf_params

    _, base, _ = _tiny_checkpoints(tmp_path)
    _, got = load_hf_params(base, dtype=dtype)
    _, want = load_hf_params(base, dtype=dtype, device="cpu")
    assert got["embed"].is_cuda
    for name, w in want["layers"].items():
        assert torch.equal(got["layers"][name].cpu(), w), name
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(got[name].cpu(), want[name]), name


def _tiny_gptq(root, group):
    """A tiny symmetric AutoGPTQ checkpoint (every zero point 8, contiguous
    groups of ``group`` rows) from seeded draws."""
    import json

    from bitdelta_torch.core.artifact import write_safetensors

    hidden, inter, kv = 256, 512, 128
    dims = {"self_attn.q_proj": (hidden, hidden),
            "self_attn.k_proj": (hidden, kv),
            "self_attn.v_proj": (hidden, kv),
            "self_attn.o_proj": (hidden, hidden),
            "mlp.gate_proj": (hidden, inter), "mlp.up_proj": (hidden, inter),
            "mlp.down_proj": (inter, hidden)}
    root.mkdir()
    (root / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": 128, "hidden_size": hidden,
        "intermediate_size": inter, "num_hidden_layers": 1,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 64, "tie_word_embeddings": False}))
    g = torch.Generator().manual_seed(group)
    f16 = lambda *shape: (0.05 * torch.randn(shape, generator=g)).half()
    t = {"model.embed_tokens.weight": f16(128, hidden),
         "model.norm.weight": 1 + f16(hidden),
         "lm_head.weight": f16(128, hidden),
         "model.layers.0.input_layernorm.weight": 1 + f16(hidden),
         "model.layers.0.post_attention_layernorm.weight": 1 + f16(hidden)}
    for sub, (k, n) in dims.items():
        pre = f"model.layers.0.{sub}"
        t[f"{pre}.qweight"] = torch.randint(-2**31, 2**31 - 1, (k // 8, n),
                                            generator=g, dtype=torch.int32)
        t[f"{pre}.qzeros"] = torch.full((k // group, n // 8), 0x77777777,
                                        dtype=torch.int32)
        t[f"{pre}.scales"] = f16(k // group, n).abs() + 0.01
        t[f"{pre}.g_idx"] = torch.arange(k, dtype=torch.int32) // group
    write_safetensors(str(root / "model.safetensors"), t, {"format": "pt"})
    return str(root)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("group", [32, 64, 128])
def test_cuda_load_gptq_params_keeps_words_only_at_group_128(cuda, tmp_path,
                                                            group):
    """On the card a symmetric projection stays an ``Int4Weight`` only at
    the W4 kernel's 128-row groups; at 32 or 64 it loads as the dense
    dequantized stack (equal to ``native=False``), with a warning."""
    import warnings

    from bitdelta_torch.models.quant_import import load_gptq_params
    from bitdelta_torch.research.quantized_base import Int4Weight

    path = _tiny_gptq(tmp_path / "gptq", group)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, got = load_gptq_params(path, dtype=torch.float32)
    _, dense = load_gptq_params(path, dtype=torch.float32, native=False)
    projs = {n: w for n, w in got["layers"].items() if n.endswith("_proj")}
    if group == 128:
        assert not rec
        assert all(isinstance(w, Int4Weight) for w in projs.values())
    else:
        assert any("128-row groups" in str(r.message) for r in rec)
        for name, w in projs.items():
            assert isinstance(w, torch.Tensor) and w.is_cuda, name
            assert torch.equal(w, dense["layers"][name]), name


@pytest.mark.requires_cuda
def test_cuda_cli_pipeline_tiny(cuda, tmp_path, capsys, monkeypatch):
    """train -> serve --smoke_test -> eval_ppl on the card (the default
    device): the training kernels (rows 4, 5, 6) and the serving kernels
    (rows 1, 2, 3, 4, 5) launch; the untrained artifact's words equal
    the CPU run's, its scales within 1e-6 (summed in another order).
    ``transformers`` is blocked, so every CLI takes the byte tokenizer
    whatever the machine has installed (a checkpoint directory without
    tokenizer files is not a tokenizer)."""
    import json
    import os
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)

    from bitdelta_torch.cli.eval_ppl import main as eval_main
    from bitdelta_torch.cli.serve import main as serve_main
    from bitdelta_torch.cli.train import main as train_main
    from bitdelta_torch.core.artifact import read_safetensors
    from bitdelta_torch.ops import flash_decode as tfd2

    _, base, fine = _tiny_checkpoints(tmp_path)
    common = ["--base_model", base, "--finetuned_model", fine,
              "--num_steps", "2", "--batch_size", "2", "--max_length", "16",
              "--dataset_name", "synthetic"]
    counters = {"binary_matmul": tbg.binary_matmul,
                "binary_matmul_t": tbg.binary_matmul_t,
                "flash_prefill": tfp.flash_prefill_attention,
                "pair": tbg.tenant_delta_matmul_pair,
                "decode": tfd2.flash_decode_attention,
                "dense": tbg.tenant_dense_matmul}
    before = {k: f.launches for k, f in counters.items()}
    train_main(common + ["--save_dir", str(tmp_path / "card")])
    moved = {k: f.launches - before[k] for k, f in counters.items()}
    assert moved["binary_matmul"] and moved["binary_matmul_t"]
    assert moved["flash_prefill"]
    train_main(common + ["--save_dir", str(tmp_path / "cpu"), "--device",
                         "cpu"])
    got, _ = read_safetensors(str(tmp_path / "card" /
                                  "diff_untrained.safetensors"))
    want, _ = read_safetensors(str(tmp_path / "cpu" /
                                   "diff_untrained.safetensors"))
    for key, w in want.items():
        if key.endswith(".scale"):
            np_close = abs(got[key] - w).max() <= 1e-6 * abs(w).max()
            assert np_close, key
        else:
            assert (got[key] == w).all(), key

    diff = str(tmp_path / "card" / "diff.safetensors")
    capsys.readouterr()
    before = {k: f.launches for k, f in counters.items()}
    serve_main(["--base_model", base, "--delta", f"a={diff}", "--delta",
                f"b={tmp_path / 'card' / 'diff_untrained.safetensors'}",
                "--max_seq", "64", "--smoke_test"])
    out = capsys.readouterr().out
    assert "[smoke ok]" in out
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    assert sorted(line["tenant"] for line in lines if line["done"]) == [
        "a", "b"]
    moved = {k: f.launches - before[k] for k, f in counters.items()}
    for k in ("pair", "decode", "dense", "flash_prefill", "binary_matmul"):
        assert moved[k], k

    corpus = tmp_path / "corpus.txt"
    corpus.write_text("pack my box with five dozen liquor jugs. " * 40)
    ppl = eval_main(["--base_model", base, "--model_diff", diff,
                     "--text_file", str(corpus), "--context_size", "64",
                     "--window_size", "32", "--save_dir", str(tmp_path)])
    assert ppl > 1.0 and ppl == float(open(os.path.join(
        tmp_path, "ppl.txt")).read())


@pytest.mark.requires_cuda
def test_cuda_variants_match_the_cpu(cuda):
    """LoRA and the column variant on the card against the same matrix on
    the CPU (binary_median's scale and the ternary planes are held so in
    chip_smoke.py's phase 11c, on a 45 M-element gate_proj): the column
    signs exactly and its scales within 1e-6 (sums in another order);
    LoRA's ``a @ b`` within 1e-5 of its largest element on an exact
    rank-4 delta plus small noise, where the truncation is unique, and
    on a random delta (where the factors may rotate among near-equal
    singular values) its reconstruction error's norm within 1e-5
    relative."""
    from bitdelta_torch.research import variants as tv

    g = torch.Generator().manual_seed(0)
    base = torch.randn((4096, 4112), generator=g) * 0.02
    fine = base + torch.randn((4096, 4112), generator=g) * 0.002
    col = tv.quantize_column(base.to(cuda), fine.to(cuda))
    col_cpu = tv.quantize_column(base, fine)
    assert torch.equal(col.packed.cpu(), col_cpu.packed)
    assert torch.allclose(col.scale.cpu(), col_cpu.scale, rtol=1e-6, atol=0)
    small_b, small_f = base[:512, :384], fine[:512, :384]
    diff = small_f - small_b
    errs = [(tv.dequantize_lora(tv.quantize_lora(b, f, rank=16)).cpu()
             - diff).norm().item()
            for b, f in ((small_b.to(cuda), small_f.to(cuda)),
                         (small_b, small_f))]
    assert abs(errs[0] - errs[1]) <= 1e-5 * errs[1], errs
    low = (torch.randn((512, 4), generator=g)
           @ torch.randn((4, 384), generator=g)) * 0.01
    low_f = small_b + low + torch.randn((512, 384), generator=g) * 1e-5
    lora = tv.dequantize_lora(tv.quantize_lora(small_b.to(cuda),
                                               low_f.to(cuda), rank=4))
    lora_cpu = tv.dequantize_lora(tv.quantize_lora(small_b, low_f, rank=4))
    assert (lora.cpu() - lora_cpu).abs().max() <= (
        1e-5 * lora_cpu.abs().max())


# ---------------------------------------------------------------------------
# Tensor parallelism: the rows at one rank's Llama-2-70B shapes (tp = 2:
# hidden 8192, 32 query / 4 KV heads a rank, intermediate 14336 and vocab
# 16000 a rank), and a decode step split over two ranks on the card.
# ---------------------------------------------------------------------------

TP70_PROJ = {"q_proj": (8192, 4096), "k_proj": (8192, 512),
             "o_proj": (4096, 8192), "gate_proj": (8192, 14336),
             "down_proj": (14336, 8192)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("proj", sorted(TP70_PROJ))
def test_cuda_pair_rows_at_70b_tp2_local_shapes(cuda, proj):
    """Rows 1 and 10 (k/v's local N = 512 pairs) exact / within 1e-4 of
    their plain versions; rows 7 and 9 on the canonical words."""
    k, n = TP70_PROJ[proj]
    x, args = _pair_inputs(cuda, 8, 2, k, n, seed=21)
    got = tbg.tenant_delta_matmul_pair(x, *args, out_dtype=torch.float32)
    assert torch.equal(got, tbg.tenant_delta_matmul_pair_plain(x, *args))
    g = torch.Generator(device=cuda).manual_seed(22)
    w = (torch.randn((k, n), generator=g, device=cuda) * 0.02).to(x.dtype)
    got = tbg.fused_base_pair_matmul(x, w, *args, out_dtype=torch.float32)
    want = tbg.fused_base_pair_matmul_plain(x, w, *args)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    packed = torch.randint(-2**31, 2**31 - 1, (2, k // 32, n), generator=g,
                           device=cuda, dtype=torch.int32)
    scales, ids = args[2], args[3]
    got = tbg.tenant_delta_matmul(x, packed, scales, ids,
                                  out_dtype=torch.float32)
    assert torch.equal(got, tbg.tenant_delta_matmul_plain(x, packed, scales,
                                                          ids))
    got = tbg.fused_tenant_matmul(x, w, packed, scales, ids,
                                  out_dtype=torch.float32)
    want = tbg.fused_tenant_matmul_plain(x, w, packed, scales, ids)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.requires_cuda
def test_cuda_dense_head_and_binary_matmul_at_70b_tp2_local_shapes(cuda):
    """Row 3 on a rank's per-tenant head (K 8192, N 16000) and row 5 on a
    prefill of 64 tokens through o_proj's local K (4096 -> 8192)."""
    x, w, ids = _dense_inputs(cuda, 8, 2, 8192, 16000, seed=23)
    got = tbg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    _dense_close(got, tbg.tenant_dense_matmul_plain(x, w, ids))
    g = torch.Generator(device=cuda).manual_seed(24)
    xp = torch.randn((64, 4096), generator=g, device=cuda).to(torch.bfloat16)
    packed = torch.randint(-2**31, 2**31 - 1, (4096 // 32, 8192),
                           generator=g, device=cuda, dtype=torch.int32)
    scale = torch.tensor(0.01, device=cuda)
    got = tbg.binary_matmul(xp, packed, scale, out_dtype=torch.float32)
    want = tbg.binary_matmul_plain(xp, packed, scale)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_attention_at_70b_tp2_local_heads(cuda, dtype):
    """Rows 2 and 4 at a rank's 32 query heads over 4 KV heads."""
    g = torch.Generator(device=cuda).manual_seed(25)
    q = torch.randn((8, 32, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((8, 256, 4, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn_like(k)
    lengths = torch.tensor([256, 1, 100, 64, 7, 255, 128, 33], device=cuda)
    got = tfd.flash_decode_attention(q, k, v, lengths)
    want = tfd.flash_decode_attention_plain(q, k, v, lengths)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    qp = torch.randn((2, 64, 32, 128), generator=g, device=cuda).to(dtype)
    kp = torch.randn((2, 64, 4, 128), generator=g, device=cuda).to(dtype)
    vp = torch.randn_like(kp)
    lp = torch.tensor([64, 40], device=cuda)
    got = tfp.flash_prefill_attention(qp, kp, vp, lp)
    want = tfp.flash_prefill_attention_plain(qp, kp, vp, lp)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


def _tp_decode_rank(rank, store, out_dir):
    """One of two ranks on the card (gloo): a seeded fp32 world's B = 4
    prefill and decode step, whole on this rank and split over both (tp =
    2), on both kernel routes; the gathered logits go to a file."""
    import dataclasses

    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models import llama
    from bitdelta_torch.models.config import ModelConfig
    from bitdelta_torch.parallel import mesh as pmesh
    from bitdelta_torch.parallel import sharding as psh
    from bitdelta_torch.parallel.collectives import all_gather
    from bitdelta_torch.serving.stacking import stack_tenants, to_pair_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    pmesh.initialize_multihost(f"file://{store}", 2, rank)
    mesh = pmesh.make_mesh((1, 2))
    dev = torch.device("cuda")
    cfg = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_layers=2, num_heads=4, num_kv_heads=4,
                      max_seq_len=64, dtype="float32")
    local = dataclasses.replace(cfg, num_heads=2, num_kv_heads=2)
    gen = torch.Generator(device=dev).manual_seed(31)
    base = llama.init_params(cfg, gen, scale=0.1, device=dev)
    tenants = []
    for _ in range(2):
        fine = dict(base)
        fine["layers"] = {k: v + 0.02 * torch.randn(v.shape, generator=gen,
                                                    device=dev)
                          for k, v in base["layers"].items()}
        tenants.append(compress_model(base, fine))
    stack = stack_tenants(cfg, base, tenants, device=dev)
    tokens = torch.randint(1, 512, (4, 16), generator=gen, device=dev)
    lengths = torch.tensor([16, 9, 12, 5], dtype=torch.int32, device=dev)
    nxt = torch.randint(1, 512, (4, 1), generator=gen, device=dev)
    tids = torch.tensor([0, 1, 1, 0], device=dev)
    out = {}
    for kernel in llama.CARD_KERNELS:
        for tp, group in ((1, None), (2, mesh)):
            st = to_pair_layout(stack, tp=tp)
            if group is not None:
                st = psh.shard_stack(cfg, st, group)
            kw = dict(deltas=st.deltas, tenant_ids=tids, kernel=kernel,
                      tp_group=group)
            c = cfg if group is None else local
            with torch.no_grad():
                _, cache = llama.forward(c, st.params, tokens,
                                         lengths=lengths, return_cache=True,
                                         cache_max_seq=32, **kw)
                step, _ = llama.decode_step(c, st.params, nxt, cache, **kw)
            out[f"{kernel}_{tp}"] = all_gather(step[:, 0], group, "model",
                                               -1).cpu()
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.mark.requires_cuda
def test_cuda_tp2_decode_step_matches_one_rank(cuda, tmp_path):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tp_decode_rank,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs)
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for kernel in ("cuda", "cuda_fused"):
        one, two = outs[0][f"{kernel}_1"], outs[0][f"{kernel}_2"]
        # fp32, but rows 1 and 10 put x on a 12-bit grid a row, and a
        # rank's o_proj / down_proj grid spans its K shard only, so their
        # delta terms round differently (3.5e-4 of the scale here, the
        # same on the CPU's plain versions, against 8e-7 on the plain
        # route): 1e-3 of the scale.
        assert (one - two).abs().max().item() <= 1e-3 * one.abs().max().item()
        assert torch.equal(outs[1][f"{kernel}_2"], two)
