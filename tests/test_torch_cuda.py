"""PyTorch port, on the card: each hand-written CUDA kernel against its
plain PyTorch version (which tests/test_torch_kernels.py holds against
the JAX package on the CPU).

Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the pair kernel repeats the plain version's integer sums and
fp32 epilogue op for op (4 ulp of the cancelling epilogue terms); the fp32 kernels
sum in another order (1e-4 of the output scale); the attention kernels
return bf16 (2e-2 absolute, about two bf16 ulps at these magnitudes) or
fp32 (1e-4 absolute, sums in another order)."""

import pytest
import torch

from bitdelta_torch.core.delta import BinaryDelta, pair_delta
from bitdelta_torch.ops import binary_gemm as tbg
from bitdelta_torch.ops import flash_decode as tfd
from bitdelta_torch.ops import flash_prefill as tfp

# Output tolerance of the attention kernels per working dtype.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


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
    xf = x.float()
    term = 1.1 * (xf.amax(1) - xf.amin(1)).max().item() * 1024
    assert (got - want).abs().max().item() <= 4 * torch.finfo(
        torch.float32).eps * term


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_binary_matmul_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((130, 1024), generator=g, device=cuda).to(dtype)
    packed = torch.randint(-2**31, 2**31 - 1, (32, 200), generator=g,
                           device=cuda, dtype=torch.int32)
    scale = torch.tensor(0.37, device=cuda)
    got = tbg.binary_matmul(x, packed, scale, out_dtype=torch.float32)
    want = tbg.binary_matmul_plain(x, packed, scale)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 100])
def test_cuda_flash_decode_matches_plain(cuda, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((4, 32, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((4, 512, 8, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn_like(k)
    lengths = torch.tensor([512, 1, 300, 77], device=cuda)
    got = tfd.flash_decode_attention(q, k, v, lengths, window=window)
    want = tfd.flash_decode_attention_plain(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 50])
def test_cuda_flash_prefill_matches_plain(cuda, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((2, 128, 32, 128), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 192, 8, 128), generator=g, device=cuda).to(dtype)
    v = torch.randn_like(k)
    lengths = torch.tensor([128, 70], device=cuda)
    got = tfp.flash_prefill_attention(q, k, v, lengths, window=window)
    want = tfp.flash_prefill_attention_plain(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    assert not got[1, 70:].any()
