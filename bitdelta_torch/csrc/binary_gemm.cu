// Hand-written Hopper kernels for the 1-bit delta GEMMs of the serving
// path (plain C interface, loaded with ctypes by ops/binary_gemm.py).
//
//   bd_pair_delta      <- bitdelta_tpu/ops/pallas_binary_gemm.py
//                         ::tenant_delta_matmul_pair_pallas
//   bd_tenant_dense    <- ::tenant_dense_matmul_pallas
//   bd_binary_matmul   <- ::binary_matmul_pallas
//
// Every entry launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

extern "C" const char* bd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// 1. Pair-packed tenant delta at decode:
//    Y[b, n] = scale[ids[b]] * (x[b] @ sign(P[ids[b]]))[n]
//
// Bound on the H100: the packed words of the rows' tenants (1 bit per
// weight) against 3.35 TB/s. x arrives already quantized (plain torch,
// as JAX runs it in XLA) to a non-negative 12-bit grid, so the kernel
// keeps the TPU kernel's integer formulation and agrees with the plain
// version to fp32 rounding of the epilogue only:
//   * one thread per pair-word column j and row b; KS thread rows split
//     the K/16 words of that column and reduce through shared memory;
//   * row b's xq (K values, uint16) sits in shared memory and is read as
//     a warp-wide broadcast; the pair words are read coalesced along j;
//   * each word: 16 shift/and/multiply-adds on 0x00010001 masks add two
//     columns at once. Each half sums at most 16 * 4095 < 2^16, so the
//     halves never carry into each other and split exactly with an
//     unsigned shift; the integer sums are exact for any K here;
//   * epilogue y = 2*a1*S + (a2*colsum - a1*sxq) written in natural
//     column order (low half -> g*256 + r, high half -> g*256 + 128 + r),
//     with explicit round-to-nearest ops so no FMA contraction separates
//     it from the plain version.
// ---------------------------------------------------------------------------

constexpr int PAIR_TX = 64;   // pair-word columns per block
constexpr int PAIR_KS = 4;    // thread rows splitting the K words

__global__ void pair_delta_kernel(const int* __restrict__ xq,
                                  const uint32_t* __restrict__ pairs,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ a1,
                                  const float* __restrict__ a2,
                                  const float* __restrict__ sxq,
                                  const float* __restrict__ colsum,
                                  float* __restrict__ out,
                                  int k16, int n2) {
  extern __shared__ unsigned short xs[];          // K = 16 * k16 values
  __shared__ int red_lo[PAIR_KS][PAIR_TX];
  __shared__ int red_hi[PAIR_KS][PAIR_TX];

  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * PAIR_TX + tx;
  const int k = k16 * 16;
  const int n = n2 * 2;

  for (int i = ty * PAIR_TX + tx; i < k; i += PAIR_TX * PAIR_KS)
    xs[i] = static_cast<unsigned short>(xq[(size_t)b * k + i]);
  __syncthreads();

  const int t = ids[b];
  const uint32_t* p = pairs + (size_t)t * k16 * n2;
  int acc_lo = 0, acc_hi = 0;
  if (j < n2) {
    for (int kw = ty; kw < k16; kw += PAIR_KS) {
      const uint32_t w = p[(size_t)kw * n2 + j];
      const unsigned short* xk = xs + kw * 16;
      uint32_t inner = 0;
#pragma unroll
      for (int s = 0; s < 16; ++s)
        inner += ((w >> s) & 0x00010001u) * static_cast<uint32_t>(xk[s]);
      acc_lo += static_cast<int>(inner & 0xFFFFu);
      acc_hi += static_cast<int>(inner >> 16);
    }
  }
  red_lo[ty][tx] = acc_lo;
  red_hi[ty][tx] = acc_hi;
  __syncthreads();
  if (ty != 0 || j >= n2) return;
  int s_lo = 0, s_hi = 0;
#pragma unroll
  for (int i = 0; i < PAIR_KS; ++i) {
    s_lo += red_lo[i][tx];
    s_hi += red_hi[i][tx];
  }
  const int g = j / 128, r = j % 128;
  const int n_lo = g * 256 + r, n_hi = n_lo + 128;
  const float c1 = a1[b], c2 = a2[b];
  const float two_a1 = __fmul_rn(2.0f, c1);
  const float off = __fmul_rn(c1, sxq[b]);
  const float* cs = colsum + (size_t)t * n;
  out[(size_t)b * n + n_lo] = __fadd_rn(
      __fmul_rn(two_a1, static_cast<float>(s_lo)),
      __fsub_rn(__fmul_rn(c2, cs[n_lo]), off));
  out[(size_t)b * n + n_hi] = __fadd_rn(
      __fmul_rn(two_a1, static_cast<float>(s_hi)),
      __fsub_rn(__fmul_rn(c2, cs[n_hi]), off));
}

extern "C" int bd_pair_delta(const void* xq, const void* pairs,
                             const void* ids, const void* a1, const void* a2,
                             const void* sxq, const void* colsum, void* out,
                             int bsz, int k16, int n2, void* stream) {
  dim3 grid((n2 + PAIR_TX - 1) / PAIR_TX, bsz);
  dim3 block(PAIR_TX, PAIR_KS);
  size_t smem = (size_t)k16 * 16 * sizeof(unsigned short);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pair_delta_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  pair_delta_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)xq, (const uint32_t*)pairs, (const int*)ids,
      (const float*)a1, (const float*)a2, (const float*)sxq,
      (const float*)colsum, (float*)out, k16, n2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. Tenant-routed dense matmul (the per-tenant lm_head at decode):
//    Y[b] = x[b] @ W[ids[b]]
//
// Bound: the bytes of the distinct tenants' (K, N) slabs. Each block owns
// 256 columns (two adjacent per thread, one 4- or 8-byte load), up to
// DENSE_ROWS rows and one of `splits` contiguous K ranges; it walks each
// DISTINCT tenant among its rows once, so a tenant's slab is read once
// however many rows route to it, and no (B, K, N) gather exists. x tiles
// sit in shared memory as fp32; each weight pair feeds the rows of that
// tenant (fp32, sequential over the block's K range). Splitting K gives
// the card enough blocks to keep its memory busy (a 32000-column head
// has only 125 column blocks); the partial sums go to a scratch
// (splits, B, N) and a second kernel adds them in split order, so the
// result does not depend on scheduling.
// ---------------------------------------------------------------------------

constexpr int DENSE_THREADS = 128;
constexpr int DENSE_ROWS = 16;
constexpr int DENSE_TK = 128;

template <typename T>
__global__ void tenant_dense_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const int* __restrict__ ids,
                                    float* __restrict__ partial,
                                    int bsz, int k, int n, int k_per_split) {
  __shared__ float xs[DENSE_ROWS][DENSE_TK];
  __shared__ int tid_of[DENSE_ROWS];

  const int row0 = blockIdx.y * DENSE_ROWS;
  const int rows = min(DENSE_ROWS, bsz - row0);
  const int split = blockIdx.z;
  const int k_lo = split * k_per_split;
  const int k_hi = min(k, k_lo + k_per_split);
  const int c0 = blockIdx.x * (2 * DENSE_THREADS) + 2 * threadIdx.x;
  if (threadIdx.x < DENSE_ROWS)
    tid_of[threadIdx.x] = threadIdx.x < rows ? ids[row0 + threadIdx.x] : -1;
  __syncthreads();

  float acc0[DENSE_ROWS], acc1[DENSE_ROWS];
#pragma unroll
  for (int r = 0; r < DENSE_ROWS; ++r) acc0[r] = acc1[r] = 0.0f;

  const bool vec = (n % 2 == 0) && (c0 + 1 < n);
  for (int u = 0; u < rows; ++u) {
    const int t = tid_of[u];
    bool seen = false;
    for (int v = 0; v < u; ++v) seen |= (tid_of[v] == t);
    if (seen) continue;                         // uniform across the block
    const T* wt = w + (size_t)t * k * n;
    for (int k0 = k_lo; k0 < k_hi; k0 += DENSE_TK) {
      const int tk = min(DENSE_TK, k_hi - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < DENSE_ROWS * DENSE_TK;
           i += DENSE_THREADS) {
        const int r = i / DENSE_TK, kk = i % DENSE_TK;
        xs[r][kk] = (r < rows && kk < tk)
                        ? to_f32(x[(size_t)(row0 + r) * k + k0 + kk]) : 0.0f;
      }
      __syncthreads();
      if (c0 >= n) continue;
#pragma unroll 4
      for (int kk = 0; kk < tk; ++kk) {
        const T* wrow = wt + (size_t)(k0 + kk) * n + c0;
        float w0, w1 = 0.0f;
        if (vec) {
          if constexpr (sizeof(T) == 2) {
            const __nv_bfloat162 pr =
                *reinterpret_cast<const __nv_bfloat162*>(wrow);
            w0 = __low2float(pr);
            w1 = __high2float(pr);
          } else {
            const float2 pr = *reinterpret_cast<const float2*>(wrow);
            w0 = pr.x;
            w1 = pr.y;
          }
        } else {
          w0 = to_f32(wrow[0]);
          if (c0 + 1 < n) w1 = to_f32(wrow[1]);
        }
#pragma unroll
        for (int r = 0; r < DENSE_ROWS; ++r) {
          if (tid_of[r] == t) {
            acc0[r] = fmaf(xs[r][kk], w0, acc0[r]);
            acc1[r] = fmaf(xs[r][kk], w1, acc1[r]);
          }
        }
      }
    }
  }
  if (c0 >= n) return;
  float* out = partial + (size_t)split * bsz * n;
  for (int r = 0; r < rows; ++r) {
    out[(size_t)(row0 + r) * n + c0] = acc0[r];
    if (c0 + 1 < n) out[(size_t)(row0 + r) * n + c0 + 1] = acc1[r];
  }
}

// out[i] = sum over splits s (in order) of partial[s][i].
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits,
                                  int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * count + i];
  out[i] = acc;
}

extern "C" int bd_tenant_dense(const void* x, const void* w, const void* ids,
                               void* partial, void* out, int bsz, int k,
                               int n, int splits, int is_bf16, void* stream) {
  const int k_per_split = (k + splits - 1) / splits;
  dim3 grid((n + 2 * DENSE_THREADS - 1) / (2 * DENSE_THREADS),
            (bsz + DENSE_ROWS - 1) / DENSE_ROWS, splits);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    tenant_dense_kernel<__nv_bfloat16><<<grid, DENSE_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)ids,
        (float*)partial, bsz, k, n, k_per_split);
  else
    tenant_dense_kernel<float><<<grid, DENSE_THREADS, 0, s>>>(
        (const float*)x, (const float*)w, (const int*)ids, (float*)partial,
        bsz, k, n, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int count = bsz * n;
  sum_splits_kernel<<<(count + 255) / 256, 256, 0, s>>>(
      (const float*)partial, (float*)out, splits, count);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 5. Binary matmul with canonical packing (single-request prefill delta):
//    Y = scale * (x @ sign(P)),  x (M, K), P (K/32, N) int32 LSB-first.
//
// Bound at prefill shapes: operations (2*M*K*N against the bf16 tensor
// rate; the ±1 operand is exact in bf16) rather than bytes (x + K/32*N
// words). This first version runs on the CUDA cores: a 64x64 output tile
// per block, 4x4 outputs per thread, one packed word per column per
// 32-deep K step. x tiles are staged in shared memory as fp32; each word
// is unpacked in registers LSB-first along K, and the sign is applied by
// flipping x's sign bit (bit 1 -> +x, bit 0 -> -x) before an fp32 add, so
// the sum is the exact ±1 product accumulated in fp32, sequential in K.
// ---------------------------------------------------------------------------

constexpr int BM_TILE = 64, BN_TILE = 64;

template <typename T>
__global__ void binary_matmul_kernel(const T* __restrict__ x,
                                     const uint32_t* __restrict__ packed,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out,
                                     int m, int k, int n) {
  __shared__ float xs[32][BM_TILE + 1];
  __shared__ uint32_t ws[BN_TILE];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM_TILE, n0 = blockIdx.x * BN_TILE;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += 32) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM_TILE * 32; i += 256) {
      const int r = i / 32, kk = i % 32;
      xs[kk][r] = (m0 + r < m) ? to_f32(x[(size_t)(m0 + r) * k + k0 + kk])
                               : 0.0f;
    }
    if (threadIdx.x < BN_TILE)
      ws[threadIdx.x] = (n0 + threadIdx.x < n)
                            ? packed[(size_t)(k0 / 32) * n + n0 + threadIdx.x]
                            : 0u;
    __syncthreads();
    uint32_t neg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) neg[j] = ~ws[tx + 16 * j];
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sgn = ((neg[j] >> kk) & 1u) << 31;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][j] += __uint_as_float(__float_as_uint(xv[i]) ^ sgn);
      }
    }
  }
  const float sc = scale[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[(size_t)row * n + col] = acc[i][j] * sc;
    }
  }
}

extern "C" int bd_binary_matmul(const void* x, const void* packed,
                                const void* scale, void* out, int m, int k,
                                int n, int is_bf16, void* stream) {
  dim3 grid((n + BN_TILE - 1) / BN_TILE, (m + BM_TILE - 1) / BM_TILE);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    binary_matmul_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)x, (const uint32_t*)packed,
        (const float*)scale, (float*)out, m, k, n);
  else
    binary_matmul_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)x, (const uint32_t*)packed, (const float*)scale,
        (float*)out, m, k, n);
  return (int)cudaGetLastError();
}
