// Hand-written Hopper kernels for the 1-bit delta GEMMs of the serving
// and training paths (plain C interface, loaded with ctypes by
// ops/binary_gemm.py).
//
//   bd_pair_delta      <- bitdelta_tpu/ops/pallas_binary_gemm.py
//                         ::tenant_delta_matmul_pair_pallas
//   bd_tenant_dense    <- ::tenant_dense_matmul_pallas
//   bd_binary_matmul   <- ::binary_matmul_pallas
//   bd_binary_matmul_t <- ::binary_matmul_t_pallas
//   bd_tenant_delta    <- ::tenant_delta_matmul_pallas
//   bd_fused_tenant    <- ::fused_tenant_matmul_pallas
//   bd_fused_base_pair <- ::fused_base_pair_matmul_pallas
//
// Every entry launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

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
// 5 and 6. Binary matmul with canonical packing, and its transpose, on the
//    tensor cores; one GEMM core with two layouts of the ±1 operand:
//    row 5 (bd_binary_matmul <- binary_matmul_pallas: the single-request
//      prefill delta and the trainable matmul's forward):
//        Y = scale * (x @ sign(P)),    x (M, K), Y (M, N);
//    row 6 (bd_binary_matmul_t <- binary_matmul_t_pallas: the trainable
//      matmul's activation gradient in scale distillation):
//        Y = scale * (g @ sign(P)^T),  g (M, N), Y (M, 32 * K32);
//    P (K/32, N) int32, LSB-first along K; bit 1 -> +1, bit 0 -> -1.
//
// Bound on the H100 at the prefill and training shapes (M = 500-512):
// operations, 2*M*K*N against the bf16 tensor rate (±1 is exact in bf16).
// The work is some 1,400 operations a byte moved, five times the bf16
// ridge, so only the tensor cores can approach the bound. Design:
//   * mma.sync m16n8k16, bf16 x bf16 -> fp32 sums: a block owns a 128x128
//     output tile, 8 warps of 64x32 (4x4 mma tiles, 64 fp32 sums a
//     thread), and walks the reduction in steps of BG_BK = 64;
//   * a ring of STAGES shared-memory stages filled by cp.async (16-byte
//     copies of the x / g tile, 4-byte copies of the packed words, both
//     zero-filled past a ragged edge), so the loads of step s + STAGES - 1
//     overlap the math of step s; one __syncthreads a step;
//   * the ±1 operand never touches device memory: every thread expands
//     one packed word of the NEXT step into 32 bf16 values in a double-
//     buffered shared tile (the word's clear bits unzipped once, even bits
//     to the low half and odd to the high, then one shift and one logic op
//     per pair of values: 0x3F80 with the sign bit set where the bit is 0)
//     while the current step's mma run;
//   * one expansion, two layouts: row 5's word P[kw, n] is 32 consecutive
//     reduction values of column n, stored as row n of a [BN][BK] tile and
//     read with ldmatrix; row 6's word is 32 consecutive output columns at
//     one reduction index, stored in a row of a [BK][BN] tile and read
//     with ldmatrix.trans. The 16-byte chunks of every tile are XOR-
//     swizzled by row, so cp.async stores, expansion stores and ldmatrix
//     reads hit distinct banks;
//   * fp32 inputs stay exact, without TF32: the wrapper splits x (g) into
//     three bf16 pieces whose fp32 sum is x, and the kernel adds the three
//     pieces' products with the same ±1 tile into one fp32 sum. The
//     tensor cores truncate toward zero as they accumulate, a bias that
//     grows through the scale gradients of distillation, so fp32 input
//     sums each step from zero and adds it to the total with a round-to-
//     nearest add;
//   * the scale is read on the device and applied once, with a round-to-
//     nearest product, in the epilogue. Where the output tiles alone leave
//     SMs idle (k/v: 32 tiles at M = 512) the reduction is split over
//     blocks; their fp32 partial tiles are added in split order and scaled
//     by a second kernel (no atomics).
// mma.sync rather than wgmma: its register fragments have one fixed
// layout, while a wgmma operand needs a shared-memory descriptor that no
// compiler could check before the card; wgmma is the next step.
// ---------------------------------------------------------------------------

constexpr int BG_BM = 128, BG_BN = 128, BG_BK = 64;
constexpr int BG_THREADS = 256;    // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Even bits of x to the low half, odd bits to the high half, in order.
__device__ __forceinline__ uint32_t unzip_bits(uint32_t x) {
  uint32_t t;
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
  return x;
}

// Word w's 32 signs as bf16 ±1 in four 16-byte chunks (chunk j holds bits
// 8j..8j+7, the lower bit of each pair in the lower half), stored at
// chunks (c0 + j) ^ swz of one tile row.
__device__ __forceinline__ void expand_word(uint32_t w, uint4* row, int c0,
                                            int swz) {
  const uint32_t e = unzip_bits(~w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 4 * j + q;                // bits 2p and 2p + 1
      v[q] = ((e << (15 - p)) & 0x80008000u) | 0x3F803F80u;
    }
    row[(c0 + j) ^ swz] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The GEMM core of rows 5 and 6. a: PIECES bf16 pieces (M, lda) of the
// input, piece_stride apart, zero past column `red`; packed (k32, nw)
// words; out (M, n_out) fp32, or with `partial` this block's split of the
// reduction, unscaled, at partial[blockIdx.z].
template <bool TRANS, int PIECES, int STAGES>
__device__ __forceinline__ void binary_gemm_tc(
    const __nv_bfloat16* __restrict__ a, size_t piece_stride,
    const uint32_t* __restrict__ packed, const float* __restrict__ scale,
    float* __restrict__ out, float* __restrict__ partial, int m, int red,
    int lda, int n_out, int k32, int nw, int red_per_split) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* ws = reinterpret_cast<uint32_t*>(
      as + STAGES * PIECES * BG_BM * BG_BK);
  __nv_bfloat16* bx = reinterpret_cast<__nv_bfloat16*>(
      ws + STAGES * BG_THREADS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * BG_BM, n0 = blockIdx.x * BG_BN;
  const int k_lo = blockIdx.z * red_per_split;
  const int k_hi = min(red, k_lo + red_per_split);
  const int steps = k_hi > k_lo ? (k_hi - k_lo + BG_BK - 1) / BG_BK : 0;

  // Step s's input tile (every piece) and its packed words into stage
  // s % STAGES. Row 5's words: 2 word rows x 128 columns; row 6's: 4 word
  // rows (128 output columns) x 64 reduction indices. Only the last split
  // has a partial step, and its edge is the operand's own.
  auto load = [&](int s) {
    const int k0 = k_lo + s * BG_BK;
    __nv_bfloat16* dst = as + (s % STAGES) * PIECES * BG_BM * BG_BK;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
#pragma unroll
      for (int i = 0; i < BG_BM * BG_BK / 8 / BG_THREADS; ++i) {
        const int c = tid + i * BG_THREADS;
        const int r = c >> 3, ch = c & 7;
        const int gm = m0 + r, gk = k0 + ch * 8;
        const bool ok = gm < m && gk < lda;
        const __nv_bfloat16* src =
            ok ? a + p * piece_stride + (size_t)gm * lda + gk : a;
        cp_async16(dst + p * BG_BM * BG_BK + r * BG_BK + ((ch ^ (r & 7)) << 3),
                   src, ok);
      }
    }
    int wr, wc;
    bool ok;
    if constexpr (TRANS) {
      wr = n0 / 32 + (tid >> 6);
      wc = k0 + (tid & 63);
      ok = wr < k32 && wc < red;
    } else {
      wr = k0 / 32 + (tid >> 7);
      wc = n0 + (tid & 127);
      ok = wr < k32 && wc < nw;
    }
    cp_async4(ws + (s % STAGES) * BG_THREADS + tid,
              ok ? packed + (size_t)wr * nw + wc : packed, ok);
  };

  // Step s's words as the ±1 tile bx[s & 1]: row 5 [BN][BK], row 6
  // [BK][BN]; one word a thread.
  auto expand = [&](int s) {
    const uint32_t w = ws[(s % STAGES) * BG_THREADS + tid];
    uint4* tile = reinterpret_cast<uint4*>(bx + (s & 1) * BG_BN * BG_BK);
    if constexpr (TRANS) {
      const int r = tid & 63;                   // reduction index
      expand_word(w, tile + r * (BG_BN / 8), (tid >> 6) * 4, r & 7);
    } else {
      const int n = tid & 127;                  // output column
      expand_word(w, tile + n * (BG_BK / 8), (tid >> 7) * 4, n & 7);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // fp32 input (PIECES > 1) sums each step into `part` from zero and adds
  // it to `acc` with one round-to-nearest add, so the tensor cores'
  // truncation acts on a step's sum, not the whole reduction's.
  float part[4][4][4];
  auto compute = [&](int s) {
    const __nv_bfloat16* a_st = as + (s % STAGES) * PIECES * BG_BM * BG_BK;
    const __nv_bfloat16* b_st = bx + (s & 1) * BG_BN * BG_BK;
    const int q = lane >> 3, i8 = lane & 7;
    if constexpr (PIECES > 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < BG_BK / 16; ++kk) {
      // B fragments of the warp's four 8-column tiles, two per ldmatrix:
      // matrices (tile 2jp, k 0-7), (2jp, k 8-15), (2jp+1, ...), ...
      uint32_t bf[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        if constexpr (TRANS) {
          const int k = kk * 16 + (q & 1) * 8 + i8;
          const int ch = warp_n * 4 + jp * 2 + (q >> 1);
          ldsm_x4<true>(r, b_st + k * BG_BN + ((ch ^ i8) << 3));
        } else {
          const int n = warp_n * 32 + (jp * 2 + (q >> 1)) * 8 + i8;
          const int ch = kk * 2 + (q & 1);
          ldsm_x4<false>(r, b_st + n * BG_BK + ((ch ^ i8) << 3));
        }
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int p = 0; p < PIECES; ++p) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t af[4];
          const int r = warp_m * 64 + i * 16 + (lane & 15);
          const int ch = kk * 2 + (lane >> 4);
          ldsm_x4<false>(af, a_st + p * BG_BM * BG_BK + r * BG_BK +
                                 ((ch ^ (r & 7)) << 3));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_16816(PIECES > 1 ? part[i][j] : acc[i][j], af, bf[j][0],
                      bf[j][1]);
        }
      }
    }
    if constexpr (PIECES > 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
    }
  };

  // Pipeline: stages 0 .. STAGES-2 in flight, step 0 expanded; then each
  // step waits for the NEXT step's data (so its words can be expanded),
  // refills the stage freed by the previous step, expands, and computes.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (steps > 0) expand(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (s + STAGES - 1 < steps) load(s + STAGES - 1);
    cp_async_commit();
    if (s + 1 < steps) expand(s + 1);
    compute(s);
  }
  cp_async_wait<0>();

  // Epilogue: accumulator (i, j) holds rows lane/4 (+8) and columns
  // 2*(lane%4) (+1) of its 16x8 tile.
  const float sc = scale[0];
  float* dst = partial ? partial + (size_t)blockIdx.z * m * n_out : out;
  const bool pair_store = (n_out % 2) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * 64 + i * 16 + (lane >> 2) + h * 8;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + warp_n * 32 + j * 8 + (lane & 3) * 2;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (!partial) {
          v0 = __fmul_rn(v0, sc);
          v1 = __fmul_rn(v1, sc);
        }
        float* o = dst + (size_t)row * n_out + col;
        if (col + 1 < n_out && pair_store) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < n_out) o[0] = v0;
          if (col + 1 < n_out) o[1] = v1;
        }
      }
    }
  }
}

template <int PIECES, int STAGES>
__global__ void __launch_bounds__(BG_THREADS, PIECES == 1 ? 2 : 1)
binary_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                     size_t piece_stride,
                     const uint32_t* __restrict__ packed,
                     const float* __restrict__ scale,
                     float* __restrict__ out, float* __restrict__ partial,
                     int m, int red, int lda, int n_out, int k32, int nw,
                     int red_per_split) {
  binary_gemm_tc<false, PIECES, STAGES>(a, piece_stride, packed, scale, out,
                                        partial, m, red, lda, n_out, k32, nw,
                                        red_per_split);
}

template <int PIECES, int STAGES>
__global__ void __launch_bounds__(BG_THREADS, PIECES == 1 ? 2 : 1)
binary_matmul_t_kernel(const __nv_bfloat16* __restrict__ a,
                       size_t piece_stride,
                       const uint32_t* __restrict__ packed,
                       const float* __restrict__ scale,
                       float* __restrict__ out, float* __restrict__ partial,
                       int m, int red, int lda, int n_out, int k32, int nw,
                       int red_per_split) {
  binary_gemm_tc<true, PIECES, STAGES>(a, piece_stride, packed, scale, out,
                                       partial, m, red, lda, n_out, k32, nw,
                                       red_per_split);
}

// out[i] = scale * (sum over splits s, in order, of partial[s][i]).
__global__ void binary_splits_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, int splits,
                                     size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * count + i];
  out[i] = __fmul_rn(acc, scale[0]);
}

template <bool TRANS, int PIECES, int STAGES>
static int launch_binary(const void* a, const void* packed,
                         const void* scale, void* out, void* partial, int m,
                         int red, int lda, int n_out, int k32, int nw,
                         int splits, int red_per_split, cudaStream_t s) {
  auto kernel = TRANS ? binary_matmul_t_kernel<PIECES, STAGES>
                      : binary_matmul_kernel<PIECES, STAGES>;
  const size_t smem = sizeof(__nv_bfloat16) *
                          ((size_t)STAGES * PIECES * BG_BM * BG_BK +
                           2 * BG_BN * BG_BK) +
                      sizeof(uint32_t) * STAGES * BG_THREADS;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part = splits > 1 ? (float*)partial : nullptr;
  dim3 grid((n_out + BG_BN - 1) / BG_BN, (m + BG_BM - 1) / BG_BM, splits);
  kernel<<<grid, BG_THREADS, smem, s>>>(
      (const __nv_bfloat16*)a, (size_t)m * lda, (const uint32_t*)packed,
      (const float*)scale, (float*)out, part, m, red, lda, n_out, k32, nw,
      red_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  const size_t count = (size_t)m * n_out;
  binary_splits_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      part, (const float*)scale, (float*)out, splits, count);
  return (int)cudaGetLastError();
}

// bf16 input: one piece, 4 stages (100 KB of shared memory, two blocks an
// SM); fp32 input: its three bf16 pieces, 3 stages (179 KB, one block).
template <bool TRANS>
static int dispatch_binary(const void* a, const void* packed,
                           const void* scale, void* out, void* partial,
                           int m, int red, int lda, int n_out, int k32,
                           int nw, int pieces, int splits, int red_per_split,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (pieces == 1)
    return launch_binary<TRANS, 1, 4>(a, packed, scale, out, partial, m, red,
                                      lda, n_out, k32, nw, splits,
                                      red_per_split, s);
  if (pieces == 3)
    return launch_binary<TRANS, 3, 3>(a, packed, scale, out, partial, m, red,
                                      lda, n_out, k32, nw, splits,
                                      red_per_split, s);
  return (int)cudaErrorInvalidValue;
}

// x: `pieces` bf16 pieces (M, lda), lda >= K a multiple of 8, zero past K;
// partial: (splits, M, N) fp32 scratch when splits > 1.
extern "C" int bd_binary_matmul(const void* x, const void* packed,
                                const void* scale, void* out, void* partial,
                                int m, int k, int n, int lda, int pieces,
                                int splits, int k_per_split, void* stream) {
  return dispatch_binary<false>(x, packed, scale, out, partial, m, k, lda, n,
                                k / 32, n, pieces, splits, k_per_split,
                                stream);
}

// g: `pieces` bf16 pieces (M, lda), lda >= N a multiple of 8, zero past N;
// partial: (splits, M, 32*K32) fp32 scratch when splits > 1.
extern "C" int bd_binary_matmul_t(const void* g, const void* packed,
                                  const void* scale, void* out,
                                  void* partial, int m, int k32, int n,
                                  int lda, int pieces, int splits,
                                  int n_per_split, void* stream) {
  return dispatch_binary<true>(g, packed, scale, out, partial, m, n, lda,
                               32 * k32, k32, n, pieces, splits, n_per_split,
                               stream);
}

// ---------------------------------------------------------------------------
// 7. Canonical-layout tenant delta at decode:
//    Y[b, n] = scale[ids[b]] * (2 * sum_k bit[k, n] * xq[b, k] - sum_k xq[b, k])
//              * xscale,
//    P[ids[b]] (K/32, N) int32 LSB-first along K, xq the 14-bit symmetric
//    grid of the whole (B, K) input (one xscale), quantized in plain torch
//    by the wrapper as JAX quantizes it in XLA.
//
// Rows are routed to different (tenant, expert) matrices, so each row
// streams its own matrix's words; no row reads another row's words. Bound
// on the H100: at 8-16 decode rows each word has one use, so the integer
// operations (32 shift/and/multiply-adds a word), not the words' bytes,
// bound this first version. Design:
//   * one block per (64-column tile, row); CT_KS thread rows split the
//     K/32 words of each column and reduce through shared memory;
//   * the row's xq (|xq| <= 2^14, int16: K = 14336 takes 28 KB) sits in
//     shared memory and is read as a broadcast, eight values per 16-byte
//     load; the words are read coalesced along N;
//   * the sum of bit * xq is exact in int32 (|sum| <= K * 2^14 < 2^31 for
//     K < 131072, asserted by the wrapper); the epilogue forms
//     2 * S - sum(xq) in int64, converts once and applies the tenant scale
//     and xscale with explicit round-to-nearest products, so it agrees with
//     the plain version bit for bit.
// ---------------------------------------------------------------------------

constexpr int CT_TX = 64;    // columns per block
constexpr int CT_KS = 4;     // thread rows splitting the K words

__device__ __forceinline__ int lo16(uint32_t v) {
  return static_cast<int>(static_cast<short>(v & 0xFFFFu));
}
__device__ __forceinline__ int hi16(uint32_t v) {
  return static_cast<int>(v) >> 16;
}

__global__ void tenant_delta_kernel(const short* __restrict__ xq,
                                    const uint32_t* __restrict__ packed,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ scales,
                                    const float* __restrict__ xscale,
                                    const int* __restrict__ sxq,
                                    float* __restrict__ out,
                                    int k32, int n) {
  extern __shared__ uint4 xs4[];                 // K int16 values
  __shared__ int red[CT_KS][CT_TX];

  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * CT_TX + tx;
  const int tid = ty * CT_TX + tx;

  // K is a multiple of 32, so the row is a whole number of uint4s.
  const uint4* src = reinterpret_cast<const uint4*>(xq + (size_t)b * k32 * 32);
  for (int i = tid; i < k32 * 4; i += CT_TX * CT_KS) xs4[i] = src[i];
  __syncthreads();

  const uint32_t* p = packed + (size_t)ids[b] * k32 * n;
  int acc = 0;
  if (j < n) {
    for (int kw = ty; kw < k32; kw += CT_KS) {
      const uint32_t w = p[(size_t)kw * n + j];
      const uint4* xk = xs4 + kw * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = xk[q];
        const uint32_t parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int s = q * 8 + h * 2;
          acc += static_cast<int>((w >> s) & 1u) * lo16(parts[h]);
          acc += static_cast<int>((w >> (s + 1)) & 1u) * hi16(parts[h]);
        }
      }
    }
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty != 0 || j >= n) return;
  int s = 0;
#pragma unroll
  for (int i = 0; i < CT_KS; ++i) s += red[i][tx];
  const long long d = 2LL * s - static_cast<long long>(sxq[b]);
  const float alpha = scales[ids[b]];
  out[(size_t)b * n + j] =
      __fmul_rn(__fmul_rn(alpha, __ll2float_rn(d)), xscale[0]);
}

extern "C" int bd_tenant_delta(const void* xq, const void* packed,
                               const void* ids, const void* scales,
                               const void* xscale, const void* sxq, void* out,
                               int bsz, int k32, int n, void* stream) {
  dim3 grid((n + CT_TX - 1) / CT_TX, bsz);
  dim3 block(CT_TX, CT_KS);
  size_t smem = (size_t)k32 * 32 * sizeof(short);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(tenant_delta_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  tenant_delta_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const short*)xq, (const uint32_t*)packed, (const int*)ids,
      (const float*)scales, (const float*)xscale, (const int*)sxq,
      (float*)out, k32, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 9 and 10. Fused base + tenant delta at decode (one kernel each):
//    Y[b] = x[b] @ W + scale[ids[b]] * (x[b] @ sign(P[ids[b]]))
//
// Row 9 (bd_fused_tenant) takes the canonical layout P (T, K/32, N) and
// adds the delta as ±x in fp32 for each bit, as the TPU kernel's float
// dot with ±1 does (no x grid). Row 10 (bd_fused_base_pair) takes the
// pair layout (T, K/16, N/2) and x quantized by the wrapper to row 1's
// per-row 12-bit grid; the delta is row 1's exact integer pair sums and
// its fp32 epilogue. The base product x @ W is computed in the kernel's
// own body in both, fp32 sums of the products of x and W in their dtype
// (bf16 products are exact in fp32).
//
// Bound on the H100: at decode (B = 8 rows) each W element has B uses,
// so the bytes are the K*N*2 of the bf16 base plus the words of the
// distinct tenants (1/16 of the base each), against 3.35 TB/s; the work
// is about 2*B*K*N multiply-adds for the base and as many again for the
// delta, which on CUDA cores (this first version; no tensor cores) is of
// the same order as the bytes' time. Design, for both:
//   * W is read ONCE for all the rows: one block per 256-column tile (two
//     adjacent columns a thread, 128 threads along N, so each warp's W
//     loads are contiguous) and per group of up to FUSED_ROWS rows; the
//     block keeps every row's sums in registers and, for each W element
//     it loads, does one fused multiply-add per row;
//   * x (and row 10's xq) of all the block's rows is staged in shared
//     memory in K chunks of FUSED_TK (a whole row set does not fit: 8 rows
//     of K = 14336 in bf16 are 229 KB) and read as a broadcast;
//   * each row adds its delta from its own tenant's words (a row's word
//     load for a tenant another row already read hits the L1);
//   * K is split across blocks so that k_proj / v_proj (N = 1024: 4 column
//     tiles) still give the 132 SMs enough blocks; every split writes its
//     partial sums to a scratch buffer and a second kernel adds the splits
//     in order, so the result does not depend on scheduling (no atomics).
// Row 10's pair word at column g*128 + r covers natural columns
// g*256 + r and g*256 + 128 + r: the thread that owns pair columns j, j+1
// reads W at those natural columns (neighbouring threads read neighbouring
// columns: coalesced) and writes its sums in natural column order. Its
// splits keep the base in fp32 and the pair sums in int32, so the second
// pass forms row 1's epilogue from the exact whole-K integer sums.
// ---------------------------------------------------------------------------

constexpr int FUSED_THREADS = 128;   // threads along N, two columns each
constexpr int FUSED_ROWS = 8;        // batch rows per block
constexpr int FUSED_TK = 128;        // K per shared-memory chunk

// Two adjacent elements of W as they are loaded (bf16x2 or float2), so a
// word's whole column of W can be in flight before any of it is used.
template <typename T> struct Two;
template <> struct Two<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Two<float> { using type = float2; };

// One 4- or 8-byte load where ``vec`` (N even, so the pair is aligned),
// else two scalar loads, the second only where ``has1``.
template <typename T>
__device__ __forceinline__ typename Two<T>::type load_two(const T* p,
                                                          bool vec,
                                                          bool has1) {
  if (vec) return *reinterpret_cast<const typename Two<T>::type*>(p);
  typename Two<T>::type v;
  v.x = p[0];
  v.y = has1 ? p[1] : T(0.0f);
  return v;
}

// The sign of bit ``s`` of ~word, moved to bit 31: XOR it into x to get
// +x for a set bit and -x for a clear one.
__device__ __forceinline__ uint32_t sign_bit(uint32_t neg, int s) {
  return (neg << (31 - s)) & 0x80000000u;
}

template <typename T>
__global__ void fused_tenant_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const uint32_t* __restrict__ packed,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ scales,
                                    float* __restrict__ partial,
                                    int bsz, int k, int n, int k_per_split) {
  __shared__ float xs[FUSED_ROWS][FUSED_TK];
  __shared__ int tid_of[FUSED_ROWS];

  const int row0 = blockIdx.y * FUSED_ROWS;
  const int rows = min(FUSED_ROWS, bsz - row0);
  const int split = blockIdx.z;
  const int k_lo = split * k_per_split;
  const int k_hi = min(k, k_lo + k_per_split);
  const int k32 = k / 32;
  const int c0 = blockIdx.x * (2 * FUSED_THREADS) + 2 * threadIdx.x;
  const bool has0 = c0 < n, has1 = c0 + 1 < n;
  const bool vec = (n % 2) == 0;
  // Rows past the batch read tenant 0's words against x = 0.
  if (threadIdx.x < FUSED_ROWS)
    tid_of[threadIdx.x] = threadIdx.x < rows ? ids[row0 + threadIdx.x] : 0;
  __syncthreads();

  float b0[FUSED_ROWS], b1[FUSED_ROWS], d0[FUSED_ROWS], d1[FUSED_ROWS];
#pragma unroll
  for (int r = 0; r < FUSED_ROWS; ++r) b0[r] = b1[r] = d0[r] = d1[r] = 0.0f;

  // k_lo and every chunk are whole words (k_per_split and FUSED_TK are
  // multiples of 32).
  for (int k0 = k_lo; k0 < k_hi; k0 += FUSED_TK) {
    const int tk = min(FUSED_TK, k_hi - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < FUSED_ROWS * FUSED_TK; i += FUSED_THREADS) {
      const int r = i / FUSED_TK, kk = i % FUSED_TK;
      xs[r][kk] = (r < rows && kk < tk)
                      ? to_f32(x[(size_t)(row0 + r) * k + k0 + kk]) : 0.0f;
    }
    __syncthreads();
    if (!has0) continue;
    for (int q = 0; q < tk / 32; ++q) {
      const int kw = k0 / 32 + q;
      uint32_t neg0[FUSED_ROWS], neg1[FUSED_ROWS];
#pragma unroll
      for (int r = 0; r < FUSED_ROWS; ++r) {
        const uint32_t* pw = packed + ((size_t)tid_of[r] * k32 + kw) * n + c0;
        uint32_t lo, hi = 0u;
        if (vec) {
          const uint2 v = *reinterpret_cast<const uint2*>(pw);
          lo = v.x;
          hi = v.y;
        } else {
          lo = pw[0];
          if (has1) hi = pw[1];
        }
        neg0[r] = ~lo;
        neg1[r] = ~hi;
      }
      // Every W load of the word is issued before any is used, so the 32
      // loads wait on memory together.
      const T* wq = w + (size_t)(k0 + q * 32) * n + c0;
      typename Two<T>::type wv[32];
#pragma unroll
      for (int s = 0; s < 32; ++s) wv[s] = load_two(wq + (size_t)s * n, vec, has1);
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const float w0 = to_f32(wv[s].x), w1 = to_f32(wv[s].y);
#pragma unroll
        for (int r = 0; r < FUSED_ROWS; ++r) {
          const float xv = xs[r][q * 32 + s];
          const uint32_t xb = __float_as_uint(xv);
          b0[r] = fmaf(xv, w0, b0[r]);
          b1[r] = fmaf(xv, w1, b1[r]);
          d0[r] += __uint_as_float(xb ^ sign_bit(neg0[r], s));
          d1[r] += __uint_as_float(xb ^ sign_bit(neg1[r], s));
        }
      }
    }
  }
  if (!has0) return;
  float* out = partial + (size_t)split * bsz * n;
  for (int r = 0; r < rows; ++r) {
    const float alpha = scales[tid_of[r]];
    out[(size_t)(row0 + r) * n + c0] = b0[r] + alpha * d0[r];
    if (has1) out[(size_t)(row0 + r) * n + c0 + 1] = b1[r] + alpha * d1[r];
  }
}

// K per split: ceil(k / splits) rounded up to whole 32-row words.
static int fused_k_per_split(int k, int splits) {
  return (((k + splits - 1) / splits) + 31) / 32 * 32;
}

extern "C" int bd_fused_tenant(const void* x, const void* w,
                               const void* packed, const void* ids,
                               const void* scales, void* partial, void* out,
                               int bsz, int k, int n, int splits, int is_bf16,
                               void* stream) {
  const int k_per_split = fused_k_per_split(k, splits);
  dim3 grid((n + 2 * FUSED_THREADS - 1) / (2 * FUSED_THREADS),
            (bsz + FUSED_ROWS - 1) / FUSED_ROWS, splits);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    fused_tenant_kernel<__nv_bfloat16><<<grid, FUSED_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (const uint32_t*)packed, (const int*)ids, (const float*)scales,
        (float*)partial, bsz, k, n, k_per_split);
  else
    fused_tenant_kernel<float><<<grid, FUSED_THREADS, 0, s>>>(
        (const float*)x, (const float*)w, (const uint32_t*)packed,
        (const int*)ids, (const float*)scales, (float*)partial, bsz, k, n,
        k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int count = bsz * n;
  sum_splits_kernel<<<(count + 255) / 256, 256, 0, s>>>(
      (const float*)partial, (float*)out, splits, count);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void fused_pair_kernel(const T* __restrict__ x,
                                  const int* __restrict__ xq,
                                  const T* __restrict__ w,
                                  const uint32_t* __restrict__ pairs,
                                  const int* __restrict__ ids,
                                  float* __restrict__ part_base,
                                  int* __restrict__ part_s,
                                  int bsz, int k, int n2, int k_per_split) {
  __shared__ float xs[FUSED_ROWS][FUSED_TK];
  __shared__ unsigned short xqs[FUSED_ROWS][FUSED_TK];
  __shared__ int tid_of[FUSED_ROWS];

  const int n = n2 * 2;
  const int k16 = k / 16;
  const int row0 = blockIdx.y * FUSED_ROWS;
  const int rows = min(FUSED_ROWS, bsz - row0);
  const int split = blockIdx.z;
  const int k_lo = split * k_per_split;
  const int k_hi = min(k, k_lo + k_per_split);
  // Pair columns j, j + 1 (one 128-column group: j is even); natural
  // columns n_lo, n_lo + 1 (low halves) and n_lo + 128, n_lo + 129.
  const int j = blockIdx.x * (2 * FUSED_THREADS) + 2 * threadIdx.x;
  const bool has = j < n2;                  // n2 is a multiple of 128
  const int n_lo = (j / 128) * 256 + j % 128;
  const int n_hi = n_lo + 128;
  if (threadIdx.x < FUSED_ROWS)
    tid_of[threadIdx.x] = threadIdx.x < rows ? ids[row0 + threadIdx.x] : 0;
  __syncthreads();

  float bl0[FUSED_ROWS], bl1[FUSED_ROWS], bh0[FUSED_ROWS], bh1[FUSED_ROWS];
  int sl0[FUSED_ROWS], sl1[FUSED_ROWS], sh0[FUSED_ROWS], sh1[FUSED_ROWS];
#pragma unroll
  for (int r = 0; r < FUSED_ROWS; ++r) {
    bl0[r] = bl1[r] = bh0[r] = bh1[r] = 0.0f;
    sl0[r] = sl1[r] = sh0[r] = sh1[r] = 0;
  }

  // k_lo and every chunk are whole 16-row words.
  for (int k0 = k_lo; k0 < k_hi; k0 += FUSED_TK) {
    const int tk = min(FUSED_TK, k_hi - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < FUSED_ROWS * FUSED_TK; i += FUSED_THREADS) {
      const int r = i / FUSED_TK, kk = i % FUSED_TK;
      const bool in = r < rows && kk < tk;
      const size_t at = (size_t)(row0 + r) * k + k0 + kk;
      xs[r][kk] = in ? to_f32(x[at]) : 0.0f;
      xqs[r][kk] = in ? static_cast<unsigned short>(xq[at]) : 0;
    }
    __syncthreads();
    if (!has) continue;
    for (int q = 0; q < tk / 16; ++q) {
      const int kw = k0 / 16 + q;
      uint32_t p0[FUSED_ROWS], p1[FUSED_ROWS];
#pragma unroll
      for (int r = 0; r < FUSED_ROWS; ++r) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            pairs + ((size_t)tid_of[r] * k16 + kw) * n2 + j);
        p0[r] = v.x;
        p1[r] = v.y;
      }
      uint32_t in0[FUSED_ROWS], in1[FUSED_ROWS];
#pragma unroll
      for (int r = 0; r < FUSED_ROWS; ++r) in0[r] = in1[r] = 0u;
      // Every W load of the word is issued before any is used.
      const T* wq = w + (size_t)(k0 + q * 16) * n;
      typename Two<T>::type wl[16], wh[16];
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        wl[s] = load_two(wq + (size_t)s * n + n_lo, true, true);
        wh[s] = load_two(wq + (size_t)s * n + n_hi, true, true);
      }
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const float wl0 = to_f32(wl[s].x), wl1 = to_f32(wl[s].y);
        const float wh0 = to_f32(wh[s].x), wh1 = to_f32(wh[s].y);
#pragma unroll
        for (int r = 0; r < FUSED_ROWS; ++r) {
          const float xv = xs[r][q * 16 + s];
          const uint32_t xqv = xqs[r][q * 16 + s];
          bl0[r] = fmaf(xv, wl0, bl0[r]);
          bl1[r] = fmaf(xv, wl1, bl1[r]);
          bh0[r] = fmaf(xv, wh0, bh0[r]);
          bh1[r] = fmaf(xv, wh1, bh1[r]);
          in0[r] += ((p0[r] >> s) & 0x00010001u) * xqv;
          in1[r] += ((p1[r] >> s) & 0x00010001u) * xqv;
        }
      }
      // Each half summed at most 16 * 4095 < 2^16: no carry between them.
#pragma unroll
      for (int r = 0; r < FUSED_ROWS; ++r) {
        sl0[r] += static_cast<int>(in0[r] & 0xFFFFu);
        sh0[r] += static_cast<int>(in0[r] >> 16);
        sl1[r] += static_cast<int>(in1[r] & 0xFFFFu);
        sh1[r] += static_cast<int>(in1[r] >> 16);
      }
    }
  }
  if (!has) return;
  const size_t base = (size_t)split * bsz * n;
  for (int r = 0; r < rows; ++r) {
    const size_t at = base + (size_t)(row0 + r) * n;
    part_base[at + n_lo] = bl0[r];
    part_base[at + n_lo + 1] = bl1[r];
    part_base[at + n_hi] = bh0[r];
    part_base[at + n_hi + 1] = bh1[r];
    part_s[at + n_lo] = sl0[r];
    part_s[at + n_lo + 1] = sl1[r];
    part_s[at + n_hi] = sh0[r];
    part_s[at + n_hi + 1] = sh1[r];
  }
}

// Second pass of row 10, one thread per (row, natural column): the base
// splits added in order, the integer sums added exactly, then row 1's
// epilogue 2*a1*S + (a2*colsum - a1*sxq) with explicit round-to-nearest
// operations, and one add of the base.
__global__ void fused_pair_epilogue_kernel(const float* __restrict__ part_base,
                                           const int* __restrict__ part_s,
                                           const int* __restrict__ ids,
                                           const float* __restrict__ a1,
                                           const float* __restrict__ a2,
                                           const float* __restrict__ sxq,
                                           const float* __restrict__ colsum,
                                           float* __restrict__ out,
                                           int n, int splits, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int b = i / n, c = i % n;
  float base = 0.0f;
  int s = 0;
  for (int sp = 0; sp < splits; ++sp) {
    base += part_base[(size_t)sp * count + i];
    s += part_s[(size_t)sp * count + i];
  }
  const float c1 = a1[b];
  const float two_a1 = __fmul_rn(2.0f, c1);
  const float off = __fmul_rn(c1, sxq[b]);
  const float delta = __fadd_rn(
      __fmul_rn(two_a1, static_cast<float>(s)),
      __fsub_rn(__fmul_rn(a2[b], colsum[(size_t)ids[b] * n + c]), off));
  out[i] = __fadd_rn(base, delta);
}

extern "C" int bd_fused_base_pair(const void* x, const void* xq,
                                  const void* w, const void* pairs,
                                  const void* ids, const void* a1,
                                  const void* a2, const void* sxq,
                                  const void* colsum, void* part_base,
                                  void* part_s, void* out, int bsz, int k,
                                  int n2, int splits, int is_bf16,
                                  void* stream) {
  // K per split in whole 16-row words.
  const int k_per_split = (((k + splits - 1) / splits) + 15) / 16 * 16;
  dim3 grid((n2 + 2 * FUSED_THREADS - 1) / (2 * FUSED_THREADS),
            (bsz + FUSED_ROWS - 1) / FUSED_ROWS, splits);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    fused_pair_kernel<__nv_bfloat16><<<grid, FUSED_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const int*)xq, (const __nv_bfloat16*)w,
        (const uint32_t*)pairs, (const int*)ids, (float*)part_base,
        (int*)part_s, bsz, k, n2, k_per_split);
  else
    fused_pair_kernel<float><<<grid, FUSED_THREADS, 0, s>>>(
        (const float*)x, (const int*)xq, (const float*)w,
        (const uint32_t*)pairs, (const int*)ids, (float*)part_base,
        (int*)part_s, bsz, k, n2, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int count = bsz * n2 * 2;
  fused_pair_epilogue_kernel<<<(count + 255) / 256, 256, 0, s>>>(
      (const float*)part_base, (const int*)part_s, (const int*)ids,
      (const float*)a1, (const float*)a2, (const float*)sxq,
      (const float*)colsum, (float*)out, n2 * 2, splits, count);
  return (int)cudaGetLastError();
}
