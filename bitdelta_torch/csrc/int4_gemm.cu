// W4 base matmul for Hopper (plain C interface, loaded with ctypes by
// ops/int4.py).
//
// Replaces bitdelta_tpu/ops/pallas_int4.py::w4_matmul_pallas: y = x @
// deq(Int4Weight) with x (M, K) bf16 or fp32 at decode (M <= 64), packed
// (K/8, N) int32 holding 8 two's-complement nibbles along K, LSB-first,
// and scale (K/128, N) fp32, one per 128-row group and column; y (M, N)
// fp32. JAX's arithmetic: each group's nibble * x products summed in
// fp32 from zero, the partial multiplied by the group's scale, the
// partials summed in fp32. Only the order of the sums differs.
//
// Bound on the H100: the packed words. One Mistral-7B decoder layer holds
// 218.1 M weights, 109 MB of nibbles and 6.8 MB of scales: 0.035 ms a
// layer at 3.35 TB/s, against 3.5 GFLOP at M = 8 (0.004 ms at the bf16
// tensor rate). So the kernel has to stream the words at the memory rate
// and spend few instructions on each.
//
// bf16 x: w4_matmul_tc_kernel, on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 sums), with the weights as the A
// operand ("swap AB": y^T = deq(W)^T x^T). A warp owns 32 columns, two
// m16 tiles; the decode rows are the n8 side, NT tiles of 8 rows
// (M <= 8 fills one MMA). A block of TC_WARPS warps owns TC_BN columns
// and a range of whole 128-row groups; a TC_STAGES-deep cp.async ring
// brings each group's 16 x TC_BN words, TC_BN scales and the group's x
// (8 NT rows, zero beyond M) into shared memory, coalesced along N.
//
// Nibbles become bf16 in registers, with no conversion instruction: the
// word is XORed with 0x88888888 once (nibble v in [-8, 7] becomes
// q = v + 8 in [0, 15]); for i = 0..3, (word >> 4i) & 0x000F000F ORed
// with 0x43004300 is the bf16 pair (128 + q_i, 128 + q_{i+4}), and one
// bf16x2 FMA subtracts 136, exactly. So register r_i of a word holds
// nibbles (i, i + 4): lower half nibble i, upper half nibble i + 4.
//
// K is permuted, not the weights (a dot product does not depend on the
// order of its terms). Within a 128-row group, lane (g, t) = (lane / 4,
// lane % 4) reads for u = 0..3 the word of row 4u + t of its columns and
// of its x rows the same 8 K values (octet 4u + t). K step j = 2u + h
// (h = 0, 1) feeds the MMA's K positions 2t, 2t+1 from r_{2h} and
// positions 2t+8, 2t+9 from r_{2h+1}:
//     position 2t   <- K 8(4u+t) + 2h        position 2t+1 <- ... + 2h + 4
//     position 2t+8 <- K 8(4u+t) + 2h + 1    position 2t+9 <- ... + 2h + 5
// x's octet is staged in shared memory as it lies in memory (8 bf16,
// 16 bytes) and permuted in registers by byte_perm into the matching
// pairs (x_i, x_{i+4}), i = 0..3. tests/test_torch_w4_numerics.py models
// this map and the conversion on the CPU.
//
// A rows map to columns so that each lane's four columns are adjacent
// (one 16-byte shared load a word row): m-tile 0 row g is column 4g,
// row g + 8 column 4g + 1; m-tile 1 rows g, g + 8 are columns 4g + 2,
// 4g + 3 (of the warp's 32). Shared rows are padded (TC_WSTRIDE,
// TC_XSTRIDE) so these loads are free of bank conflicts.
//
// Each group's 8 K steps run into a fresh fp32 accumulator, which is then
// multiplied by the column's scale (rounded, as JAX rounds the product)
// and added to the running sum: the tensor cores' truncating
// accumulation stays inside one group, as in JAX's order. Column tiles
// alone cannot fill 132 SMs (k/v_proj: 8 tiles of N = 1024), so K is
// split into ranges of whole groups across blocks, and a second kernel
// adds the ranges in range order (the result does not depend on
// scheduling). Any N is taken: the last tile is masked, and where N * 4
// is not a multiple of 16 (or a pointer is not 16-byte aligned) words
// and scales come in 4-byte copies instead of 16-byte ones.
//
// fp32 x: w4_matmul_fp32_kernel, on the CUDA cores (one thread a column,
// nibbles to floats by a mantissa trick, W4_MT rows of x at a time from
// shared memory). Bound by instruction issue; kept for fp32 input, which
// only the parity checks send.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

extern "C" const char* bd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr int W4_GROUP = 128;             // K rows per scale group
constexpr int W4_WORDS = W4_GROUP / 8;    // packed words per group and column

// ---------------------------------------------------------------------------
// bf16 x: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_BN = TC_WARPS * 32;      // columns per block
constexpr int TC_STAGES = 3;              // groups in the cp.async ring
constexpr int TC_WSTRIDE = TC_BN + 8;     // words per shared word row
constexpr int TC_XSTRIDE = 80;            // 32-bit words per shared x row
                                          // (64 of data, 16 of padding)

// 32-bit words of one ring stage: the group's words, its scales, its x.
template <int NT>
__host__ __device__ constexpr int tc_stage_words() {
  return W4_WORDS * TC_WSTRIDE + TC_BN + NT * 8 * TC_XSTRIDE;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// (v & 0x000F000F) | 0x43004300: two nibbles as bf16 128 + q.
__device__ __forceinline__ uint32_t nib_pair_bits(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n"
      : "=r"(r) : "r"(v), "n"(0x000F000F), "n"(0x43004300));
  return r;
}

// One packed word as four bf16x2 registers, r[i] = (nibble i,
// nibble i + 4), each value exact in [-8, 7].
__device__ __forceinline__ void word_to_bf16x2(uint32_t w,
                                               uint32_t (&r)[4]) {
  const uint32_t q = w ^ 0x88888888u;
  const uint32_t one = 0x3F803F80u;        // bf16 (1.0, 1.0)
  const uint32_t neg136 = 0xC308C308u;     // bf16 (-136.0, -136.0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = nib_pair_bits(q >> (4 * i));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(r[i]) : "r"(b), "r"(one), "r"(neg136));
  }
}

// Copy group g's words, scales and x into one ring stage.
template <int NT, bool VEC>
__device__ __forceinline__ void tc_load_stage(
    uint32_t* st, const __nv_bfloat16* __restrict__ x,
    const int* __restrict__ packed, const float* __restrict__ scale,
    int g, int col0, int m, int k, int n) {
  uint32_t* ws = st;
  uint32_t* ss = st + W4_WORDS * TC_WSTRIDE;
  uint32_t* xs = ss + TC_BN;
  const int tid = threadIdx.x;
  const int* prow = packed + (size_t)g * W4_WORDS * n;
  const float* srow = scale + (size_t)g * n;
  if constexpr (VEC) {
    constexpr int CH = TC_BN / 4;          // 16-byte chunks a row
    for (int i = tid; i < W4_WORDS * CH; i += TC_THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = col0 + c < n;        // n % 4 == 0: whole chunks
      cp_async16(ws + r * TC_WSTRIDE + c,
                 prow + (ok ? (size_t)r * n + col0 + c : 0), ok);
    }
    for (int i = tid; i < CH; i += TC_THREADS) {
      const bool ok = col0 + 4 * i < n;
      cp_async16(ss + 4 * i, srow + (ok ? col0 + 4 * i : 0), ok);
    }
  } else {
    for (int i = tid; i < W4_WORDS * TC_BN; i += TC_THREADS) {
      const int r = i / TC_BN, c = i % TC_BN;
      const bool ok = col0 + c < n;
      cp_async4(ws + r * TC_WSTRIDE + c,
                prow + (ok ? (size_t)r * n + col0 + c : 0), ok);
    }
    for (int c = tid; c < TC_BN; c += TC_THREADS) {
      const bool ok = col0 + c < n;
      cp_async4(ss + c, srow + (ok ? col0 + c : 0), ok);
    }
  }
  // x: 8 NT rows of 16 octets (16 bytes each), zeros beyond row m.
  for (int i = tid; i < NT * 8 * 16; i += TC_THREADS) {
    const int r = i / 16, c = i % 16;
    const bool ok = r < m;
    cp_async16(xs + r * TC_XSTRIDE + c * 4,
               x + (ok ? (size_t)r * k + (size_t)g * W4_GROUP + c * 8 : 0),
               ok);
  }
}

template <int NT, bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
w4_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const int* __restrict__ packed,
                    const float* __restrict__ scale,
                    float* __restrict__ part, int m, int k, int n,
                    int n_groups) {
  extern __shared__ __align__(16) uint32_t smem_tc[];
  constexpr int STAGE = tc_stage_words<NT>();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int col0 = blockIdx.x * TC_BN;
  const int wc = warp * 32 + 4 * gq;       // the lane's first column
  const int split = blockIdx.y, n_split = gridDim.y;
  const int g0 = (int)((long long)split * n_groups / n_split);
  const int g1 = (int)((long long)(split + 1) * n_groups / n_split);
  const int ng = g1 - g0;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ng)
      tc_load_stage<NT, VEC>(smem_tc + s * STAGE, x, packed, scale, g0 + s,
                             col0, m, k, n);
    cp_async_commit();
  }

  float tot[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.0f;

  for (int i = 0; i < ng; ++i) {
    cp_async_wait<TC_STAGES - 2>();        // group i has landed
    __syncthreads();                       // and group i - 1 is read
    {
      const int next = i + TC_STAGES - 1;
      if (next < ng)
        tc_load_stage<NT, VEC>(smem_tc + (next % TC_STAGES) * STAGE, x,
                               packed, scale, g0 + next, col0, m, k, n);
      cp_async_commit();
    }
    const uint32_t* ws = smem_tc + (i % TC_STAGES) * STAGE;
    const float* ss =
        reinterpret_cast<const float*>(ws + W4_WORDS * TC_WSTRIDE);
    const uint32_t* xs = ws + W4_WORDS * TC_WSTRIDE + TC_BN;

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = 4 * u + tq;          // word row = x octet
      const uint4 wv =
          *reinterpret_cast<const uint4*>(ws + row * TC_WSTRIDE + wc);
      uint32_t a[4][4];                    // [column][register]
      word_to_bf16x2(wv.x, a[0]);
      word_to_bf16x2(wv.y, a[1]);
      word_to_bf16x2(wv.z, a[2]);
      word_to_bf16x2(wv.w, a[3]);
      uint32_t b[NT][4];                   // (x_i, x_{i+4}), i = 0..3
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 xv = *reinterpret_cast<const uint4*>(
            xs + (nt * 8 + gq) * TC_XSTRIDE + row * 4);
        b[nt][0] = __byte_perm(xv.x, xv.z, 0x5410);
        b[nt][1] = __byte_perm(xv.x, xv.z, 0x7632);
        b[nt][2] = __byte_perm(xv.y, xv.w, 0x5410);
        b[nt][3] = __byte_perm(xv.y, xv.w, 0x7632);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t af[4] = {a[2 * mt][2 * h], a[2 * mt + 1][2 * h],
                                  a[2 * mt][2 * h + 1],
                                  a[2 * mt + 1][2 * h + 1]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_16816(acc[mt][nt], af, b[nt][2 * h], b[nt][2 * h + 1]);
        }
    }
    const float4 s4 = *reinterpret_cast<const float4*>(ss + wc);
    const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        tot[mt][nt][0] += __fmul_rn(acc[mt][nt][0], sc[2 * mt]);
        tot[mt][nt][1] += __fmul_rn(acc[mt][nt][1], sc[2 * mt]);
        tot[mt][nt][2] += __fmul_rn(acc[mt][nt][2], sc[2 * mt + 1]);
        tot[mt][nt][3] += __fmul_rn(acc[mt][nt][3], sc[2 * mt + 1]);
      }
  }
  cp_async_wait<0>();

  // c0, c1: (A row g, x rows 2t, 2t + 1); c2, c3: (A row g + 8, ...).
  const int col = col0 + wc;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * tq + e;
      if (r >= m) continue;
      const float v[4] = {tot[0][nt][e], tot[0][nt][2 + e], tot[1][nt][e],
                          tot[1][nt][2 + e]};
      float* dst = part + ((size_t)split * m + r) * n + col;
      if (VEC && col + 3 < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                      v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < n) dst[c] = v[c];
      }
    }
}

// ---------------------------------------------------------------------------
// fp32 x: CUDA cores
// ---------------------------------------------------------------------------

constexpr int W4_BN = 128;                // columns per block = threads
constexpr int W4_MT = 8;                  // rows of x per register pass

// Nibble s of word w as the float (nib ^ 8) - 8 in [-8, 7].
__device__ __forceinline__ float nibble(uint32_t w, int s) {
  const uint32_t bits = ((w >> (4 * s)) & 0xFu) ^ 0x4B000008u;
  return __uint_as_float(bits) - 8388616.0f;   // 2^23 + 8
}

// A block of W4_BN threads owns W4_BN adjacent columns and a range of
// whole K groups; each thread owns one column, so every row of packed
// words loads coalesced, and a column's 16 words of a group are loaded
// before the block synchronises on the group's x tile (fp32 in shared
// memory, rows padded to a multiple of W4_MT with zeros). The scaled
// partials accumulate per (row, column) in shared memory, touched only
// by the column's thread.
__global__ void __launch_bounds__(W4_BN)
w4_matmul_fp32_kernel(const float* __restrict__ x,
                      const int* __restrict__ packed,
                      const float* __restrict__ scale,
                      float* __restrict__ part, int m, int m_pad, int k,
                      int n, int n_groups) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [m_pad][W4_GROUP]
  float* acc = xs + m_pad * W4_GROUP;        // [m_pad][W4_BN]
  const int tid = threadIdx.x;
  const int col = blockIdx.x * W4_BN + tid;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int g0 = (int)((long long)split * n_groups / n_split);
  const int g1 = (int)((long long)(split + 1) * n_groups / n_split);
  const bool live = col < n;

  for (int r = 0; r < m_pad; ++r) acc[r * W4_BN + tid] = 0.0f;
  for (int g = g0; g < g1; ++g) {
    uint32_t w[W4_WORDS];
#pragma unroll
    for (int i = 0; i < W4_WORDS; ++i)
      w[i] = live ? (uint32_t)packed[(size_t)(g * W4_WORDS + i) * n + col]
                  : 0u;
    const float s = live ? scale[(size_t)g * n + col] : 0.0f;
    __syncthreads();                         // the last group's x is read
    for (int i = tid; i < m_pad * W4_GROUP; i += W4_BN) {
      const int r = i / W4_GROUP, kk = i % W4_GROUP;
      xs[i] = r < m ? x[(size_t)r * k + (size_t)g * W4_GROUP + kk] : 0.0f;
    }
    __syncthreads();
    for (int r0 = 0; r0 < m_pad; r0 += W4_MT) {
      float p[W4_MT];
#pragma unroll
      for (int j = 0; j < W4_MT; ++j) p[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < W4_WORDS; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {        // four nibbles at a time
          const float v0 = nibble(w[i], 4 * h);
          const float v1 = nibble(w[i], 4 * h + 1);
          const float v2 = nibble(w[i], 4 * h + 2);
          const float v3 = nibble(w[i], 4 * h + 3);
#pragma unroll
          for (int j = 0; j < W4_MT; ++j) {
            const float4 xv = *reinterpret_cast<const float4*>(
                xs + (r0 + j) * W4_GROUP + i * 8 + h * 4);
            p[j] = fmaf(v0, xv.x, p[j]);
            p[j] = fmaf(v1, xv.y, p[j]);
            p[j] = fmaf(v2, xv.z, p[j]);
            p[j] = fmaf(v3, xv.w, p[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < W4_MT; ++j)
        acc[(r0 + j) * W4_BN + tid] += p[j] * s;
    }
  }
  if (live)
    for (int r = 0; r < m; ++r)
      part[((size_t)split * m + r) * n + col] = acc[r * W4_BN + tid];
}

// out[i] = sum over splits, in split order, of part[split][i].
__global__ void w4_sum_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int mn,
                                     int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.0f;
  for (int s = 0; s < n_split; ++s) acc += part[(size_t)s * mn + i];
  out[i] = acc;
}

template <int NT, bool VEC>
static cudaError_t launch_tc(const void* x, const void* packed,
                             const void* scale, float* dst, int m, int k,
                             int n, int n_split, cudaStream_t s) {
  const size_t smem =
      sizeof(uint32_t) * (size_t)tc_stage_words<NT>() * TC_STAGES;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4_matmul_tc_kernel<NT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((n + TC_BN - 1) / TC_BN, n_split);
  w4_matmul_tc_kernel<NT, VEC><<<grid, TC_THREADS, smem, s>>>(
      (const __nv_bfloat16*)x, (const int*)packed, (const float*)scale,
      dst, m, k, n, k / W4_GROUP);
  return cudaGetLastError();
}

template <bool VEC>
static cudaError_t launch_tc_rows(const void* x, const void* packed,
                                  const void* scale, float* dst, int m,
                                  int k, int n, int n_split,
                                  cudaStream_t s) {
  if (m <= 8)
    return launch_tc<1, VEC>(x, packed, scale, dst, m, k, n, n_split, s);
  if (m <= 16)
    return launch_tc<2, VEC>(x, packed, scale, dst, m, k, n, n_split, s);
  if (m <= 32)
    return launch_tc<4, VEC>(x, packed, scale, dst, m, k, n, n_split, s);
  return launch_tc<8, VEC>(x, packed, scale, dst, m, k, n, n_split, s);
}

extern "C" int bd_w4_matmul(const void* x, const void* packed,
                            const void* scale, void* part, void* out, int m,
                            int k, int n, int n_split, int is_bf16,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = n_split == 1 ? (float*)out : (float*)part;
  cudaError_t err;
  if (is_bf16) {
    if (m > 64 || ((uintptr_t)x % 16) != 0) return (int)cudaErrorInvalidValue;
    const bool vec = n % 4 == 0 && ((uintptr_t)packed % 16) == 0
                     && ((uintptr_t)scale % 16) == 0;
    err = vec ? launch_tc_rows<true>(x, packed, scale, dst, m, k, n,
                                     n_split, s)
              : launch_tc_rows<false>(x, packed, scale, dst, m, k, n,
                                      n_split, s);
  } else {
    const int m_pad = (m + W4_MT - 1) / W4_MT * W4_MT;
    const size_t smem = sizeof(float) * (size_t)m_pad * (W4_GROUP + W4_BN);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(w4_matmul_fp32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((n + W4_BN - 1) / W4_BN, n_split);
    w4_matmul_fp32_kernel<<<grid, W4_BN, smem, s>>>(
        (const float*)x, (const int*)packed, (const float*)scale, dst, m,
        m_pad, k, n, k / W4_GROUP);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int mn = m * n;
  w4_sum_splits_kernel<<<(mn + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)out, mn, n_split);
  return (int)cudaGetLastError();
}
