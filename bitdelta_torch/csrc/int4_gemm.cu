// W4 base matmul for Hopper (plain C interface, loaded with ctypes by
// ops/int4.py).
//
// Replaces bitdelta_tpu/ops/pallas_int4.py::w4_matmul_pallas: y = x @
// deq(Int4Weight) with x (M, K) bf16 or fp32 at decode (M <= 64), packed
// (K/8, N) int32 holding 8 two's-complement nibbles along K, LSB-first,
// and scale (K/128, N) fp32, one per 128-row group and column; y (M, N)
// fp32. JAX's arithmetic: each group's nibble * x products summed in
// fp32, the partial multiplied by the group's scale, the partials summed
// in fp32. Only the order of the sums differs.
//
// Bound on the H100: the packed words. One Mistral-7B decoder layer holds
// 218.1 M weights, 109 MB of nibbles and 6.8 MB of scales: 0.035 ms a
// layer at 3.35 TB/s, against 3.5 GFLOP (0.004 ms at the bf16 tensor
// rate). On CUDA cores, though, each nibble costs W4_MT fp32 FMAs, two
// broadcast shared loads and three bit/float operations (x is padded to
// W4_MT rows, so M = 1 costs what M = 8 does): this kernel is bound by
// instruction throughput, about 0.1 ms a layer at best, and runs at
// several times its byte bound (PERF.md). A revision that staged the
// block's whole x range once and prefetched the next group's words ran
// slower (more registers, the same instruction count). Getting near the
// byte bound takes tensor cores: nibbles turned into bf16 in registers
// feeding mma, later work.
//
// Design: a block of W4_BN threads owns W4_BN adjacent columns and a
// range of whole K groups; each thread owns one column, so every row of
// packed words loads coalesced (128 B per warp), and a column's 16 words
// of a group are loaded before the block synchronises on the group's x
// tile, which sits in shared memory as fp32 (rows padded to a multiple
// of W4_MT with zeros). A nibble becomes a float without a conversion
// instruction: (nib ^ 8) ORed into the mantissa of 2^23, minus 2^23 + 8.
// x is read four K values at a time (float4, a broadcast), and W4_MT rows
// of partial sums live in registers; the scaled partials accumulate per
// (row, column) in shared memory, touched only by the column's thread.
// At decode N can be as small as 1024 (k/v_proj): one N tile cannot fill
// 132 SMs, so K is split into ranges of whole groups across blocks, and a
// second kernel adds the ranges in range order (the result does not
// depend on scheduling). Any N is taken (the last tile is masked).

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

constexpr int W4_GROUP = 128;             // K rows per scale group
constexpr int W4_WORDS = W4_GROUP / 8;    // packed words per group and column
constexpr int W4_BN = 128;                // columns per block = threads
constexpr int W4_MT = 8;                  // rows of x per register pass

// Nibble s of word w as the float (nib ^ 8) - 8 in [-8, 7].
__device__ __forceinline__ float nibble(uint32_t w, int s) {
  const uint32_t bits = ((w >> (4 * s)) & 0xFu) ^ 0x4B000008u;
  return __uint_as_float(bits) - 8388616.0f;   // 2^23 + 8
}

template <typename T>
__global__ void __launch_bounds__(W4_BN)
w4_matmul_kernel(const T* __restrict__ x, const int* __restrict__ packed,
                 const float* __restrict__ scale, float* __restrict__ part,
                 int m, int m_pad, int k, int n, int n_groups) {
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
      xs[i] = r < m ? to_f32(x[(size_t)r * k + (size_t)g * W4_GROUP + kk])
                    : 0.0f;
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

template <typename T>
static int launch_w4(const void* x, const void* packed, const void* scale,
                     void* part, void* out, int m, int k, int n,
                     int n_split, cudaStream_t s) {
  const int n_groups = k / W4_GROUP;
  const int m_pad = (m + W4_MT - 1) / W4_MT * W4_MT;
  const size_t smem = sizeof(float) * (size_t)m_pad * (W4_GROUP + W4_BN);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(w4_matmul_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid((n + W4_BN - 1) / W4_BN, n_split);
  w4_matmul_kernel<T><<<grid, W4_BN, smem, s>>>(
      (const T*)x, (const int*)packed, (const float*)scale,
      n_split == 1 ? (float*)out : (float*)part, m, m_pad, k, n, n_groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int mn = m * n;
  w4_sum_splits_kernel<<<(mn + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)out, mn, n_split);
  return (int)cudaGetLastError();
}

extern "C" int bd_w4_matmul(const void* x, const void* packed,
                            const void* scale, void* part, void* out, int m,
                            int k, int n, int n_split, int is_bf16,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_w4<__nv_bfloat16>(x, packed, scale, part, out, m, k, n,
                                    n_split, s);
  return launch_w4<float>(x, packed, scale, part, out, m, k, n, n_split, s);
}
