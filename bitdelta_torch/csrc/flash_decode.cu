// Flash-decode attention for Hopper (plain C interface, loaded with
// ctypes by ops/flash_decode.py).
//
// Replaces bitdelta_tpu/ops/flash_decode.py::flash_decode_attention
// (_flash_decode_kernel), bf16/fp32 cache.
//
// One query token per row attends over its live cache positions
// [max(len - window, 0), len) with GQA (query head i uses KV head
// i / (H / KV)) and an fp32 online softmax, masked with -1e30.
//
// Bound on the H100: the live K/V bytes (each row reads only its own
// live positions) against 3.35 TB/s. Design: one block per (KV head,
// row, key split), so the G query heads that share a KV head read each
// K/V tile once, and a long row's live range is cut into `chunk`-key
// splits that run on separate SMs (one block per row and head alone
// leaves most of the card idle and walks 2048 keys in sequence). A block
// walks only its live positions, in tiles of DEC_TK keys staged in
// shared memory as fp32 (K rows padded by one word so the per-key dot
// products are bank-conflict free). Per tile: scores for all G heads,
// one warp per head updates the running max / denominator, and every
// thread rescales and accumulates its share of the (G, hd) output. Each
// split writes its unnormalized output with its (max, denominator); a
// second kernel merges the splits in split order. No dead cache position
// is read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

extern "C" const char* bd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int DEC_THREADS = 128;
constexpr int DEC_TK = 32;        // keys per tile (= warp width)
constexpr int DEC_MAX_OUT = 8;    // (G * hd) / DEC_THREADS outputs a thread
constexpr float NEG_INF = -1e30f;

template <typename T>
__global__ void flash_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ part_acc,
                                    float* __restrict__ part_ml,
                                    int s_max, int nheads, int n_kv, int hd,
                                    int window, float sm_scale, int chunk) {
  extern __shared__ float smem[];
  const int g = nheads / n_kv;
  const int kvh = blockIdx.x, b = blockIdx.y;
  float* qs = smem;                           // [g][hd]
  float* ks = qs + g * hd;                     // [DEC_TK][hd + 1]
  float* vs = ks + DEC_TK * (hd + 1);         // [DEC_TK][hd]
  float* sc = vs + DEC_TK * hd;               // [g][DEC_TK]
  float* m_s = sc + g * DEC_TK;               // [g]
  float* l_s = m_s + g;                       // [g]
  float* a_s = l_s + g;                       // [g]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int row_hi = lengths[b];
  const int lo = (window > 0 ? max(row_hi - window, 0) : 0) + split * chunk;
  const int hi = min(row_hi, lo + chunk);
  const int n_out = g * hd;

  for (int i = tid; i < n_out; i += DEC_THREADS)
    qs[i] = to_f32(q[((size_t)b * nheads + kvh * g) * hd + i]);
  for (int i = tid; i < g; i += DEC_THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }
  float acc[DEC_MAX_OUT];
#pragma unroll
  for (int i = 0; i < DEC_MAX_OUT; ++i) acc[i] = 0.0f;

  for (int t0 = lo; t0 < hi; t0 += DEC_TK) {
    __syncthreads();
    for (int i = tid; i < DEC_TK * hd; i += DEC_THREADS) {
      const int j = i / hd, d = i % hd;
      const int pos = t0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (pos < hi) {
        const size_t off = (((size_t)b * s_max + pos) * n_kv + kvh) * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j * (hd + 1) + d] = kv;
      vs[j * hd + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < g * DEC_TK; i += DEC_THREADS) {
      const int h = i / DEC_TK, j = i % DEC_TK;
      const float* qh = qs + h * hd;
      const float* kj = ks + j * (hd + 1);
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qh[d], kj[d], dot);
      sc[i] = (t0 + j < hi) ? dot * sm_scale : NEG_INF;
    }
    __syncthreads();
    for (int h = warp; h < g; h += DEC_THREADS / 32) {
      const bool valid = t0 + lane < hi;
      const float s = sc[h * DEC_TK + lane];
      float tmax = s;
      for (int o = 16; o > 0; o /= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, tmax);
      const float p = valid ? expf(s - m_new) : 0.0f;
      float psum = p;
      for (int o = 16; o > 0; o /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      sc[h * DEC_TK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + psum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DEC_MAX_OUT; ++i) {
      const int idx = tid + i * DEC_THREADS;
      if (idx < n_out) {
        const int h = idx / hd, d = idx % hd;
        const float* ph = sc + h * DEC_TK;
        float pv = 0.0f;
        for (int j = 0; j < DEC_TK; ++j) pv = fmaf(ph[j], vs[j * hd + d], pv);
        acc[i] = acc[i] * a_s[h] + pv;
      }
    }
  }
  __syncthreads();
  // This split's unnormalized output and its (max, denominator) per head.
  const size_t head0 = (size_t)b * nheads + kvh * g;
#pragma unroll
  for (int i = 0; i < DEC_MAX_OUT; ++i) {
    const int idx = tid + i * DEC_THREADS;
    if (idx < n_out) {
      const int h = idx / hd, d = idx % hd;
      part_acc[((head0 + h) * n_split + split) * hd + d] = acc[i];
    }
  }
  for (int h = tid; h < g; h += DEC_THREADS) {
    part_ml[((head0 + h) * n_split + split) * 2] = m_s[h];
    part_ml[((head0 + h) * n_split + split) * 2 + 1] = l_s[h];
  }
}

// Merge the key splits of one (row, head): rescale each split's output
// to the overall max, add in split order, divide by the merged
// denominator; a row with no live key gives zeros.
template <typename T>
__global__ void merge_splits_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out, int n_split,
                                    int hd) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.0f;
  for (int s = 0; s < n_split; ++s) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < n_split; ++s)
      acc += part_acc[(bh * n_split + s) * hd + d] * expf(ml[2 * s] - m);
    out[bh * hd + d] = from_f32<T>(l > 0.0f ? acc / l : 0.0f);
  }
}

extern "C" int bd_flash_decode(const void* q, const void* k, const void* v,
                               const void* lengths, void* part_acc,
                               void* part_ml, void* out, int bsz, int s_max,
                               int nheads, int n_kv, int hd, int window,
                               float sm_scale, int chunk, int n_split,
                               int is_bf16, void* stream) {
  const int g = nheads / n_kv;
  const size_t smem = sizeof(float) *
      ((size_t)g * hd + DEC_TK * (hd + 1) + DEC_TK * hd + g * DEC_TK + 3 * g);
  dim3 grid(n_kv, bsz, n_split);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(flash_decode_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    flash_decode_kernel<__nv_bfloat16><<<grid, DEC_THREADS, smem, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)lengths, (float*)part_acc,
        (float*)part_ml, s_max, nheads, n_kv, hd, window, sm_scale, chunk);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(flash_decode_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    flash_decode_kernel<float><<<grid, DEC_THREADS, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int*)lengths, (float*)part_acc, (float*)part_ml, s_max,
        nheads, n_kv, hd, window, sm_scale, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    merge_splits_kernel<__nv_bfloat16><<<bsz * nheads, 128, 0, s>>>(
        (const float*)part_acc, (const float*)part_ml, (__nv_bfloat16*)out,
        n_split, hd);
  else
    merge_splits_kernel<float><<<bsz * nheads, 128, 0, s>>>(
        (const float*)part_acc, (const float*)part_ml, (float*)out, n_split,
        hd);
  return (int)cudaGetLastError();
}
