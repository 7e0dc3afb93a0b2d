// Flash-prefill attention (forward) for Hopper (plain C interface,
// loaded with ctypes by ops/flash_prefill.py).
//
// Replaces the forward of
// bitdelta_tpu/ops/flash_prefill.py::flash_prefill_attention
// (_flash_prefill_kernel).
//
// Causal blockwise attention for fresh sequences (query positions
// 0..Sq-1) over a right-padded cache (Sk >= Sq) with per-row lengths, GQA
// and an optional sliding window. Mask: kpos <= qpos, kpos < length,
// qpos < length and, with a window, kpos > qpos - window. Scores of
// masked pairs are -1e30 and their probabilities are set to zero
// explicitly (a fully masked row would otherwise see exp(0) = 1);
// padding query rows (l == 0) come out as exact zeros.
//
// Bound on the H100: the operations of the visible triangle (4 * hd per
// visible (query, key) pair and head) against the bf16 tensor rate. This
// first version runs on the CUDA cores in fp32 and keeps the
// work-skipping of the TPU kernel: one block per (query tile of PF_BQ
// rows, query head, row); a query tile at or past the row's length only
// writes zeros; the key walk covers [max(q0 + 1 - window, 0),
// min(q0 + PF_BQ, length)) and nothing else, in tiles of PF_TK keys
// staged in shared memory (K padded for conflict-free dot products).
// Per key tile: scores for PF_BQ x PF_TK pairs, one warp per query row
// updates the online softmax state, then each thread rescales and adds
// its share of the (PF_BQ, hd) accumulator held in registers.

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

constexpr int PF_THREADS = 256;
constexpr int PF_BQ = 64;          // query rows per block
constexpr int PF_TK = 32;          // keys per tile (= warp width)
constexpr int PF_MAX_OUT = 32;     // PF_BQ * hd / PF_THREADS, hd <= 128
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int length,
                                        int window) {
  bool ok = kpos <= qpos && kpos < length && qpos < length;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

template <typename T>
__global__ void flash_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const int* __restrict__ lengths,
                                     T* __restrict__ out,
                                     int sq, int sk, int nheads, int n_kv,
                                     int hd, int window, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                            // [PF_BQ][hd]
  float* ks = qs + PF_BQ * hd;                  // [PF_TK][hd + 1]
  float* vs = ks + PF_TK * (hd + 1);           // [PF_TK][hd]
  float* ps = vs + PF_TK * hd;                 // [PF_BQ][PF_TK + 1]
  float* m_s = ps + PF_BQ * (PF_TK + 1);       // [PF_BQ]
  float* l_s = m_s + PF_BQ;                    // [PF_BQ]
  float* a_s = l_s + PF_BQ;                    // [PF_BQ]

  const int q0 = blockIdx.x * PF_BQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (nheads / n_kv);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int length = lengths[b];
  const int n_out = PF_BQ * hd;
  const size_t q_row = (size_t)nheads * hd;    // stride of one position

  if (q0 >= length) {                          // dead query tile: zeros
    for (int i = tid; i < n_out; i += PF_THREADS) {
      const int r = i / hd, d = i % hd;
      if (q0 + r < sq)
        out[((size_t)b * sq + q0 + r) * q_row + (size_t)head * hd + d] =
            from_f32<T>(0.0f);
    }
    return;
  }
  for (int i = tid; i < n_out; i += PF_THREADS) {
    const int r = i / hd, d = i % hd;
    qs[i] = (q0 + r < sq)
                ? to_f32(q[((size_t)b * sq + q0 + r) * q_row +
                           (size_t)head * hd + d])
                : 0.0f;
  }
  for (int r = tid; r < PF_BQ; r += PF_THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }
  float acc[PF_MAX_OUT];
#pragma unroll
  for (int i = 0; i < PF_MAX_OUT; ++i) acc[i] = 0.0f;

  const int hi = min(q0 + PF_BQ, length);
  const int lo = window > 0 ? max(q0 + 1 - window, 0) : 0;
  for (int t0 = lo; t0 < hi; t0 += PF_TK) {
    __syncthreads();
    for (int i = tid; i < PF_TK * hd; i += PF_THREADS) {
      const int j = i / hd, d = i % hd;
      const int kpos = t0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kpos < hi) {
        const size_t off = (((size_t)b * sk + kpos) * n_kv + kvh) * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j * (hd + 1) + d] = kv;
      vs[j * hd + d] = vv;
    }
    __syncthreads();
    // Scores: lane = key, warps stride over query rows.
    for (int r = warp; r < PF_BQ; r += PF_THREADS / 32) {
      const float* qr = qs + r * hd;
      const float* kj = ks + lane * (hd + 1);
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kj[d], dot);
      ps[r * (PF_TK + 1) + lane] =
          visible(q0 + r, t0 + lane, length, window) ? dot * sm_scale
                                                     : NEG_INF;
    }
    __syncthreads();
    // Online softmax: one warp per query row, lane = key.
    for (int r = warp; r < PF_BQ; r += PF_THREADS / 32) {
      const float s = ps[r * (PF_TK + 1) + lane];
      float tmax = s;
      for (int o = 16; o > 0; o /= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      const float p = visible(q0 + r, t0 + lane, length, window)
                          ? expf(s - m_new) : 0.0f;
      float psum = p;
      for (int o = 16; o > 0; o /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      ps[r * (PF_TK + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PF_MAX_OUT; ++i) {
      const int idx = tid + i * PF_THREADS;
      if (idx < n_out) {
        const int r = idx / hd, d = idx % hd;
        const float* pr = ps + r * (PF_TK + 1);
        float pv = 0.0f;
#pragma unroll 8
        for (int j = 0; j < PF_TK; ++j) pv = fmaf(pr[j], vs[j * hd + d], pv);
        acc[i] = acc[i] * a_s[r] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PF_MAX_OUT; ++i) {
    const int idx = tid + i * PF_THREADS;
    if (idx < n_out) {
      const int r = idx / hd, d = idx % hd;
      if (q0 + r < sq) {
        const float l = l_s[r];
        out[((size_t)b * sq + q0 + r) * q_row + (size_t)head * hd + d] =
            from_f32<T>(l > 0.0f ? acc[i] / l : 0.0f);
      }
    }
  }
}

extern "C" int bd_flash_prefill(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int bsz,
                                int sq, int sk, int nheads, int n_kv, int hd,
                                int window, float sm_scale, int is_bf16,
                                void* stream) {
  const size_t smem = sizeof(float) *
      ((size_t)PF_BQ * hd + PF_TK * (hd + 1) + PF_TK * hd +
       PF_BQ * (PF_TK + 1) + 3 * PF_BQ);
  dim3 grid((sq + PF_BQ - 1) / PF_BQ, nheads, bsz);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    cudaFuncSetAttribute(flash_prefill_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    flash_prefill_kernel<__nv_bfloat16><<<grid, PF_THREADS, smem, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)lengths, (__nv_bfloat16*)out,
        sq, sk, nheads, n_kv, hd, window, sm_scale);
  } else {
    cudaFuncSetAttribute(flash_prefill_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    flash_prefill_kernel<float><<<grid, PF_THREADS, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const int*)lengths, (float*)out, sq, sk, nheads, n_kv, hd, window,
        sm_scale);
  }
  return (int)cudaGetLastError();
}
