// Flash-decode attention for Hopper (plain C interface, loaded with
// ctypes by ops/flash_decode.py).
//
// Replaces bitdelta_tpu/ops/flash_decode.py::flash_decode_attention
// (_flash_decode_kernel): a bf16/fp32 cache, or an int8 cache with one
// fp32 scale per (row, position, KV head) (its quantized=True branch).
//
// One query token per row attends over its live cache positions
// [max(len - window, 0), min(len, S)) with GQA (query head i uses KV head
// i / (H / KV)) and an fp32 online softmax, masked with -1e30.
//
// Bound on the H100: the live K/V bytes (each row reads only its own
// live positions; 1 byte an element plus the scales for the int8 cache)
// against 3.35 TB/s. The work is about 4 operations a byte, far below
// the tensor cores' ridge, so the kernel stays on the CUDA cores in fp32
// and aims to read each live byte once with many bytes in flight:
//   * one block per (KV head, row, split of DEC_CHUNK keys); splits start
//     at the row's first live key, and a block past the row's live range
//     exits at once, so a long row spreads over many SMs and a short one
//     costs a few empty blocks (the lengths are read on the device only);
//   * a key's hd values are read by a group of L lanes with 16-byte
//     vector loads (bf16: 16 lanes x 8, int8: 8 lanes x 16, fp32: 32 x 4);
//     each group takes every NG-th key of the split, and a thread issues
//     the K and V loads of DEC_UNROLL keys before it uses any;
//   * the G query heads of the KV head sit in registers (pre-scaled by
//     log2(e) / sqrt(hd): scores live in base 2), so every K/V byte feeds
//     all G heads; a score is E lane-local FMAs and a shuffle reduction
//     inside the group; no loop over hd from shared memory;
//   * each group keeps its online softmax state (max, sum, G x E outputs)
//     in registers; the groups of a warp merge by shuffles and the warps
//     through shared memory, once, at the end;
//   * each split writes its unnormalized output with its (max, sum);
//     flash_decode_merge_kernel reads only the row's live splits, in
//     split order (no atomics), and divides; a row with no live key gives
//     zeros.
// A full cache's decode step passes a length of S + 1 (its own K/V write
// was dropped): the window starts from that length, as in the plain
// version, and no key past the cache's last slot is read.
//
// The int8 cache stays 1 byte an element on the way in; its scales are
// folded as the TPU kernel folds them: q . (k8 * s) = (q . k8) * s into
// each score, and p @ (v8 * s) = (p * s) @ v8 into each probability (the
// denominator sums the unscaled probabilities).

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
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The 16 / sizeof(KV) values of one 16-byte load as fp32.
__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {           // bf16 -> fp32 is a shift
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[16]) {
  // int8 b -> fp32 exactly: the bits 0x4B0000{b + 128} are 2^23 + b + 128.
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(u[i], 0x4B000000u,
                                                 0x7540 + j)) - 8388736.0f;
}

constexpr int DEC_THREADS = 128;
constexpr int DEC_CHUNK = 64;     // keys a split (a block)
constexpr int DEC_UNROLL = 2;     // keys a thread loads before using any
constexpr float NEG_INF = -1e30f;

// The live range of row b: [lo, hi).
__device__ __forceinline__ void live_range(int len, int s_max, int window,
                                           int& lo, int& hi) {
  lo = window > 0 ? max(len - window, 0) : 0;
  hi = min(len, s_max);
}

// T: the type of q and the output; KV: the cache's type (T, or int8_t
// with QUANT and the k_scale / v_scale arrays (B, S, KV) fp32); HD the
// head width; G the query heads of a KV head.
template <typename T, typename KV, bool QUANT, int HD, int G>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                          const KV* __restrict__ v,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ lengths,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int s_max, int n_kv,
                          int window, float scale_log2, int n_split) {
  constexpr int E = 16 / sizeof(KV);      // values a lane loads per key
  constexpr int L = HD / E;               // lanes a key
  constexpr int NG = DEC_THREADS / L;     // key groups a block
  constexpr int NW = DEC_THREADS / 32;
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "HD / E must divide 32");
  __shared__ float s_acc[NW][G][HD];
  __shared__ float s_m[NW][G], s_l[NW][G];

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  int lo, hi;
  live_range(lengths[b], s_max, window, lo, hi);
  lo += split * DEC_CHUNK;
  if (lo >= hi) return;                   // past the row's live range
  const int end = min(hi, lo + DEC_CHUNK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / L, li = tid % L;
  const int nheads = n_kv * G;

  float qr[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[h][e] = to_f32(q[((size_t)b * nheads + kvh * G + h) * HD + li * E +
                          e]) * scale_log2;
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.0f;
  }

  const size_t pos_stride = (size_t)n_kv * HD;          // elements
  const KV* kb = k + (size_t)b * s_max * pos_stride + (size_t)kvh * HD +
                 li * E;
  const KV* vb = v + (size_t)b * s_max * pos_stride + (size_t)kvh * HD +
                 li * E;
  const size_t sc_base = (size_t)b * s_max * n_kv + kvh;
  // The same trip count for every lane, so the shuffles never diverge.
  const int n_iter = (end - lo + NG * DEC_UNROLL - 1) / (NG * DEC_UNROLL);
  for (int it = 0; it < n_iter; ++it) {
    const int base = lo + it * NG * DEC_UNROLL + grp;
    uint4 kw[DEC_UNROLL], vw[DEC_UNROLL];
    float ksc[DEC_UNROLL], vsc[DEC_UNROLL];
    bool ok[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int pos = base + u * NG;
      ok[u] = pos < end;
      kw[u] = vw[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 0.0f;
      if (ok[u]) {
        kw[u] = __ldg(reinterpret_cast<const uint4*>(kb + pos * pos_stride));
        vw[u] = __ldg(reinterpret_cast<const uint4*>(vb + pos * pos_stride));
        if (QUANT) {
          ksc[u] = __ldg(k_scale + sc_base + (size_t)pos * n_kv);
          vsc[u] = __ldg(v_scale + sc_base + (size_t)pos * n_kv);
        }
      }
    }
    float sc[G][DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      float kf[E];
      unpack16(kw[u], kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[h][e], kf[e], d);
        sc[h][u] = d;
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2)
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int u = 0; u < DEC_UNROLL; ++u)
          sc[h][u] += __shfl_xor_sync(0xffffffffu, sc[h][u], off);
    float pv[G][DEC_UNROLL];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < DEC_UNROLL; ++u) {
        if (QUANT) sc[h][u] *= ksc[u];
        if (ok[u]) mx = fmaxf(mx, sc[h][u]);
      }
      const float alpha = exp2f(m[h] - mx);
      m[h] = mx;
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int u = 0; u < DEC_UNROLL; ++u) {
        const float p = ok[u] ? exp2f(sc[h][u] - mx) : 0.0f;
        l[h] += p;
        pv[h][u] = QUANT ? p * vsc[u] : p;
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      float vf[E];
      unpack16(vw[u], vf);
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pv[h][u], vf[e], acc[h][e]);
    }
  }

  // Merge the key groups of a warp (lanes L, 2L, ... apart), then the
  // warps through shared memory.
#pragma unroll
  for (int off = L; off < 32; off *= 2) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mx = fmaxf(m[h], mo);
      const float fs = exp2f(m[h] - mx), fo = exp2f(mo - mx);
      m[h] = mx;
      l[h] = l[h] * fs + lo_ * fo;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[h][e], off);
        acc[h][e] = acc[h][e] * fs + ao * fo;
      }
    }
  }
  if (lane < L) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[warp][h][li * E + e] = acc[h][e];
      if (lane == 0) {
        s_m[warp][h] = m[h];
        s_l[warp][h] = l[h];
      }
    }
  }
  __syncthreads();
  const size_t head0 = (size_t)b * nheads + kvh * G;
  for (int i = tid; i < G * HD; i += DEC_THREADS) {
    const int h = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][h]);
    float a = 0.0f, ls = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(s_m[w][h] - mx);
      a += s_acc[w][h][d] * f;
      ls += s_l[w][h] * f;
    }
    const size_t slot = (head0 + h) * n_split + split;
    part_acc[slot * HD + d] = a;
    if (d == 0) {
      part_ml[slot * 2] = mx;
      part_ml[slot * 2 + 1] = ls;
    }
  }
}

// Merge the live splits of one (row, head) in split order: rescale each
// split's output to the overall max, add, divide by the merged sum; a
// row with no live key gives zeros. Dynamic shared memory: 2 * n_split
// floats (n_split = 8192 / 64 keys takes 1 KB).
template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_acc,
                                          const float* __restrict__ part_ml,
                                          const int* __restrict__ lengths,
                                          T* __restrict__ out, int s_max,
                                          int nheads, int hd, int window,
                                          int n_split) {
  extern __shared__ float ml_s[];         // [n_split] maxima, [n_split] sums
  float* w_s = ml_s;                      // then each split's weight
  const size_t bh = blockIdx.x;
  int lo, hi;
  live_range(lengths[bh / nheads], s_max, window, lo, hi);
  const int n_live = hi > lo ? (hi - lo + DEC_CHUNK - 1) / DEC_CHUNK : 0;
  const float* ml = part_ml + bh * n_split * 2;
  for (int s = threadIdx.x; s < n_live; s += blockDim.x) {
    ml_s[s] = ml[2 * s];
    ml_s[n_split + s] = ml[2 * s + 1];
  }
  __syncthreads();
  float mx = NEG_INF;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, ml_s[s]);
  float ls = 0.0f;
  for (int s = 0; s < n_live; ++s)
    ls += ml_s[n_split + s] * exp2f(ml_s[s] - mx);
  const float inv = ls > 0.0f ? 1.0f / ls : 0.0f;
  __syncthreads();
  for (int s = threadIdx.x; s < n_live; s += blockDim.x)
    w_s[s] = exp2f(ml_s[s] - mx) * inv;
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    const float* pa = part_acc + bh * n_split * hd + d;
    float a = 0.0f;
    int s = 0;
    for (; s + 4 <= n_live; s += 4) {     // four loads in flight
      const float a0 = pa[(size_t)s * hd], a1 = pa[(size_t)(s + 1) * hd];
      const float a2 = pa[(size_t)(s + 2) * hd], a3 = pa[(size_t)(s + 3) * hd];
      a += a0 * w_s[s];
      a += a1 * w_s[s + 1];
      a += a2 * w_s[s + 2];
      a += a3 * w_s[s + 3];
    }
    for (; s < n_live; ++s) a += pa[(size_t)s * hd] * w_s[s];
    out[bh * hd + d] = from_f32<T>(a);
  }
}

template <typename T, typename KV, bool QUANT, int HD, int G>
static int launch_split(const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const void* lengths, void* part_acc, void* part_ml,
                        int bsz, int s_max, int n_kv, int window,
                        float scale_log2, int n_split, cudaStream_t s) {
  dim3 grid(n_kv, bsz, n_split);
  flash_decode_split_kernel<T, KV, QUANT, HD, G><<<grid, DEC_THREADS, 0, s>>>(
      (const T*)q, (const KV*)k, (const KV*)v, (const float*)k_scale,
      (const float*)v_scale, (const int*)lengths, (float*)part_acc,
      (float*)part_ml, s_max, n_kv, window, scale_log2, n_split);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, bool QUANT, int HD>
static int launch_g(int g, const void* q, const void* k, const void* v,
                    const void* k_scale, const void* v_scale,
                    const void* lengths, void* part_acc, void* part_ml,
                    int bsz, int s_max, int n_kv, int window,
                    float scale_log2, int n_split, cudaStream_t s) {
#define BD_SPLIT(G_) launch_split<T, KV, QUANT, HD, G_>(                     \
    q, k, v, k_scale, v_scale, lengths, part_acc, part_ml, bsz, s_max, n_kv, \
    window, scale_log2, n_split, s)
  switch (g) {
    case 1: return BD_SPLIT(1);
    case 2: return BD_SPLIT(2);
    case 4: return BD_SPLIT(4);
    case 8: return BD_SPLIT(8);
  }
#undef BD_SPLIT
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename KV, bool QUANT>
static int launch_decode(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* lengths, void* part_acc, void* part_ml,
                         void* out, int bsz, int s_max, int nheads, int n_kv,
                         int hd, int window, float sm_scale, int n_split,
                         cudaStream_t s) {
  const int g = nheads / n_kv;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  int err = (int)cudaErrorInvalidValue;
  if (hd == 128)
    err = launch_g<T, KV, QUANT, 128>(g, q, k, v, k_scale, v_scale, lengths,
                                      part_acc, part_ml, bsz, s_max, n_kv,
                                      window, scale_log2, n_split, s);
  else if (hd == 64)
    err = launch_g<T, KV, QUANT, 64>(g, q, k, v, k_scale, v_scale, lengths,
                                     part_acc, part_ml, bsz, s_max, n_kv,
                                     window, scale_log2, n_split, s);
  if (err != (int)cudaSuccess) return err;
  flash_decode_merge_kernel<T><<<bsz * nheads, 128,
                                 2 * n_split * sizeof(float), s>>>(
      (const float*)part_acc, (const float*)part_ml, (const int*)lengths,
      (T*)out, s_max, nheads, hd, window, n_split);
  return (int)cudaGetLastError();
}

// k_scale / v_scale: null for a bf16/fp32 cache (k, v of q's type), the
// (B, S, KV) fp32 scales for an int8 cache (kv_int8 = 1). hd is 64 or
// 128 and H / KV one of 1, 2, 4, 8; part_acc (B, H, n_split, hd) and
// part_ml (B, H, n_split, 2) fp32 scratch, n_split = ceil(most live keys
// a row can have / chunk).
extern "C" int bd_flash_decode(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* lengths, void* part_acc,
                               void* part_ml, void* out, int bsz, int s_max,
                               int nheads, int n_kv, int hd, int window,
                               float sm_scale, int chunk, int n_split,
                               int is_bf16, int kv_int8, void* stream) {
  if (chunk != DEC_CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define BD_DECODE_ARGS q, k, v, k_scale, v_scale, lengths, part_acc, part_ml, \
    out, bsz, s_max, nheads, n_kv, hd, window, sm_scale, n_split, s
  if (kv_int8)
    return is_bf16 ? launch_decode<__nv_bfloat16, int8_t, true>(BD_DECODE_ARGS)
                   : launch_decode<float, int8_t, true>(BD_DECODE_ARGS);
  return is_bf16
      ? launch_decode<__nv_bfloat16, __nv_bfloat16, false>(BD_DECODE_ARGS)
      : launch_decode<float, float, false>(BD_DECODE_ARGS);
#undef BD_DECODE_ARGS
}
