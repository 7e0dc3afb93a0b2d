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
// padding query rows (l == 0) come out as exact zeros. Both kernels keep
// the TPU kernel's work-skipping: one block per (query tile of 64 rows,
// query head, row); a query tile at or past the row's length only writes
// zeros; the key walk covers [max(q0 + 1 - window, 0), min(q0 + 64,
// length)) and nothing else.
//
// Bound on the H100: the operations of the visible triangle (4 * hd per
// visible (query, key) pair and head, some 2 GFLOP for a 500-token
// Mistral prefill) against the bf16 tensor rate; tensor-core work.
//
// bf16 input, flash_prefill_tc_kernel (a flash-attention-2 shape):
//   * 4 warps, each owning 16 query rows; Q is loaded once into mma A
//     fragments (ldmatrix) and kept in registers;
//   * K/V tiles of 64 keys x hd go through a 2-stage cp.async ring,
//     zero-filled past the row's last live key; the 16-byte chunks of
//     every row are XOR-swizzled by row (chunk ^ row % 8), so the
//     cp.async stores and the ldmatrix reads hit distinct banks;
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 -> fp32), K read as the B
//     operand by ldmatrix without transpose; a warp's 16 x 64 scores stay
//     in registers;
//   * online softmax in registers, base 2 (the scale folded with log2 e):
//     each thread holds 2 rows' shares, and the row max reduces across
//     the 4 lanes of a quad; row sums are kept per thread in fp32 and
//     reduced once at the end; masks are evaluated only on tiles that
//     touch the diagonal, the window's edge or a row's end;
//   * P is rounded to bf16 and reused straight from the score
//     accumulators as the A fragment of P V (no trip through shared
//     memory): for the k-step over key tiles 2j and 2j+1, a0 = (C[2j].c0,
//     c1), a1 = (C[2j].c2, c3), a2 = (C[2j+1].c0, c1), a3 = (C[2j+1].c2,
//     c3); V is the B operand through ldmatrix.trans;
//   * query tiles are issued longest key walk first, so the causal
//     triangle's long blocks do not trail at the end of the grid.
//   Rounding P to bf16 is the one numerical change against an fp32
//   product: about 2^-9 of a row's output scale.
// fp32 input, flash_prefill_fp32_kernel: the first CUDA-core kernel,
//   kept as its own branch for the fp32 parity paths (scores and P V as
//   fp32 FMAs from shared memory, 32-key tiles).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

extern "C" const char* bd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int length,
                                        int window) {
  bool ok = kpos <= qpos && kpos < length && qpos < length;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int PF_THREADS = 256;
constexpr int PF_BQ = 64;          // query rows per block
constexpr int PF_TK = 32;          // keys per tile (= warp width)
constexpr int PF_MAX_OUT = 32;     // PF_BQ * hd / PF_THREADS, hd <= 128

// One block per (query tile, head, row). Per 32-key tile staged in
// shared memory (K padded for conflict-free dot products): scores for
// PF_BQ x PF_TK pairs, one warp per query row updates the online softmax
// state, then each thread rescales and adds its share of the (PF_BQ, hd)
// accumulator held in registers.
__global__ void flash_prefill_fp32_kernel(const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const int* __restrict__ lengths,
                                          float* __restrict__ out,
                                          int sq, int sk, int nheads,
                                          int n_kv, int hd, int window,
                                          float sm_scale) {
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
            0.0f;
    }
    return;
  }
  for (int i = tid; i < n_out; i += PF_THREADS) {
    const int r = i / hd, d = i % hd;
    qs[i] = (q0 + r < sq)
                ? q[((size_t)b * sq + q0 + r) * q_row + (size_t)head * hd + d]
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
        kv = k[off];
        vv = v[off];
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
            l > 0.0f ? acc[i] / l : 0.0f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;          // query rows per block (16 a warp)
constexpr int TC_BK = 64;          // keys per tile
constexpr int TC_THREADS = 128;
constexpr int TC_STAGES = 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(TC_BQ + 2 * TC_STAGES * TC_BK) * HD;
}

// q (B, Sq, H, HD), k / v (B, Sk, KV, HD), out (B, Sq, H * HD), all bf16.
// scale_log2 = log2(e) / sqrt(HD): scores live in base 2.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int sq, int sk,
                        int nheads, int n_kv, int window, float scale_log2) {
  static_assert(HD % 16 == 0 && HD <= 128, "HD: a multiple of 16, <= 128");
  constexpr int CH = HD / 8;       // 16-byte chunks of one row
  constexpr int NT = TC_BK / 8;    // 8-key score tiles of a warp
  constexpr int NO = HD / 8;       // 8-column output tiles of a warp
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [BQ][HD]
  __nv_bfloat16* kv_st = qs + TC_BQ * HD;      // stages of K [BK][HD], V

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (nheads / n_kv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const size_t q_row = (size_t)nheads * HD;    // stride of one position
  const size_t kv_row = (size_t)n_kv * HD;

  if (q0 >= length) {                          // dead query tile: zeros
    for (int c = tid; c < TC_BQ * CH; c += TC_THREADS) {
      const int r = c / CH, ch = c % CH;
      if (q0 + r < sq)
        *reinterpret_cast<uint4*>(out + ((size_t)b * sq + q0 + r) * q_row +
                                  (size_t)head * HD + ch * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int len_k = min(length, sk);
  const int hi = min(q0 + TC_BQ, len_k);
  const int lo = window > 0 ? max(q0 + 1 - window, 0) : 0;
  const int n_tiles = max(hi - lo + TC_BK - 1, 0) / TC_BK;

  // Q rows past Sq are zero-filled (their outputs are never stored).
  for (int c = tid; c < TC_BQ * CH; c += TC_THREADS) {
    const int r = c / CH, ch = c % CH;
    const bool ok = q0 + r < sq;
    const __nv_bfloat16* src =
        ok ? q + ((size_t)b * sq + q0 + r) * q_row + (size_t)head * HD + ch * 8
           : q;
    cp_async16(qs + r * HD + ((ch ^ (r & 7)) << 3), src, ok);
  }
  auto load_tile = [&](int i) {
    const int t0 = lo + i * TC_BK;
    __nv_bfloat16* ks = kv_st + (i % TC_STAGES) * 2 * TC_BK * HD;
    __nv_bfloat16* vs = ks + TC_BK * HD;
#pragma unroll
    for (int c = tid; c < TC_BK * CH; c += TC_THREADS) {
      const int j = c / CH, ch = c % CH;
      const bool ok = t0 + j < hi;
      const size_t off =
          ok ? ((size_t)b * sk + t0 + j) * kv_row + (size_t)kvh * HD + ch * 8
             : 0;
      const int dst = j * HD + ((ch ^ (j & 7)) << 3);
      cp_async16(ks + dst, k + off, ok);
      cp_async16(vs + dst, v + off, ok);
    }
  };
  load_tile(0);
  cp_async_commit();

  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int lq = lane >> 3, l8 = lane & 7;     // ldmatrix x4 coordinates
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // Masks are needed on a tile that reaches past the first query row
  // (causal), past the last live key, over padding query rows, or before
  // the window's start for the last query row.
  const bool pad_rows = q0 + TC_BQ > length;

  uint32_t qf[HD / 16][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int r = warp * 16 + (lane & 15);
        const int ch = kk * 2 + (lane >> 4);
        ldsm_x4<false>(qf[kk], qs + r * HD + ((ch ^ (r & 7)) << 3));
      }
    }
    const int t0 = lo + i * TC_BK;
    const __nv_bfloat16* ks = kv_st + (i % TC_STAGES) * 2 * TC_BK * HD;
    const __nv_bfloat16* vs = ks + TC_BK * HD;

    // S = Q K^T: the warp's 16 rows x 64 keys, 8 tiles of 8 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        // Matrices (key tile 2jp, dims 0-7), (2jp, 8-15), (2jp+1, 0-7),
        // (2jp+1, 8-15) of this k-step.
        uint32_t r[4];
        const int key = (jp * 2 + (lq >> 1)) * 8 + l8;
        const int ch = kk * 2 + (lq & 1);
        ldsm_x4<false>(r, ks + key * HD + ((ch ^ l8) << 3));
        mma_16816(s[2 * jp], qf[kk], r[0], r[1]);
        mma_16816(s[2 * jp + 1], qf[kk], r[2], r[3]);
      }
    }

    const bool edge = t0 + TC_BK - 1 > q0 || t0 + TC_BK > len_k ||
                      pad_rows ||
                      (window > 0 && t0 <= q0 + TC_BQ - 1 - window);
    uint32_t vis = 0xffffffffu;                // bit 4j + e: pair visible
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = t0 + j * 8 + 2 * t + (e & 1);
          const int qpos = qrow[e >> 1];
          bool ok = kpos <= qpos && kpos < len_k && qpos < length;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) {
            x = NEG_INF;
            vis &= ~(1u << (4 * j + e));
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (4 * j + e)) & 1u
                            ? exp2f(s[j][e] - m_r[e >> 1]) : 0.0f;
        s[j][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P from the score accumulators, rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        // Matrices (keys 0-7, dim tile 2jp), (keys 8-15, 2jp),
        // (keys 0-7, 2jp+1), (keys 8-15, 2jp+1), transposed.
        uint32_t r[4];
        const int key = kk * 16 + (lq & 1) * 8 + l8;
        const int ch = jp * 2 + (lq >> 1);
        ldsm_x4<true>(r, vs + key * HD + ((ch ^ l8) << 3));
        mma_16816(o[2 * jp], a, r[0], r[1]);
        mma_16816(o[2 * jp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();                           // the stage is refilled next
  }
  cp_async_wait<0>();

  // Epilogue: the quad's row sums, then O / l (0 where l == 0).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = l_r[r] > 0.0f ? 1.0f / l_r[r] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= sq) continue;
    __nv_bfloat16* dst =
        out + ((size_t)b * sq + qrow[r]) * q_row + (size_t)head * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

template <int HD>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, int bsz, int sq, int sk,
                     int nheads, int n_kv, int window, float sm_scale,
                     cudaStream_t s) {
  const size_t smem = tc_smem_bytes<HD>();
  cudaFuncSetAttribute(flash_prefill_tc_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((sq + TC_BQ - 1) / TC_BQ, nheads, bsz);
  flash_prefill_tc_kernel<HD><<<grid, TC_THREADS, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)lengths, (__nv_bfloat16*)out, sq,
      sk, nheads, n_kv, window, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// bf16 (is_bf16 = 1) takes hd 64 or 128 on the tensor cores; fp32 takes
// hd <= 128, a multiple of 4, on the CUDA cores.
extern "C" int bd_flash_prefill(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int bsz,
                                int sq, int sk, int nheads, int n_kv, int hd,
                                int window, float sm_scale, int is_bf16,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (hd == 128)
      return launch_tc<128>(q, k, v, lengths, out, bsz, sq, sk, nheads, n_kv,
                            window, sm_scale, s);
    if (hd == 64)
      return launch_tc<64>(q, k, v, lengths, out, bsz, sq, sk, nheads, n_kv,
                           window, sm_scale, s);
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) *
      ((size_t)PF_BQ * hd + PF_TK * (hd + 1) + PF_TK * hd +
       PF_BQ * (PF_TK + 1) + 3 * PF_BQ);
  dim3 grid((sq + PF_BQ - 1) / PF_BQ, nheads, bsz);
  cudaFuncSetAttribute(flash_prefill_fp32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  flash_prefill_fp32_kernel<<<grid, PF_THREADS, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)lengths,
      (float*)out, sq, sk, nheads, n_kv, hd, window, sm_scale);
  return (int)cudaGetLastError();
}
