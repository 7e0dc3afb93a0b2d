// Hand-written Hopper kernels for the 1-bit delta GEMMs of the serving
// and training paths (plain C interface, loaded with ctypes by
// ops/binary_gemm.py).
//
//   bd_pair_delta      <- bitdelta_tpu/ops/pallas_binary_gemm.py
//                         ::tenant_delta_matmul_pair_pallas
//   bd_tenant_dense_tc <- ::tenant_dense_matmul_pallas (bf16)
//   bd_tenant_dense    <- the same, any other dtypes, K or N
//   bd_binary_matmul   <- ::binary_matmul_pallas
//   bd_binary_matmul_t <- ::binary_matmul_t_pallas
//   bd_canon_delta     <- ::tenant_delta_matmul_pallas
//   bd_fused_tenant_tc <- ::fused_tenant_matmul_pallas (bf16)
//   bd_fused_tenant    <- the same, fp32 x and W or any other N
//   bd_fused_base_pair_tc <- ::fused_base_pair_matmul_pallas (bf16)
//   bd_fused_base_pair    <- the same, fp32 x and W
//
// Every entry launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include <cooperative_groups.h>

#include "tensor_core.cuh"

extern "C" const char* bd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

// Two adjacent elements of W as they are loaded (bf16x2 or float2), so a
// word's whole column of W can be in flight before any of it is used.
template <typename T> struct Two;
template <> struct Two<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Two<__half> { using type = __half2; };
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

// ---------------------------------------------------------------------------
// 1. Pair-packed tenant delta at decode:
//    Y[b, n] = scale[ids[b]] * (x[b] @ sign(P[ids[b]]))[n]
//
// Bound on the H100: the packed words of the rows' distinct tenants (1 bit
// per weight) against 3.35 TB/s; a Mistral-7B projection with 3 tenants
// holds 1.5-22 MB of them (0.5-6.6 us). A call is two launches (one more
// for each further PAIR_SLAB rows) and nothing else, and the integer sums
// S = sum_k bit_k * xq_k are exact:
//
// pair_prep_kernel, a cluster of PAIR_PREP_BLOCKS blocks per row b: JAX's
// x grid (``_pair_quantize``). min and max in fp32, a NaN kept (that row's
// output is NaN, as the plain version's); step = max((max - min) / 4095,
// 1e-30) by IEEE division (a NaN step stays NaN); xq = rint((x - min) /
// step) (round half to even, as torch.round and jnp.round); sxq = sum xq
// in integers; a1 = alpha * step, a2 = alpha * min, alpha =
// scale[ids[b]]. Bit for bit what the plain version computes. xq goes out as its 12 bit planes: for each
// 32 K, twelve 32-bit words (word p holds plane p, bit i for K + i, from
// one warp ballot each, 48 bytes stored at once); K past the end is zero.
// The prep launches the main kernel as its programmatic dependent
// (griddepcontrol), so the main kernel's start, its tenant bookkeeping
// and its first word copies overlap the prep.
//
// pair_delta_tc_kernel, on the tensor cores' 1-bit MMA
// (mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc, 256 K a step):
// A (16 output columns x 256 K) is the sign bits themselves, B (256 K x
// 8) bit planes of x, D = popc(A & B) exact in s32. A row g of m-tile mt
// is the low column of the warp's pair column MT*g + mt, row g + 8 its
// high column; lane (g, t) holds K 32t .. 32t + 31 (a0, a1) and 128 +
// 32t .. (a2, a3), and a pair word holds 16 K of both columns, so one
// byte permute of two words makes each A register: a0 = prmt(w[2t],
// w[2t+1], 0x5410) (the low halves), a1 = prmt(.., 0x7632) (the high
// halves), a2 / a3 from words 8 + 2t and 9 + 2t. B's 8 columns are bit
// planes of the block's rows: in group r4 of 4 row slots, tile pp (0..5)
// column 2i + e is plane 2pp + e of slot 4*r4 + i, so lane t's
// accumulators hold planes of its own slot 4*r4 + t and
// S = sum_p 2^p * D_p is added up in registers with constant shifts.
// tests/test_torch_pair_numerics.py models the fragments and the
// arithmetic on the CPU.
//
// A launch takes a slab of up to PAIR_SLAB rows (a call launches one a
// slab, so any B). A block owns PAIR_BJ = 128 pair columns (256 outputs),
// up to pair_rows<MT>() rows of one tenant (the slab's d-th distinct
// tenant's q-th group of rows) and one of n_split K ranges of whole chunks;
// it multiplies that tenant's words against those rows only, so each
// active tenant's words are read once (once per group of rows where a
// tenant has more). n_split is the least power of two that gives the
// card PAIR_BLOCKS_PER_SM live blocks a multiprocessor. A
// PAIR_STAGES-deep cp.async ring of 16-byte copies, coalesced along the
// columns, brings each stage's words and bit planes into shared memory.
// The K splits of a (tile, z) form one thread block cluster: each block
// leaves its integer sums in its shared memory, and after a cluster
// barrier block q adds every block's sums (distributed shared memory,
// exact, in rank order) for its 256 / n_split columns and runs row 1's
// epilogue y = 2*a1*S + (a2*colsum - a1*sxq) with round-to-nearest ops,
// as the plain version, in natural column order. No global atomics, no
// zeroed scratch.
// ---------------------------------------------------------------------------

constexpr int PAIR_Q_LEVELS = 4095;
constexpr int PAIR_PLANES = 12;       // bits of the x grid
constexpr int PAIR_PREP_THREADS = 512;
constexpr int PAIR_PREP_BLOCKS = 8;   // a cluster of blocks a row
constexpr int PAIR_BJ = 128;          // pair-word columns a block
constexpr int PAIR_CHUNK = 256;       // K of one 1-bit MMA
constexpr int PAIR_KC = 2;            // chunks a ring stage
constexpr int PAIR_STAGES = 4;        // stages in the cp.async ring
constexpr int PAIR_XCHUNK = PAIR_PLANES * 32;     // x bytes a row and chunk
constexpr int PAIR_XSTRIDE = PAIR_KC * PAIR_XCHUNK + 64;  // a shared x slot
// A shared word row: 128 words and 16 bytes, so that lanes reading word
// rows 2t (t = 0..3) land in distinct banks.
constexpr int PAIR_WROW = PAIR_BJ * 4 + 16;
constexpr int PAIR_WORD_BYTES = PAIR_KC * 16 * PAIR_WROW;
constexpr int PAIR_SLAB = 64;        // rows a main-kernel launch takes
constexpr int PAIR_MAX_SPLITS = 8;    // a portable cluster
constexpr int PAIR_BLOCKS_PER_SM = 1; // live blocks the K split aims at
static_assert(PAIR_BJ == 128, "a tile is one 256-column pair group");
static_assert(512 / 4 >= PAIR_SLAB, "a block's threads cover a slab's ids");

// Rows a block takes with MT m-tiles a warp: 16 / MT (4, 8 or 16), in
// groups of 4 (6 n8 tiles of B each).
template <int MT>
__host__ __device__ constexpr int pair_rows() {
  return 16 / MT;
}

// A ring stage: the words, then pair_rows row slots of bit planes.
template <int MT>
__host__ __device__ constexpr int pair_stage_bytes() {
  return PAIR_WORD_BYTES + pair_rows<MT>() * PAIR_XSTRIDE;
}

__device__ __forceinline__ int load_id(const void* ids, int ids64, int i) {
  return ids64 ? static_cast<int>(static_cast<const long long*>(ids)[i])
               : static_cast<const int*>(ids)[i];
}

// The 32 values of K step c of a row, as fp32 (16-byte loads where the
// row is aligned).
template <typename T>
__device__ __forceinline__ void load_step(const T* __restrict__ xr, int c,
                                          bool vec, float (&v)[32]) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const uint4* p = reinterpret_cast<const uint4*>(xr + 32 * c);
#pragma unroll
    for (int q = 0; q < 32 / PER; ++q) {
      const uint4 w = __ldg(p + q);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int u = 0; u < PER; ++u) v[q * PER + u] = to_f32(e[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 32; ++u) v[u] = to_f32(xr[32 * c + u]);
  }
}

// The larger (smaller) of a and b, NaN if either is (torch.max / min
// and jnp.max / min keep a NaN; fmaxf and fminf drop it).
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Row b's grid, bit planes and coefficients, by a cluster of
// PAIR_PREP_BLOCKS blocks that each take a range of its 32-K steps: their
// min, max and sum of xq meet through distributed shared memory (exact
// in any order: the sums are integers), and the cluster's first block
// writes the coefficients. The second pass reads the block's range of x
// again (from L2: the first pass has just read it). The main kernel is
// launched as its programmatic dependent: it may start at once, and
// waits for this grid's results only where it reads them.
template <typename T>
__global__ void __launch_bounds__(PAIR_PREP_THREADS)
pair_prep_kernel(const T* __restrict__ x, int x_stride, int x_vec,
                 const float* __restrict__ scales,
                 const void* __restrict__ ids, int ids64,
                 uint32_t* __restrict__ planes, float* __restrict__ coef,
                 int bsz, int k, int n_chunks) {
  namespace cg = cooperative_groups;
  constexpr int NW = PAIR_PREP_THREADS / 32;
  __shared__ float red_lo[NW], red_hi[NW];
  __shared__ int red_sum[NW];
  __shared__ float blk_lo, blk_hi;
  __shared__ int blk_sum;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / PAIR_PREP_BLOCKS;
  const int part = blockIdx.x % PAIR_PREP_BLOCKS;   // the cluster rank
  const T* xr = x + (size_t)b * x_stride;
  // This block's 32-K steps (the padded tail past k included).
  const int n_steps = n_chunks * 8;
  const int j0 = part * n_steps / PAIR_PREP_BLOCKS;
  const int j1 = (part + 1) * n_steps / PAIR_PREP_BLOCKS;

  float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);
  const int full = k / 32;                       // whole 32-K steps
  for (int j = j0 + tid; j < j1 && j < full; j += PAIR_PREP_THREADS) {
    float v[32];
    load_step(xr, j, x_vec, v);
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      lo = fmin_nan(lo, v[u]);
      hi = fmax_nan(hi, v[u]);
    }
  }
  // A K that is a multiple of 16 only (row 10): the 16 values past the
  // last whole step, one a thread of the block that owns that step.
  if (full >= j0 && full < j1 && tid < k - 32 * full) {
    const float v = to_f32(xr[32 * full + tid]);
    lo = fmin_nan(lo, v);
    hi = fmax_nan(hi, v);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = fmin_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmax_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    red_lo[warp] = lo;
    red_hi[warp] = hi;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      lo = fmin_nan(lo, red_lo[w]);
      hi = fmax_nan(hi, red_hi[w]);
    }
    blk_lo = lo;
    blk_hi = hi;
    blk_sum = 0;
  }
  cluster.sync();
  float los[PAIR_PREP_BLOCKS], his[PAIR_PREP_BLOCKS];
#pragma unroll
  for (int r = 0; r < PAIR_PREP_BLOCKS; ++r) {
    los[r] = *cluster.map_shared_rank(&blk_lo, r);
    his[r] = *cluster.map_shared_rank(&blk_hi, r);
  }
  lo = los[0];
  hi = his[0];
#pragma unroll
  for (int r = 1; r < PAIR_PREP_BLOCKS; ++r) {
    lo = fmin_nan(lo, los[r]);
    hi = fmax_nan(hi, his[r]);
  }
  float step = __fdiv_rn(__fsub_rn(hi, lo), (float)PAIR_Q_LEVELS);
  step = step < 1e-30f ? 1e-30f : step;          // clamp(min=1e-30)

  // 32 K a warp at a time, one value a lane; plane p of them is a ballot.
  int sum = 0;
  uint32_t* row = planes + (size_t)b * n_chunks * PAIR_XCHUNK / 4;
  for (int j = j0 + warp; j < j1; j += NW) {
    const int kk = 32 * j + lane;
    int q = 0;
    if (kk < k) {
      q = __float2int_rn(__fdiv_rn(__fsub_rn(to_f32(xr[kk]), lo), step));
    }
    sum += q;
    uint32_t w[PAIR_PLANES];
#pragma unroll
    for (int p = 0; p < PAIR_PLANES; ++p)
      w[p] = __ballot_sync(0xffffffffu, (q >> p) & 1);
    if (lane == 0) {
      uint4* dst = reinterpret_cast<uint4*>(row + (size_t)j * PAIR_PLANES);
#pragma unroll
      for (int p = 0; p < PAIR_PLANES; p += 4)
        dst[p / 4] = make_uint4(w[p], w[p + 1], w[p + 2], w[p + 3]);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red_sum[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) total += red_sum[w];
    atomicAdd(cluster.map_shared_rank(&blk_sum, 0), total);
  }
  cluster.sync();                      // every block's sum has landed
  if (part == 0 && tid == 0) {
    const float alpha = scales[load_id(ids, ids64, b)];
    coef[b] = __fmul_rn(alpha, step);                 // a1
    coef[bsz + b] = __fmul_rn(alpha, lo);             // a2
    coef[2 * bsz + b] = __int2float_rn(blk_sum);      // sxq
  }
}

// The current device and its multiprocessors (cached a device).
static cudaError_t current_device(int* dev, int* sms) {
  static std::atomic<int> cache[64];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 64 && (*sms = cache[*dev].load()) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < 64) cache[*dev].store(*sms);
  return err;
}

// fn's attribute attr set to value, once a device (bit dev of done marks
// it set).
static cudaError_t func_attr_once(const void* fn, cudaFuncAttribute attr,
                                  int value, int dev,
                                  std::atomic<unsigned long long>& done) {
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(fn, attr, value);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// fn's dynamic shared memory limit set to bytes, once a device.
static cudaError_t smem_limit_once(const void* fn, int bytes, int dev,
                                   std::atomic<unsigned long long>& done) {
  return func_attr_once(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                        bytes, dev, done);
}

template <typename T>
static cudaError_t launch_pair_prep(const void* x, int x_stride, int vec,
                                    const void* scales, const void* ids,
                                    int ids64, uint8_t* planes, float* coef,
                                    int bsz, int k, int n_chunks,
                                    cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(PAIR_PREP_BLOCKS * bsz);
  cfg.blockDim = dim3(PAIR_PREP_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PAIR_PREP_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scales);
  uint32_t* pl = reinterpret_cast<uint32_t*>(planes);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pair_prep_kernel<T>, xt, x_stride, vec, sc, ids, ids64, pl,
      coef, bsz, k, n_chunks);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// d += popc(a & b): a 16x256 bits (row), b 256x8 bits (col), s32 sums.
__device__ __forceinline__ void bmma_16_8_256(int (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

// The lane's MT adjacent pair words at shared address a.
template <int MT>
__device__ __forceinline__ void lds_words(uint32_t (&w)[MT], uint32_t a) {
  if constexpr (MT == 4) {
    const uint4 v = lds128(a);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (MT == 2) {
    const uint2 v = lds64(a);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = lds32(a);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

// Copy the words of chunks ch .. ch + nch - 1 into a ring stage; word rows
// past k16 (a K that is not a multiple of 256) are zero.
__device__ __forceinline__ void pair_load_words(
    uint8_t* st, const uint32_t* __restrict__ words, int ch, int nch,
    int k16, int n2, int tid, int threads) {
  constexpr int WCH = PAIR_BJ / 4;             // 16-byte chunks a word row
  for (int i = tid; i < 16 * nch * WCH; i += threads) {
    const int r = i / WCH, c = i % WCH;
    const int kw = 16 * ch + r;
    const bool ok = kw < k16;
    cp_async16(st + r * PAIR_WROW + 16 * c,
               words + (ok ? (size_t)kw * n2 + 4 * c : 0), ok);
  }
}

// Copy the bit planes of the same chunks for the block's rows (slot i
// holds row rows[i]; slots past n_rows are zero) into the stage.
template <int MT>
__device__ __forceinline__ void pair_load_x(
    uint8_t* st, const uint8_t* __restrict__ planes, const int* rows,
    int n_rows, int ch, int nch, int n_chunks, int tid, int threads) {
  uint8_t* xs = st + PAIR_WORD_BYTES;
  const int xch = nch * PAIR_XCHUNK / 16;      // 16-byte copies a slot
  for (int i = tid; i < pair_rows<MT>() * xch; i += threads) {
    const int r = i / xch, c = i % xch;
    const bool ok = r < n_rows;
    cp_async16(xs + r * PAIR_XSTRIDE + 16 * c,
               planes + (ok ? ((size_t)rows[r] * n_chunks + ch)
                              * PAIR_XCHUNK + 16 * c : 0),
               ok);
  }
}

// The ring over the block's chunks with G groups of 4 row slots in use,
// then the warp's sums into part[i][c] (row slot i, c = h*128 + jj). The
// accumulators of tile (r4, pp) hold, in lane t, planes 2pp (c0, c2) and
// 2pp + 1 (c1, c3) of slot 4*r4 + t for the low (c0, c1) and high (c2,
// c3) column: S = sum over pp of D << 2pp + D' << (2pp + 1).
template <int MT, int G>
__device__ __forceinline__ void pair_block_sums(
    uint8_t* smem, const uint8_t* __restrict__ planes,
    const uint32_t* __restrict__ words, const int* rows, int n_rows,
    int ch0, int ch1, int n_chunks, int k16, int n2) {
  constexpr int THREADS = 512 / MT;
  constexpr int STAGE = pair_stage_bytes<MT>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wcol = warp * 8 * MT + MT * g;     // the lane's first column
  // B of tile (r4, pp), lane g: slot 4*r4 + g/2, plane 2pp + g%2 of the
  // chunk's 32-K words t (b0) and t + 4 (b1).
  const int xoff = (g / 2) * PAIR_XSTRIDE + (g % 2) * 4
                   + tq * PAIR_PLANES * 4;
  const uint32_t smem_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n_st = (ch1 - ch0 + PAIR_KC - 1) / PAIR_KC;

  int acc[MT][6 * G][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 6 * G; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<PAIR_STAGES - 2>();          // stage s has landed
    __syncthreads();                           // and stage s - 1 is read
    {
      const int nx = s + PAIR_STAGES - 1;
      if (nx < n_st) {
        const int ch = ch0 + nx * PAIR_KC;
        uint8_t* st = smem + (nx % PAIR_STAGES) * STAGE;
        pair_load_words(st, words, ch, min(PAIR_KC, ch1 - ch), k16, n2,
                        tid, THREADS);
        pair_load_x<MT>(st, planes, rows, n_rows, ch,
                        min(PAIR_KC, ch1 - ch), n_chunks, tid, THREADS);
      }
      cp_async_commit();
    }
    const uint32_t st = smem_s + (s % PAIR_STAGES) * STAGE;
    const int nch = min(PAIR_KC, ch1 - (ch0 + s * PAIR_KC));
#pragma unroll
    for (int cc = 0; cc < PAIR_KC; ++cc) {
      if (cc >= nch) break;
      // Word rows 2t, 2t + 1, 8 + 2t, 9 + 2t of the chunk.
      const uint32_t ws = st + (cc * 16 + 2 * tq) * PAIR_WROW + 4 * wcol;
      uint32_t w[4][MT];
      lds_words<MT>(w[0], ws);
      lds_words<MT>(w[1], ws + PAIR_WROW);
      lds_words<MT>(w[2], ws + 8 * PAIR_WROW);
      lds_words<MT>(w[3], ws + 9 * PAIR_WROW);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = __byte_perm(w[0][mt], w[1][mt], 0x5410);
        a[mt][1] = __byte_perm(w[0][mt], w[1][mt], 0x7632);
        a[mt][2] = __byte_perm(w[2][mt], w[3][mt], 0x5410);
        a[mt][3] = __byte_perm(w[2][mt], w[3][mt], 0x7632);
      }
      const uint32_t xs =
          st + PAIR_WORD_BYTES + xoff + cc * PAIR_XCHUNK;
#pragma unroll
      for (int r4 = 0; r4 < G; ++r4)
#pragma unroll
        for (int pp = 0; pp < 6; ++pp) {
          const uint32_t xa = xs + r4 * 4 * PAIR_XSTRIDE + pp * 8;
          const uint32_t b0 = lds32(xa);
          const uint32_t b1 = lds32(xa + 4 * PAIR_PLANES * 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            bmma_16_8_256(acc[mt][r4 * 6 + pp], a[mt], b0, b1);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is free

  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int jj = wcol + mt;
#pragma unroll
    for (int r4 = 0; r4 < G; ++r4) {
      const int i = 4 * r4 + tq;
      if (i >= n_rows) continue;
      int s_lo = 0, s_hi = 0;
#pragma unroll
      for (int pp = 0; pp < 6; ++pp) {
        const int* d = acc[mt][r4 * 6 + pp];
        s_lo += (d[0] << (2 * pp)) + (d[1] << (2 * pp + 1));
        s_hi += (d[2] << (2 * pp)) + (d[3] << (2 * pp + 1));
      }
      part[i * 256 + jj] = s_lo;
      part[i * 256 + 128 + jj] = s_hi;
    }
  }
}

// pair_block_sums with G the least power of two >= g4 (row slots past the
// block's rows hold zeros).
template <int MT, int G = 1>
__device__ __forceinline__ void pair_block_dispatch(
    int g4, uint8_t* smem, const uint8_t* __restrict__ planes,
    const uint32_t* __restrict__ words, const int* rows, int n_rows,
    int ch0, int ch1, int n_chunks, int k16, int n2) {
  if constexpr (4 * G < pair_rows<MT>()) {
    if (g4 > G) {
      pair_block_dispatch<MT, 2 * G>(g4, smem, planes, words, rows, n_rows,
                                     ch0, ch1, n_chunks, k16, n2);
      return;
    }
  }
  pair_block_sums<MT, G>(smem, planes, words, rows, n_rows, ch0, ch1,
                         n_chunks, k16, n2);
}

// Block (tile, split, z): z = d + n_d * q, the d-th distinct tenant (in
// order of first occurrence) and its q-th group of pair_rows rows.
// 512 threads an SM at the least: at most 128 registers a thread.
template <int MT>
__global__ void __launch_bounds__(512 / MT, MT)
pair_delta_tc_kernel(const uint8_t* __restrict__ planes,
                     const uint32_t* __restrict__ pairs,
                     const void* __restrict__ ids, int ids64,
                     const float* __restrict__ coef,
                     const float* __restrict__ colsum,
                     float* __restrict__ out, int bsz, int row0, int slab,
                     int k, int n2, int n_d) {
  namespace cg = cooperative_groups;
  constexpr int THREADS = 512 / MT;
  constexpr int STAGE = pair_stage_bytes<MT>();
  constexpr int ROWS = pair_rows<MT>();
  extern __shared__ __align__(16) uint8_t smem_pair[];
  __shared__ int sid[PAIR_SLAB], rows[ROWS];
  __shared__ unsigned mask[PAIR_SLAB / 32];
  __shared__ float sa1[ROWS], sa2[ROWS], ssxq[ROWS];
  __shared__ float scs[256];
  __shared__ int s_tenant, s_rows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int d = blockIdx.z % n_d, q = blockIdx.z / n_d;
  const int n_split = gridDim.y;
  const int n = 2 * n2, k16 = (k + 15) / 16;
  const int n_chunks = (k + PAIR_CHUNK - 1) / PAIR_CHUNK;
  const int slice = 256 / n_split;             // this block's outputs
  const int c0 = split * slice;

  // The slab's d-th distinct tenant and its rows (rows[] holds them as
  // rows of the batch).
  if (tid < slab) sid[tid] = load_id(ids, ids64, row0 + tid);
  __syncthreads();
  bool first = tid < slab;
  for (int j = 0; first && j < tid; ++j) first = sid[j] != sid[tid];
  if (warp < PAIR_SLAB / 32) {
    const unsigned m = __ballot_sync(0xffffffffu, first);
    if (lane == 0) mask[warp] = m;
  }
  if (tid == 0) s_tenant = -1;
  __syncthreads();
  if (first) {
    int rank = __popc(mask[warp] & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += __popc(mask[w]);
    if (rank == d) s_tenant = sid[tid];
  }
  __syncthreads();
  const int t = s_tenant;
  if (t < 0) return;                           // the whole cluster
  const bool mine = tid < slab && sid[tid] == t;
  if (warp < PAIR_SLAB / 32) {
    const unsigned m = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) mask[warp] = m;
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int w = 0; w < PAIR_SLAB / 32; ++w) count += __popc(mask[w]);
  const int n_rows = min(ROWS, count - q * ROWS);
  if (n_rows <= 0) return;                     // the whole cluster
  if (mine) {
    int rank = __popc(mask[warp] & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += __popc(mask[w]);
    rank -= q * ROWS;
    if (rank >= 0 && rank < ROWS) rows[rank] = row0 + tid;
  }

  // The words need nothing of the prep: their first stages go out before
  // the wait for its grid; x, the coefficients and colsum after it.
  const int ch0 = (int)((long long)split * n_chunks / n_split);
  const int ch1 = (int)((long long)(split + 1) * n_chunks / n_split);
  const int n_st = (ch1 - ch0 + PAIR_KC - 1) / PAIR_KC;
  const uint32_t* words =
      pairs + (size_t)t * k16 * n2 + (size_t)tile * PAIR_BJ;
#pragma unroll
  for (int s = 0; s < PAIR_STAGES - 1; ++s)
    if (s < n_st) {
      const int ch = ch0 + s * PAIR_KC;
      pair_load_words(smem_pair + s * STAGE, words, ch,
                      min(PAIR_KC, ch1 - ch), k16, n2, tid, THREADS);
    }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();                             // rows are set
  for (int i = tid; i < n_rows; i += THREADS) {
    const int r = rows[i];
    cp_async4(sa1 + i, coef + r);
    cp_async4(sa2 + i, coef + bsz + r);
    cp_async4(ssxq + i, coef + 2 * bsz + r);
  }
  for (int c = tid; c < slice; c += THREADS)
    cp_async4(scs + c, colsum + (size_t)t * n + tile * 256 + c0 + c);
#pragma unroll
  for (int s = 0; s < PAIR_STAGES - 1; ++s) {
    if (s < n_st) {
      const int ch = ch0 + s * PAIR_KC;
      pair_load_x<MT>(smem_pair + s * STAGE, planes, rows, n_rows, ch,
                      min(PAIR_KC, ch1 - ch), n_chunks, tid, THREADS);
    }
    cp_async_commit();                         // group 0 holds them all
  }

  pair_block_dispatch<MT>((n_rows + 3) / 4, smem_pair, planes, words, rows,
                          n_rows, ch0, ch1, n_chunks, k16, n2);
  int* part = reinterpret_cast<int*>(smem_pair);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int* remote[PAIR_MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < PAIR_MAX_SPLITS; ++r)
    remote[r] = cluster.map_shared_rank(part, r < n_split ? r : 0);
  // Four outputs a thread at a time, their remote loads issued together.
  constexpr int EU = 4;
  for (int it0 = tid; it0 < n_rows * slice; it0 += EU * THREADS) {
    int sum[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int it = min(it0 + u * THREADS, n_rows * slice - 1);
      const int i = it / slice, c = it % slice;
      int v[PAIR_MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < PAIR_MAX_SPLITS; ++r)
        v[r] = r < n_split ? remote[r][i * 256 + c0 + c] : 0;
      sum[u] = 0;
#pragma unroll
      for (int r = 0; r < PAIR_MAX_SPLITS; ++r) sum[u] += v[r];
    }
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int it = it0 + u * THREADS;
      if (it >= n_rows * slice) break;
      const int i = it / slice, c = it % slice;
      const float two_a1 = __fmul_rn(2.0f, sa1[i]);
      const float off = __fmul_rn(sa1[i], ssxq[i]);
      out[(size_t)rows[i] * n + tile * 256 + c0 + c] =
          __fadd_rn(__fmul_rn(two_a1, static_cast<float>(sum[u])),
                    __fsub_rn(__fmul_rn(sa2[i], scs[c]), off));
    }
  }
  cluster.sync();                              // the sums stay until read
}

// K ranges a column tile (one cluster): the least power of two that gives
// the card PAIR_BLOCKS_PER_SM live blocks a multiprocessor, at most
// PAIR_MAX_SPLITS and the chunks.
static int pair_splits(int live, int n_chunks, int sms) {
  const int cap = n_chunks < PAIR_MAX_SPLITS ? n_chunks : PAIR_MAX_SPLITS;
  int splits = 1;
  while (splits * live < PAIR_BLOCKS_PER_SM * sms && splits * 2 <= cap)
    splits *= 2;
  return splits;
}

// The main kernel over rows row0 .. row0 + slab - 1 (t tenants).
template <int MT>
static cudaError_t launch_pair_tc(const uint8_t* planes, const void* pairs,
                                  const void* ids, int ids64,
                                  const float* coef, const void* colsum,
                                  void* out, int bsz, int row0, int slab,
                                  int k, int n2, int t, int dev, int sms,
                                  cudaStream_t s) {
  static std::atomic<unsigned long long> limit_set{0};
  constexpr int smem = pair_stage_bytes<MT>() * PAIR_STAGES;
  static_assert(smem >= pair_rows<MT>() * 256 * 4,
                "the sums of the block's rows fit in the ring");
  cudaError_t err = smem_limit_once((const void*)pair_delta_tc_kernel<MT>,
                                    smem, dev, limit_set);
  if (err != cudaSuccess) return err;
  const int n_d = slab < t ? slab : t;      // distinct tenants, at most
  const int groups = (slab + pair_rows<MT>() - 1) / pair_rows<MT>();
  const int n_split = pair_splits(n_d * (n2 / PAIR_BJ),
                                  (k + PAIR_CHUNK - 1) / PAIR_CHUNK, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n2 / PAIR_BJ, n_split, n_d * groups);
  cfg.blockDim = dim3(512 / MT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, pair_delta_tc_kernel<MT>, planes,
                           (const uint32_t*)pairs, ids, ids64, coef,
                           (const float*)colsum, (float*)out, bsz, row0,
                           slab, k, n2, n_d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Bytes of scratch a call takes (the wrapper allocates them): x's bit
// planes (ceil(k / 256) * 384 a row), then (a1, a2, sxq) of every row.
extern "C" long long bd_pair_delta_scratch_bytes(int bsz, int k) {
  return (long long)bsz * ((k + PAIR_CHUNK - 1) / PAIR_CHUNK) * PAIR_XCHUNK
         + 3LL * bsz * 4;
}

// buf: bd_pair_delta_scratch_bytes(bsz, k) bytes; t: tenants in the stack.
// The prep, then the main kernel once a slab of PAIR_SLAB rows: each slab
// after the first waits for the one before (a programmatic dependent that
// nothing triggers early), so the prep has ended before any slab reads.
extern "C" int bd_pair_delta(const void* x, int x_stride, int x_bf16,
                             const void* pairs, const void* colsum,
                             const void* scales, const void* ids, int ids64,
                             void* buf, void* out, int bsz, int k, int n2,
                             int t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = (k + PAIR_CHUNK - 1) / PAIR_CHUNK;
  if (bsz < 1 || k < 32 || k % 32 != 0 || n2 < PAIR_BJ || n2 % PAIR_BJ != 0
      || t < 1 || ((uintptr_t)pairs % 16) != 0 || ((uintptr_t)buf % 16) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  uint8_t* planes = static_cast<uint8_t*>(buf);
  float* coef = reinterpret_cast<float*>(planes + (size_t)bsz * n_chunks
                                                  * PAIR_XCHUNK);
  const int esize = x_bf16 ? 2 : 4;
  const int vec = ((uintptr_t)x % 16) == 0
                  && ((size_t)x_stride * esize) % 16 == 0;
  err = x_bf16 ? launch_pair_prep<__nv_bfloat16>(x, x_stride, vec, scales,
                                                 ids, ids64, planes, coef,
                                                 bsz, k, n_chunks, s)
               : launch_pair_prep<float>(x, x_stride, vec, scales, ids,
                                         ids64, planes, coef, bsz, k,
                                         n_chunks, s);
  // MT m-tiles a warp: a block holds 16 / MT rows of one tenant.
  for (int row0 = 0; row0 < bsz && err == cudaSuccess; row0 += PAIR_SLAB) {
    const int slab = bsz - row0 < PAIR_SLAB ? bsz - row0 : PAIR_SLAB;
    if (slab <= 4)
      err = launch_pair_tc<4>(planes, pairs, ids, ids64, coef, colsum, out,
                              bsz, row0, slab, k, n2, t, dev, sms, s);
    else if (slab <= 8)
      err = launch_pair_tc<2>(planes, pairs, ids, ids64, coef, colsum, out,
                              bsz, row0, slab, k, n2, t, dev, sms, s);
    else
      err = launch_pair_tc<1>(planes, pairs, ids, ids64, coef, colsum, out,
                              bsz, row0, slab, k, n2, t, dev, sms, s);
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// 3. Tenant-routed dense matmul (the per-tenant lm_head at decode):
//    Y[b] = x[b] @ W[ids[b]],  x (B, K), W (T, K, N), fp32 out
//    <- bitdelta_tpu/ops/pallas_binary_gemm.py:845
//       tenant_dense_matmul_pallas (products and sums in fp32).
//
// Bound on the H100: bytes. The distinct tenants' (K, N) heads are read
// once each, plus x and the fp32 output: at B = 8 over 3 tenants, K =
// 4096, N = 32000 (Mistral-7B's head) 786 MB, 0.235 ms at 3.35 TB/s; the
// products (2BKN) are 1/600 of the tensor cores' time for them.
//
// bf16 x and W, K and N multiples of 8 (JAX's own limit): one kernel,
// tenant_dense_tc_kernel (after row 10's section: it shares its TMA and
// mbarrier helpers), one launch for each DN_SLAB rows.
// * A work unit is one distinct tenant (rank d, order of first
//   occurrence among the slab's ids) and up to NT * 8 of its rows (chunk
//   c, in row order). A block owns one unit and DN_COLS columns (grid
//   x, the units of a tile side by side; a block whose unit does not
//   exist exits) and one K split (grid y). Its n8 side holds that
//   tenant's rows only, so no masking is needed, and each output row
//   belongs to one unit. A tenant's head is read once for each NT * 8 of
//   its rows (32 at B > 16): at B = 8 once; at B = 128 on one tenant
//   four times, by neighbouring blocks that run together and share the
//   tiles in L2 (units of 64 rows, DN_MAX_NT = 8, were no faster at B =
//   64 with 40 rows on one tenant: the second read comes from L2).
// * W is the A operand of mma.sync.m16n8k16 (bf16, fp32 sums), taken
//   from shared memory by ldmatrix.trans (W is (K, N) row-major: a shared
//   row is one K at the block's 64 columns, stored with the 128-byte
//   swizzle, read free of bank conflicts); the unit's x rows are the n8
//   side, by ldmatrix. A warp owns 16 columns (one m16 tile).
// * W arrives by TMA through a 3-D tensor map over the stack (N, K, T),
//   box {64, DN_KS, 1} at {c0, k0, t}: rows past K and columns past N of
//   tenant t read as zeros (a 2-D map over (T K, N) would read tenant
//   t + 1's rows there). One thread issues each stage's boxes onto the
//   stage's mbarrier in a DN_STAGES-deep ring; x arrives by 16-byte
//   cp.async, K past the end zero.
// * The tensor cores truncate as they accumulate, so each DN_KS-deep
//   stage sums into a fresh fp32 accumulator that is then added to the
//   running sum (as rows 5, 6, 8 and 10 do).
// * Filling the card: where the units' tiles do not fill it, the K
//   splits of a tile form one thread block cluster and add their fp32
//   partials through distributed shared memory in rank order (no
//   atomics: the result does not depend on scheduling). No scratch and
//   no second launch. scripts/sweep_tenant_dense.py sizes the ring, the
//   stage depth and the split aim (PERF.md).
//
// Every other dtype pair (bf16, fp16 or fp32 x, W of any of those), a K
// or N not a multiple of 8 takes tenant_dense_kernel on the CUDA cores: each block owns 256
// columns (two adjacent per thread), up to DENSE_ROWS rows and one of
// `splits` K ranges, walks each distinct tenant among its rows once,
// widens x and W to fp32 (as the TPU kernel does) and sums in fp32; the
// K ranges' partials go to a (splits, B, N) scratch and sum_splits_kernel
// adds them in split order.
// ---------------------------------------------------------------------------

constexpr int DENSE_THREADS = 128;
constexpr int DENSE_ROWS = 16;
constexpr int DENSE_TK = 128;

template <typename TX, typename TW>
__global__ void tenant_dense_kernel(const TX* __restrict__ x,
                                    const TW* __restrict__ w,
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
    const TW* wt = w + (size_t)t * k * n;
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
        const typename Two<TW>::type pr =
            load_two(wt + (size_t)(k0 + kk) * n + c0, vec, c0 + 1 < n);
        const float w0 = to_f32(pr.x), w1 = to_f32(pr.y);
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

template <typename TX, typename TW>
static cudaError_t launch_tenant_dense(const void* x, const void* w,
                                       const void* ids, void* partial,
                                       int bsz, int k, int n, int splits,
                                       cudaStream_t s) {
  const int k_per_split = (k + splits - 1) / splits;
  dim3 grid((n + 2 * DENSE_THREADS - 1) / (2 * DENSE_THREADS),
            (bsz + DENSE_ROWS - 1) / DENSE_ROWS, splits);
  tenant_dense_kernel<TX, TW><<<grid, DENSE_THREADS, 0, s>>>(
      (const TX*)x, (const TW*)w, (const int*)ids, (float*)partial, bsz, k,
      n, k_per_split);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t launch_tenant_dense_w(int w_type, const void* x,
                                         const void* w, const void* ids,
                                         void* partial, int bsz, int k,
                                         int n, int splits, cudaStream_t s) {
  switch (w_type) {
    case 0: return launch_tenant_dense<TX, float>(x, w, ids, partial, bsz,
                                                  k, n, splits, s);
    case 1: return launch_tenant_dense<TX, __nv_bfloat16>(
        x, w, ids, partial, bsz, k, n, splits, s);
    case 2: return launch_tenant_dense<TX, __half>(x, w, ids, partial, bsz,
                                                   k, n, splits, s);
  }
  return cudaErrorInvalidValue;
}

// x (bsz, k) and W (t, k, n) each fp32 (type 0), bf16 (1) or fp16 (2),
// ids (bsz,) int32; partial (splits, bsz, n) and out (bsz, n) fp32.
extern "C" int bd_tenant_dense(const void* x, const void* w, const void* ids,
                               void* partial, void* out, int bsz, int k,
                               int n, int splits, int x_type, int w_type,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (x_type) {
    case 0: err = launch_tenant_dense_w<float>(w_type, x, w, ids, partial,
                                               bsz, k, n, splits, s); break;
    case 1: err = launch_tenant_dense_w<__nv_bfloat16>(
        w_type, x, w, ids, partial, bsz, k, n, splits, s); break;
    case 2: err = launch_tenant_dense_w<__half>(w_type, x, w, ids, partial,
                                                bsz, k, n, splits, s); break;
    default: err = cudaErrorInvalidValue;
  }
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
//              * xscale
//    <- bitdelta_tpu/ops/pallas_binary_gemm.py:254 tenant_delta_matmul_pallas.
//    P[ids[b]] (K/32, N) int32, LSB first along K; xq = rint(x / xscale) on
//    ONE grid for the whole (B, K) input, xscale = max(max|x|, 1e-30) / 2^14,
//    so |xq| <= 2^14.
//
// Bound on the H100: the words of the distinct matrices the ids touch (1 bit
// a weight) against 3.35 TB/s; a Mixtral-8x7B decode layer's seven call
// sites read about 234 MB of them (0.07 ms). A call is two launches (one
// more for each further CANON_SLAB rows) and nothing else, and the sums are
// exact integers:
//
// canon_prep_kernel, ONE cluster of CANON_PREP_BLOCKS blocks over the whole
// input: the grid is global, so no row can be quantized before the max over
// all of them, which the blocks meet through distributed shared memory.
// Each warp takes a range of (row, 256-K chunk) items. Pass 1: max |x| in
// fp32, a NaN kept (a warp's first CANON_PREP_CACHE items stay in
// registers). Then xscale = max(xmax, 1e-30) / 2^14 and xq = rint(x /
// xscale), both by IEEE division, round half to even (bit for bit what
// _canonical_quantize computes). Pass 2 writes xq as 16 two's-complement
// bit planes: two 32-K groups at a time, each lane's pair of 16-bit xq
// goes through one 32 x 32 bit transpose across the warp (five shuffle
// stages), after which lane l holds plane l % 16 of one of the groups
// (about a third of the instructions of one ballot a plane and group, and
// measured faster).
// A chunk's 128 plane words are plane-major, and within plane p the words
// of 32-K groups t and t + 4 sit side by side (group j at word 8p + 2 (j
// % 4) + j / 4), so the main kernel's lane t reads its b0 and b1 of a plane
// in one 8-byte load. Each warp adds its rows' sums of xq to the row's
// owner block by distributed shared-memory atomics (int64, exact in any
// order); the owners write sxq, block 0 xscale. The cluster has 16 blocks
// (non-portable; the prep ran longer with 8, sweep_canonical_delta.py).
// The prep
// launches the main kernel as its programmatic dependent (griddepcontrol),
// so the main kernel's bookkeeping and first word copies overlap it.
//
// canon_delta_tc_kernel, on the 1-bit MMA (m16n8k256 .and.popc). In the
// canonical layout a word holds 32 consecutive K of one column, LSB first,
// which is what lane (g, t) of the A fragment holds: for 256-K chunk c and
// an m-tile whose rows g, g + 8 are columns c_g, c_g8, a0 = P[8c + t][c_g],
// a1 = P[8c + t][c_g8], a2 / a3 the same at word row 8c + 4 + t; no
// permutes. B holds the planes of one row: n8 tile h, column n is plane 8h
// + n, so a row costs two MMAs a 16 x 256 tile and a unit of rows needs no
// masks. Lane (g, t)'s accumulators of tile h hold planes 8h + 2t and 8h +
// 2t + 1; S = sum_p w_p D_p (w_p = 2^p, w_15 = -2^15) is formed in int64
// after the loop and added across the quad by shuffles.
//
// A block owns CANON_BN columns (MT m-tiles a warp: m-tile mt's row g is
// the warp's column MT*g + mt, row g + 8 its column 8MT + MT*g + mt, so a
// lane's words of the MT m-tiles are adjacent), one of n_split K
// ranges of whole chunks, and a unit: the slab's d-th distinct id (by first
// occurrence) and its q-th group of up to 4 or 8 rows, so each
// distinct matrix's words are read once per group of rows. A CANON_STAGES
// deep cp.async ring brings each stage's words (16-byte copies where N % 4
// == 0, else 4-byte ones; zeros past K and N) and the unit's planes into
// shared memory; a word row is padded to 544 bytes (32 mod 128), so the
// four lanes t reading word rows 8c + t hit distinct banks. The K splits
// of a (tile, unit) form one cluster: each block leaves its int64 sums in
// shared memory, and after a cluster barrier block q adds every block's
// sums in rank order for its CANON_BN / n_split columns and runs y =
// (alpha * float(2 S - sxq)) * xscale with round-to-nearest ops, the plain
// version's order. No global atomics, no zeroed scratch.
// tests/test_torch_canonical_numerics.py models the fragments, the prep and
// the arithmetic on the CPU.
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int CANON_PLANES = 16;            // two's-complement planes of xq
constexpr int CANON_CHUNK = 256;            // K of one 1-bit MMA
constexpr int CANON_XCHUNK = CANON_PLANES * 32;   // plane bytes a row, chunk
constexpr int CANON_PREP_BLOCKS = 16;       // the prep's one cluster
constexpr int CANON_PREP_THREADS = 512;
constexpr int CANON_PREP_CACHE = 4;         // a warp's items in registers
constexpr int CANON_PREP_SMEM = 200 * 1024; // row sums: bsz <= 16 * 25600
constexpr int CANON_BN = 128;               // output columns a block
constexpr int CANON_KC = 2;                 // chunks a ring stage
constexpr int CANON_STAGES = 4;             // stages in the cp.async ring
constexpr int CANON_WROW = CANON_BN * 4 + 32;     // a shared word row
constexpr int CANON_WCHUNK = 8 * CANON_WROW;      // a chunk's 8 word rows
constexpr int CANON_XSLOT = CANON_KC * CANON_XCHUNK;  // a row slot's planes
constexpr int CANON_SLAB = 64;              // rows a main-kernel launch takes
constexpr int CANON_MAX_SPLITS = 8;         // a portable cluster
constexpr int CANON_BLOCKS_PER_SM = 1;      // live blocks the K split aims at
constexpr int CANON_SMALL_SLAB = 4;         // slabs up to it: <2, 4>
constexpr int CANON_LARGE_SLAB = 16;        // slabs past it: <1, 8>
static_assert(CANON_WROW % 128 == 32, "word rows 8c + t in distinct banks");
static_assert(128 >= CANON_SLAB, "a block's threads cover a slab's ids");

template <int MT>
__host__ __device__ constexpr int canon_threads() {
  return 256 / MT;                             // 8 / MT warps
}

// A ring stage: the words of CANON_KC chunks, then ROWS row slots of
// their bit planes.
template <int ROWS>
__host__ __device__ constexpr int canon_stage_bytes() {
  return CANON_KC * CANON_WCHUNK + ROWS * CANON_XSLOT;
}

template <typename T> __device__ __forceinline__ float x_f32(T v) {
  return to_f32(v);
}
template <> __device__ __forceinline__ float x_f32<double>(double v) {
  return __double2float_rn(v);               // x.to(float32)
}

// The 8 values of item (row r, chunk c) this lane takes (K 256c + 32j +
// lane), zero past k.
template <typename T>
__device__ __forceinline__ void canon_load_item(const T* __restrict__ x,
                                                long long s0, long long s1,
                                                int r, int c, int k, int lane,
                                                float (&v)[8]) {
  const T* xr = x + r * s0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kk = CANON_CHUNK * c + 32 * j + lane;
    v[j] = kk < k ? x_f32(xr[kk * s1]) : 0.0f;
  }
}

// sum over the warp, every lane holding it.
__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row r's sum of xq so far (every lane's share) to its slot in block r %
// CANON_PREP_BLOCKS's shared memory.
__device__ __forceinline__ void canon_flush_row(cg::cluster_group& cluster,
                                                long long* rsum, int r,
                                                long long acc, int lane) {
  acc = warp_sum64(acc);
  if (lane == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(cluster.map_shared_rank(
                  rsum + r / CANON_PREP_BLOCKS, r % CANON_PREP_BLOCKS)),
              static_cast<unsigned long long>(acc));
}

// A 32 x 32 bit transpose across the warp: lane i holds row i (bit j is
// M[i][j]); after it lane i holds column i (bit j is M[j][i]). Five
// butterfly stages, each swapping the off-diagonal s x s blocks with lane
// i ^ s.
__device__ __forceinline__ uint32_t warp_transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = masks[i];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? (x & ~m) | ((y >> s) & m) : (x & m) | ((y << s) & ~m);
  }
  return x;
}

// Item (r, c)'s bit planes from this lane's 8 values (K 256c + 32j +
// lane): xq = rint(v / xscale). Groups 2m and 2m + 1 go through one warp
// transpose as the low and high 16 bits of each lane's word, so lane l
// ends with plane l % 16 of group 2m + l / 16; it stores the words of its
// four groups as two 8-byte pairs (group j's word of plane p is word 8p +
// 2(j % 4) + j / 4). Adds the lane's xq to acc, flushing the row before
// when the warp moves to a new row.
__device__ __forceinline__ void canon_plane_item(
    cg::cluster_group& cluster, const float (&v)[8], int r, int c, int k,
    int n_chunks, float xscale, uint32_t* __restrict__ planes,
    long long* rsum, int& cur, long long& acc, int lane) {
  if (r != cur) {
    if (cur >= 0) canon_flush_row(cluster, rsum, cur, acc, lane);
    cur = r;
    acc = 0;
  }
  int q[8];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    q[j] = CANON_CHUNK * c + 32 * j + lane < k
               ? __float2int_rn(__fdiv_rn(v[j], xscale)) : 0;
    sum += q[j];
  }
  uint32_t w[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    w[m] = warp_transpose32((static_cast<uint32_t>(q[2 * m]) & 0xFFFFu)
                                | (static_cast<uint32_t>(q[2 * m + 1]) << 16),
                            lane);
  uint2* dst = reinterpret_cast<uint2*>(
      planes + ((size_t)r * n_chunks + c) * (CANON_XCHUNK / 4)
      + 8 * (lane % 16) + 2 * (lane / 16));
  dst[0] = make_uint2(w[0], w[2]);             // groups l / 16, 4 + l / 16
  dst[2] = make_uint2(w[1], w[3]);             // groups 2 + .., 6 + ..
  acc += sum;
}

// The whole input's grid, bit planes and row sums, by one cluster. The
// launch is the cluster (gridDim.x == CANON_PREP_BLOCKS). Each warp takes
// a range of (row, chunk) items; the values of its first CANON_PREP_CACHE
// items, all loaded at once, stay in registers for the second pass.
template <typename T>
__global__ void __launch_bounds__(CANON_PREP_THREADS)
canon_prep_kernel(const T* __restrict__ x, long long s0, long long s1,
                  uint32_t* __restrict__ planes, long long* __restrict__ sxq,
                  float* __restrict__ xscale_out, int bsz, int k,
                  int n_chunks) {
  constexpr int NW = CANON_PREP_THREADS / 32;
  constexpr int CP = CANON_PREP_BLOCKS;
  constexpr int CACHE = CANON_PREP_CACHE;
  extern __shared__ long long rsum[];        // row r's sum: rank r % CP
  __shared__ float red[NW];
  __shared__ float blk_max;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = blockIdx.x;
  const long long items = (long long)bsz * n_chunks;
  const long long gw = (long long)rank * NW + warp;
  const long long i0 = gw * items / (CP * NW);
  const int n_items = (int)((gw + 1) * items / (CP * NW) - i0);
  const int r0 = (int)(i0 / n_chunks), c0 = (int)(i0 % n_chunks);
  const int owned = (bsz + CP - 1) / CP;
  for (int i = tid; i < owned; i += CANON_PREP_THREADS) rsum[i] = 0;

  // Pass 1: max |x| (each value once).
  float v[CACHE][8];
  int r = r0, c = c0;
#pragma unroll
  for (int u = 0; u < CACHE; ++u) {
    if (u < n_items) {
      canon_load_item(x, s0, s1, r, c, k, lane, v[u]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[u][j] = 0.0f;
    }
    if (++c == n_chunks) c = 0, ++r;
  }
  float m = 0.0f;
#pragma unroll
  for (int u = 0; u < CACHE; ++u)
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmax_nan(m, fabsf(v[u][j]));
  for (int it = CACHE; it < n_items; ++it) {
    float w[8];
    canon_load_item(x, s0, s1, r, c, k, lane, w);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmax_nan(m, fabsf(w[j]));
    if (++c == n_chunks) c = 0, ++r;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m = fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmax_nan(m, red[w]);
    blk_max = m;
  }
  cluster.sync();                      // every block's max and zeroed sums
  float xmax = 0.0f;
#pragma unroll
  for (int b = 0; b < CP; ++b)
    xmax = fmax_nan(xmax, *cluster.map_shared_rank(&blk_max, b));
  xmax = fmax_nan(xmax, 1e-30f);                   // clamp(min=1e-30)
  const float xscale = __fdiv_rn(xmax, 16384.0f);  // / 2^14

  // Pass 2: the planes, a chunk a warp at a time, and the row sums.
  long long acc = 0;
  int cur = -1;
  r = r0;
  c = c0;
#pragma unroll
  for (int u = 0; u < CACHE; ++u) {
    if (u < n_items)
      canon_plane_item(cluster, v[u], r, c, k, n_chunks, xscale, planes,
                       rsum, cur, acc, lane);
    if (++c == n_chunks) c = 0, ++r;
  }
  for (int it = CACHE; it < n_items; ++it) {
    float w[8];
    canon_load_item(x, s0, s1, r, c, k, lane, w);
    canon_plane_item(cluster, w, r, c, k, n_chunks, xscale, planes, rsum,
                     cur, acc, lane);
    if (++c == n_chunks) c = 0, ++r;
  }
  if (cur >= 0) canon_flush_row(cluster, rsum, cur, acc, lane);
  cluster.sync();                      // every row sum has landed
  for (int i = tid; i < owned; i += CANON_PREP_THREADS) {
    const int row = i * CP + rank;
    if (row < bsz) sxq[row] = rsum[i];
  }
  if (rank == 0 && tid == 0) *xscale_out = xscale;
}

template <typename T>
static cudaError_t launch_canon_prep(const void* x, long long s0,
                                     long long s1, uint8_t* planes,
                                     long long* sxq, float* xscale, int bsz,
                                     int k, int n_chunks, int dev,
                                     cudaStream_t s) {
  static std::atomic<unsigned long long> limit_set{0}, cluster_set{0};
  const int smem = ((bsz + CANON_PREP_BLOCKS - 1) / CANON_PREP_BLOCKS) * 8;
  if (smem > CANON_PREP_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = smem_limit_once(
        (const void*)canon_prep_kernel<T>, CANON_PREP_SMEM, dev, limit_set);
    if (err != cudaSuccess) return err;
  }
  if constexpr (CANON_PREP_BLOCKS > 8) {       // a non-portable cluster
    const cudaError_t err = func_attr_once(
        (const void*)canon_prep_kernel<T>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1, dev, cluster_set);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CANON_PREP_BLOCKS);
  cfg.blockDim = dim3(CANON_PREP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CANON_PREP_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, canon_prep_kernel<T>, static_cast<const T*>(x), s0, s1,
      reinterpret_cast<uint32_t*>(planes), sxq, xscale, bsz, k, n_chunks);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Copy the words of chunks ch .. ch + nch - 1 of the block's columns into a
// ring stage; word rows past k32 and columns past n are zero.
__device__ __forceinline__ void canon_load_words(
    uint8_t* st, const uint32_t* __restrict__ words, int ch, int nch,
    int k32, int n, int col0, bool vec, int tid, int threads) {
  if (vec) {                                   // n % 4 == 0, aligned
    constexpr int WCH = CANON_BN / 4;          // 16-byte copies a word row
    for (int i = tid; i < 8 * nch * WCH; i += threads) {
      const int r = i / WCH, c = i % WCH;
      const int kw = 8 * ch + r, col = col0 + 4 * c;
      const bool ok = kw < k32 && col < n;
      cp_async16(st + r * CANON_WROW + 16 * c,
                 words + (ok ? (size_t)kw * n + col : 0), ok);
    }
  } else {
    for (int i = tid; i < 8 * nch * CANON_BN; i += threads) {
      const int r = i / CANON_BN, c = i % CANON_BN;
      const int kw = 8 * ch + r, col = col0 + c;
      const bool ok = kw < k32 && col < n;
      cp_async4(st + r * CANON_WROW + 4 * c,
                words + (ok ? (size_t)kw * n + col : 0), ok);
    }
  }
}

// Copy the planes of the same chunks for the first `slots` row slots
// (slot i holds row rows[i]; slots past n_rows are zero) into the stage.
__device__ __forceinline__ void canon_load_x(
    uint8_t* st, const uint8_t* __restrict__ planes, const int* rows,
    int slots, int n_rows, int ch, int nch, int n_chunks, int tid,
    int threads) {
  uint8_t* xs = st + CANON_KC * CANON_WCHUNK;
  const int xch = nch * CANON_XCHUNK / 16;     // 16-byte copies a slot
  for (int i = tid; i < slots * xch; i += threads) {
    const int r = i / xch, c = i % xch;
    const bool ok = r < n_rows;
    cp_async16(xs + r * CANON_XSLOT + 16 * c,
               planes + (ok ? ((size_t)rows[r] * n_chunks + ch)
                              * CANON_XCHUNK + 16 * c : 0),
               ok);
  }
}

// The ring over the block's chunks with NR row slots in use, then the
// warp's int64 sums into part[i * CANON_BN + column] (row slot i).
template <int MT, int ROWS, int NR>
__device__ __forceinline__ void canon_block_sums(
    uint8_t* smem, const uint8_t* __restrict__ planes,
    const uint32_t* __restrict__ words, const int* rows, int n_rows,
    int ch0, int ch1, int n_chunks, int k32, int n, int col0, bool vec) {
  constexpr int THREADS = canon_threads<MT>();
  constexpr int STAGE = canon_stage_bytes<ROWS>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wcol = warp * 16 * MT;             // the warp's first column
  const uint32_t smem_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n_st = (ch1 - ch0 + CANON_KC - 1) / CANON_KC;

  int acc[MT][NR][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][h][e] = 0;

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<CANON_STAGES - 2>();         // stage s has landed
    __syncthreads();                           // and stage s - 1 is read
    {
      const int nx = s + CANON_STAGES - 1;
      if (nx < n_st) {
        const int ch = ch0 + nx * CANON_KC;
        const int nch = min(CANON_KC, ch1 - ch);
        uint8_t* st = smem + (nx % CANON_STAGES) * STAGE;
        canon_load_words(st, words, ch, nch, k32, n, col0, vec, tid,
                         THREADS);
        canon_load_x(st, planes, rows, NR, n_rows, ch, nch, n_chunks, tid,
                     THREADS);
      }
      cp_async_commit();
    }
    const uint32_t st = smem_s + (s % CANON_STAGES) * STAGE;
    const int nch = min(CANON_KC, ch1 - (ch0 + s * CANON_KC));
#pragma unroll
    for (int cc = 0; cc < CANON_KC; ++cc) {
      if (cc >= nch) break;
      // Word rows 8cc + t (a0, a1) and 8cc + 4 + t (a2, a3): columns MT*g
      // + mt (rows g) and 8MT + MT*g + mt (rows g + 8) of the warp's.
      const uint32_t wa = st + (cc * 8 + tq) * CANON_WROW
                          + 4 * (wcol + MT * g);
      uint32_t w[4][MT];
      lds_words<MT>(w[0], wa);
      lds_words<MT>(w[1], wa + 32 * MT);
      lds_words<MT>(w[2], wa + 4 * CANON_WROW);
      lds_words<MT>(w[3], wa + 4 * CANON_WROW + 32 * MT);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = w[0][mt];
        a[mt][1] = w[1][mt];
        a[mt][2] = w[2][mt];
        a[mt][3] = w[3][mt];
      }
      // B of tile h, lane g: plane 8h + g of groups t (b0), t + 4 (b1),
      // words 8(8h + g) + 2t and + 1 of the slot's chunk.
      const uint32_t xb = st + CANON_KC * CANON_WCHUNK + cc * CANON_XCHUNK
                          + 32 * g + 8 * tq;
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 b = lds64(xb + i * CANON_XSLOT + 256 * h);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            bmma_16_8_256(acc[mt][i][h], a[mt], b.x, b.y);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is free

  long long* part = reinterpret_cast<long long*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int c_lo = wcol + MT * g + mt, c_hi = c_lo + 8 * MT;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (i >= n_rows) break;                  // uniform over the block
      long long lo = 0, hi = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * h + 2 * tq + e;
          const long long wp = p == CANON_PLANES - 1 ? -(1LL << p)
                                                     : (1LL << p);
          lo += wp * acc[mt][i][h][e];
          hi += wp * acc[mt][i][h][2 + e];
        }
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      if (tq == 0) {
        part[i * CANON_BN + c_lo] = lo;
        part[i * CANON_BN + c_hi] = hi;
      }
    }
  }
}

// canon_block_sums with NR the least power of two >= n_rows (slots past
// the block's rows hold zeros).
template <int MT, int ROWS, int NR = 1>
__device__ __forceinline__ void canon_block_dispatch(
    uint8_t* smem, const uint8_t* __restrict__ planes,
    const uint32_t* __restrict__ words, const int* rows, int n_rows,
    int ch0, int ch1, int n_chunks, int k32, int n, int col0, bool vec) {
  if constexpr (NR < ROWS) {
    if (n_rows > NR) {
      canon_block_dispatch<MT, ROWS, 2 * NR>(smem, planes, words, rows,
                                             n_rows, ch0, ch1, n_chunks, k32,
                                             n, col0, vec);
      return;
    }
  }
  canon_block_sums<MT, ROWS, NR>(smem, planes, words, rows, n_rows, ch0, ch1,
                                 n_chunks, k32, n, col0, vec);
}

// Block (tile, split, unit): the units of the slab's distinct ids (in
// order of first occurrence), each id's rows in groups of ROWS. MT = 2:
// 4 warps, 4 rows (4 blocks an SM); MT = 1: 8 warps, 4 rows (3 blocks an
// SM) or 8 rows (2 blocks an SM, by registers).
template <int MT, int ROWS>
__global__ void __launch_bounds__(256 / MT,
                                  MT == 2 ? 4 : (ROWS == 4 ? 3 : 2))
canon_delta_tc_kernel(const uint8_t* __restrict__ planes,
                      const long long* __restrict__ sxq,
                      const float* __restrict__ xscale,
                      const uint32_t* __restrict__ packed,
                      const void* __restrict__ ids, int ids64,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int row0, int slab, int k,
                      int n, int vec) {
  namespace cg = cooperative_groups;
  constexpr int THREADS = canon_threads<MT>();
  constexpr int STAGE = canon_stage_bytes<ROWS>();
  extern __shared__ __align__(16) uint8_t smem_canon[];
  __shared__ int sid[CANON_SLAB], did[CANON_SLAB], dunits[CANON_SLAB];
  __shared__ int rows[ROWS];
  __shared__ unsigned mask[CANON_SLAB / 32];
  __shared__ long long ssxq[ROWS];
  __shared__ float s_xscale, s_alpha;
  __shared__ int s_id, s_q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n_split = gridDim.y;
  const int k32 = k / 32;
  const int n_chunks = (k + CANON_CHUNK - 1) / CANON_CHUNK;
  const int slice = CANON_BN / n_split;        // this block's outputs
  const int c0 = split * slice;
  const int col0 = tile * CANON_BN;

  // The block's unit: units run over the slab's distinct ids in order of
  // first occurrence, ceil(rows / ROWS) units each, and unit blockIdx.z
  // is group q of the d-th distinct id (rows[] holds its rows as rows of
  // the batch).
  if (tid < slab) sid[tid] = load_id(ids, ids64, row0 + tid);
  __syncthreads();
  bool first = tid < slab;
  for (int j = 0; first && j < tid; ++j) first = sid[j] != sid[tid];
  if (warp < CANON_SLAB / 32) {
    const unsigned m = __ballot_sync(0xffffffffu, first);
    if (lane == 0) mask[warp] = m;
  }
  __syncthreads();
  if (first) {
    int rank = __popc(mask[warp] & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += __popc(mask[w]);
    int count = 0;
    for (int j = 0; j < slab; ++j) count += sid[j] == sid[tid];
    did[rank] = sid[tid];
    dunits[rank] = (count + ROWS - 1) / ROWS;
  }
  __syncthreads();
  if (tid == 0) {
    int distinct = 0;
#pragma unroll
    for (int w = 0; w < CANON_SLAB / 32; ++w) distinct += __popc(mask[w]);
    int u = blockIdx.z, d = 0;
    while (d < distinct && u >= dunits[d]) u -= dunits[d++];
    s_id = d < distinct ? did[d] : -1;
    s_q = u;
  }
  __syncthreads();
  const int t = s_id, q = s_q;
  if (t < 0) return;                           // the whole cluster
  const bool mine = tid < slab && sid[tid] == t;
  if (warp < CANON_SLAB / 32) {
    const unsigned m = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) mask[warp] = m;
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int w = 0; w < CANON_SLAB / 32; ++w) count += __popc(mask[w]);
  const int n_rows = min(ROWS, count - q * ROWS);  // >= 1
  if (mine) {
    int rank = __popc(mask[warp] & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += __popc(mask[w]);
    rank -= q * ROWS;
    if (rank >= 0 && rank < ROWS) rows[rank] = row0 + tid;
  }
  if (tid == 0) s_alpha = scales[t];

  // The words need nothing of the prep: their first stages go out before
  // the wait for its grid; the planes, sxq and xscale after it.
  const int ch0 = (int)((long long)split * n_chunks / n_split);
  const int ch1 = (int)((long long)(split + 1) * n_chunks / n_split);
  const int n_st = (ch1 - ch0 + CANON_KC - 1) / CANON_KC;
  const uint32_t* words = packed + (size_t)t * k32 * n;
#pragma unroll
  for (int s = 0; s < CANON_STAGES - 1; ++s)
    if (s < n_st) {
      const int ch = ch0 + s * CANON_KC;
      canon_load_words(smem_canon + s * STAGE, words, ch,
                       min(CANON_KC, ch1 - ch), k32, n, col0, vec, tid,
                       THREADS);
    }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();                             // rows are set
  if (tid < n_rows) ssxq[tid] = sxq[rows[tid]];
  if (tid == 0) s_xscale = *xscale;
  // The dispatch's slot count: n_rows rounded up to a power of two.
  const int slots = n_rows <= 1 ? 1 : n_rows <= 2 ? 2 : n_rows <= 4 ? 4 : 8;
#pragma unroll
  for (int s = 0; s < CANON_STAGES - 1; ++s) {
    if (s < n_st) {
      const int ch = ch0 + s * CANON_KC;
      canon_load_x(smem_canon + s * STAGE, planes, rows, slots, n_rows, ch,
                   min(CANON_KC, ch1 - ch), n_chunks, tid, THREADS);
    }
    cp_async_commit();                         // group 0 holds them all
  }

  canon_block_dispatch<MT, ROWS>(smem_canon, planes, words, rows, n_rows,
                                 ch0, ch1, n_chunks, k32, n, col0, vec != 0);
  long long* part = reinterpret_cast<long long*>(smem_canon);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const long long* remote[CANON_MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < CANON_MAX_SPLITS; ++r)
    remote[r] = cluster.map_shared_rank(part, r < n_split ? r : 0);
  const float alpha = s_alpha, xs = s_xscale;
  for (int it = tid; it < n_rows * slice; it += THREADS) {
    const int i = it / slice, c = it % slice;
    long long v[CANON_MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < CANON_MAX_SPLITS; ++r)
      v[r] = r < n_split ? remote[r][i * CANON_BN + c0 + c] : 0;
    long long sum = 0;
#pragma unroll
    for (int r = 0; r < CANON_MAX_SPLITS; ++r) sum += v[r];
    const int col = col0 + c0 + c;
    if (col < n)
      out[(size_t)rows[i] * n + col] = __fmul_rn(
          __fmul_rn(alpha, __ll2float_rn(2 * sum - ssxq[i])), xs);
  }
  cluster.sync();                              // the sums stay until read
}

// K ranges a column tile (one cluster): the least power of two that gives
// the card CANON_BLOCKS_PER_SM live blocks a multiprocessor, at most
// CANON_MAX_SPLITS and the chunks.
static int canon_splits(int live, int n_chunks, int sms) {
  const int cap = n_chunks < CANON_MAX_SPLITS ? n_chunks : CANON_MAX_SPLITS;
  int splits = 1;
  while (splits * live < CANON_BLOCKS_PER_SM * sms && splits * 2 <= cap)
    splits *= 2;
  return splits;
}

// The main kernel over rows row0 .. row0 + slab - 1 (g matrices).
template <int MT, int ROWS>
static cudaError_t launch_canon_tc(const uint8_t* planes,
                                   const long long* sxq, const float* xscale,
                                   const void* packed, const void* ids,
                                   int ids64, const void* scales, void* out,
                                   int row0, int slab, int k, int n, int g,
                                   int vec, int dev, int sms,
                                   cudaStream_t s) {
  static std::atomic<unsigned long long> limit_set{0};
  constexpr int smem = canon_stage_bytes<ROWS>() * CANON_STAGES;
  static_assert(smem >= ROWS * CANON_BN * 8,
                "the sums of the block's rows fit in the ring");
  cudaError_t err = smem_limit_once(
      (const void*)canon_delta_tc_kernel<MT, ROWS>, smem, dev, limit_set);
  if (err != cudaSuccess) return err;
  // Units, at most: D distinct ids of c_d rows make sum ceil(c_d / R) <=
  // D + (slab - D) / R units, which grows with D <= min(slab, g).
  const int n_d = slab < g ? slab : g;
  const int units = n_d + (slab - n_d) / ROWS;
  const int tiles = (n + CANON_BN - 1) / CANON_BN;
  const int n_split = canon_splits(units * tiles,
                                   (k + CANON_CHUNK - 1) / CANON_CHUNK, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, n_split, units);
  cfg.blockDim = dim3(canon_threads<MT>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, canon_delta_tc_kernel<MT, ROWS>, planes, sxq,
                           xscale, (const uint32_t*)packed, ids, ids64,
                           (const float*)scales, (float*)out, row0, slab, k,
                           n, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Bytes of scratch a call takes (the wrapper allocates them): x's bit
// planes (ceil(k / 256) * 512 a row), each row's int64 sum of xq, xscale.
extern "C" long long bd_canon_delta_scratch_bytes(int bsz, int k) {
  return (long long)bsz * ((k + CANON_CHUNK - 1) / CANON_CHUNK) * CANON_XCHUNK
         + 8LL * bsz + 16;
}

// x (bsz, k) with element strides s0, s1 of type x_type (0 fp32, 1 bf16,
// 2 fp16, 3 fp64); packed (g, k / 32, n) int32; scales (g,) fp32; ids
// (bsz,) int32 or int64 (ids64); buf: bd_canon_delta_scratch_bytes(bsz, k)
// bytes; out (bsz, n) fp32. The prep, then the main kernel once a slab of
// CANON_SLAB rows: each slab after the first waits for the one before (a
// programmatic dependent that nothing triggers early), so the prep has
// ended before any slab reads.
extern "C" int bd_canon_delta(const void* x, long long s0, long long s1,
                              int x_type, const void* packed,
                              const void* scales, const void* ids, int ids64,
                              void* buf, void* out, int bsz, int k, int n,
                              int g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = (k + CANON_CHUNK - 1) / CANON_CHUNK;
  if (bsz < 1 || k < 32 || k % 32 != 0 || n < 1 || g < 1 || x_type < 0
      || x_type > 3 || ((uintptr_t)buf % 16) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  uint8_t* planes = static_cast<uint8_t*>(buf);
  long long* sxq = reinterpret_cast<long long*>(
      planes + (size_t)bsz * n_chunks * CANON_XCHUNK);
  float* xscale = reinterpret_cast<float*>(sxq + bsz);
  switch (x_type) {
    case 0:
      err = launch_canon_prep<float>(x, s0, s1, planes, sxq, xscale, bsz, k,
                                     n_chunks, dev, s);
      break;
    case 1:
      err = launch_canon_prep<__nv_bfloat16>(x, s0, s1, planes, sxq, xscale,
                                             bsz, k, n_chunks, dev, s);
      break;
    case 2:
      err = launch_canon_prep<__half>(x, s0, s1, planes, sxq, xscale, bsz, k,
                                      n_chunks, dev, s);
      break;
    default:
      err = launch_canon_prep<double>(x, s0, s1, planes, sxq, xscale, bsz,
                                      k, n_chunks, dev, s);
  }
  const int vec = n % 4 == 0 && ((uintptr_t)packed % 16) == 0;
  // The form by slab, each where it timed fastest on the H100
  // (sweep_canonical_delta.py at 1 to 130 rows): <2, 4> up to 4 rows (w1
  // at 4 routed rows: 448 blocks, one wave at 4 blocks an SM, two at 3),
  // <1, 8> past 16 (at 64 rows a matrix shared by many rows is read half
  // as often), else <1, 4>.
  for (int row0 = 0; row0 < bsz && err == cudaSuccess; row0 += CANON_SLAB) {
    const int slab = bsz - row0 < CANON_SLAB ? bsz - row0 : CANON_SLAB;
    if (slab <= CANON_SMALL_SLAB)
      err = launch_canon_tc<2, 4>(planes, sxq, xscale, packed, ids, ids64,
                                  scales, out, row0, slab, k, n, g, vec, dev,
                                  sms, s);
    else if (slab <= CANON_LARGE_SLAB)
      err = launch_canon_tc<1, 4>(planes, sxq, xscale, packed, ids, ids64,
                                  scales, out, row0, slab, k, n, g, vec, dev,
                                  sms, s);
    else
      err = launch_canon_tc<1, 8>(planes, sxq, xscale, packed, ids, ids64,
                                  scales, out, row0, slab, k, n, g, vec, dev,
                                  sms, s);
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// 9 and 10. Fused base + tenant delta at decode:
//    Y[b] = x[b] @ W + scale[ids[b]] * (x[b] @ sign(P[ids[b]]))
//
// Row 9 (bd_fused_tenant) takes the canonical layout P (T, K/32, N) and
// adds the delta as ±x in fp32 for each bit, as the TPU kernel's float
// dot with ±1 does (no x grid). Row 10 takes the pair layout (T, K/16,
// N/2) and row 1's per-row 12-bit x grid; its delta is row 1's exact
// integer pair sums and fp32 epilogue. bf16 x and W take the tensor-core
// kernels (row 10: bd_fused_base_pair_tc, section 10 below; row 9 with
// N a multiple of 8: bd_fused_tenant_tc, section 9 at the end); this
// section holds the CUDA-core kernels the wrappers send everything else:
// row 9 (bd_fused_tenant: fp32 x and W, or any other N) and row 10's fp32
// kernel (bd_fused_base_pair), which takes x already quantized by the
// wrapper and which only fp32 parity checks send. Both compute the base
// product in their own body, fp32 sums of the products of x and W in
// their dtype.
//
// Bound on the H100: at decode (B = 8 rows) each W element has B uses,
// so the bytes are the K*N*2 of the bf16 base plus the words of the
// distinct tenants (1/16 of the base each), against 3.35 TB/s; these
// CUDA-core kernels do about 2*B*K*N multiply-adds for the base and as
// many again for the delta, of the same order as the bytes' time.
// Design, for both:
//   * W is read ONCE for all the rows: one block per 256-column tile (two
//     adjacent columns a thread, 128 threads along N, so each warp's W
//     loads are contiguous) and per group of up to FUSED_ROWS rows; the
//     block keeps every row's sums in registers and, for each W element
//     it loads, does one fused multiply-add per row;
//   * x (and row 10's xq) of all the block's rows is staged in shared
//     memory in K chunks of FUSED_TK and read as a broadcast;
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
                                  int n2, int splits, void* stream) {
  // K per split in whole 16-row words.
  const int k_per_split = (((k + splits - 1) / splits) + 15) / 16 * 16;
  dim3 grid((n2 + 2 * FUSED_THREADS - 1) / (2 * FUSED_THREADS),
            (bsz + FUSED_ROWS - 1) / FUSED_ROWS, splits);
  cudaStream_t s = (cudaStream_t)stream;
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

// ---------------------------------------------------------------------------
// 10 on the tensor cores (bf16 x and W): bd_fused_base_pair_tc
//    Y[b] = x[b] @ W + scale[ids[b]] * (x[b] @ sign(P[ids[b]]))
// replaces bitdelta_tpu/ops/pallas_binary_gemm.py
// ::fused_base_pair_matmul_pallas: W (K, N) natural layout, P the pair
// layout (T, K/16, N/2), the delta on row 1's per-row 12-bit x grid, its
// integer sums exact, row 1's fp32 epilogue 2*a1*S + (a2*colsum -
// a1*sxq), then one __fadd_rn(base, delta).
//
// Bound on the H100: bytes. A Mistral-7B layer at B = 8 over 3 tenants
// reads its bf16 base once (436 MB) and the distinct tenants' words and
// colsums (82 MB): 0.155 ms at 3.35 TB/s, against 7 GFLOP of base and
// delta products (7 us at the bf16 rate). So W has to stream at the
// memory rate, read once for all the rows, with the products hidden
// under it. A call is two launches (one more for each further FP_SLAB
// rows) and nothing else:
//
// * the x prep is row 1's pair_prep_kernel (bit planes, a1, a2, sxq, in
//   bd_pair_delta_scratch_bytes' layout); it launches the main kernel as
//   its programmatic dependent, and W, x and the words need nothing of
//   it, so the main kernel's first ring stages stream while the prep
//   runs: it waits for the prep only before the planes and coefficients;
// * fused_pair_tc_kernel<NT>: a block owns FP_BJ pair columns (2 * FP_BJ
//   natural columns: the low halves, then the high halves of one
//   128-column pair group), every row of the slab (NT n8 tiles, up to
//   FP_SLAB) and one K split. A warp owns 8 pair columns, one m16 tile
//   whose row g is the low natural column of pair column 8 * warp + g
//   and row g + 8 its high column, the rows of row 1's 1-bit A fragment
//   for the same pair column; so both products' D fragments hold the
//   same two columns in each lane;
// * the base runs on the bf16 tensor cores (mma.sync.m16n8k16, fp32
//   sums) with W as the A operand, taken from shared memory by
//   ldmatrix.trans (W is (K, N) row-major: a shared row is 8 natural
//   columns of one K), and the slab's rows as the n8 side (x by
//   ldmatrix). Each FP_KS-deep stage sums into a fresh fp32 accumulator
//   that is then added to the running sum: the tensor cores truncate as
//   they accumulate;
// * the delta runs on the 1-bit MMA (m16n8k256 .and.popc) with row 1's
//   fragments: A the sign bits by one byte permute a register, B the
//   prep's bit planes. A stage is half a 256-K chunk, so an MMA takes
//   two tenants at once: tenant j's words in A's first 128 K, tenant
//   j + 1's in its second, and B the same planes twice, each masked to
//   the row slots of its tenant (a slot holds one row, a row one tenant,
//   so each D column counts its own tenant's bits only). Row slots are
//   the slab's rows ordered by tenant (order of first occurrence), so a
//   group of 4 slots mostly holds one tenant; the MMAs of a group run
//   only for the tenants it holds, and each distinct tenant's words are
//   read once. A stage holds the words of FP_DT tenants: a slab with more
//   walks its K range once more for each further FP_DT (words and planes
//   only). Each group's popcounts are weighted by their planes and added
//   in registers, exact;
// * an FP_STAGES-deep ring brings each stage into shared memory: the W
//   rows by TMA (two 2-D boxes, the tile's low and high columns, issued
//   by one thread and completing on the stage's mbarrier, with the
//   64-byte swizzle so that ldmatrix reads them free of bank conflicts),
//   the x rows, words and planes by 16-byte cp.async copies (rows
//   padded likewise); K past the end is zero. A stage is small (25 KB at
//   8 rows), so four blocks live on a multiprocessor and the K splits
//   grow to fill them: on the H100 the number of blocks streaming at
//   once, not the ring's depth, sets the rate (scripts/sweep_fused_pair.py,
//   PERF.md);
// * the K splits of a column tile form one thread block cluster: each
//   block leaves its fp32 base partials and its integer pair sums in
//   its shared memory; after a cluster barrier, block q adds, for its
//   64 / n_split columns, every block's partials in rank order (the base
//   in fp32, S in integers: no atomics, the result does not depend on
//   scheduling), runs the epilogue and writes natural column order. The
//   split count is the largest power of two (at most FP_MAX_SPLITS)
//   that keeps the grid within 3.5 blocks a multiprocessor (of the 4
//   that fit at 8 rows): at B = 8, k/v_proj (N = 1024: 16 tiles of 32
//   pair columns) run 8 splits, q/o/down_proj 4, gate/up_proj 2, the
//   best of each in scripts/sweep_fused_pair.py;
// * any B: a launch takes a slab of up to FP_SLAB rows, and each slab
//   reads W once (one more pass over W for each further slab).
//
// tests/test_torch_fused_pair_numerics.py models the fragments, the
// slots, the meeting of the two products in the epilogue and the
// cluster's sum on the CPU.
// ---------------------------------------------------------------------------

constexpr int FP_BJ = 32;                  // pair columns a block
constexpr int FP_WARPS = FP_BJ / 8;        // a warp: 8 pair columns
constexpr int FP_THREADS = FP_WARPS * 32;
constexpr int FP_COLS = 2 * FP_BJ;         // natural columns a block
constexpr int FP_KS = 128;                 // K a ring stage
constexpr int FP_STAGES = 2;               // stages in the ring
constexpr int FP_SLAB = 32;                // rows a main-kernel launch takes
constexpr int FP_DT = 4;                   // tenants' words a stage holds
constexpr int FP_MAX_SPLITS = 8;           // a portable cluster
constexpr int FP_HALF_BLOCKS_PER_SM = 7;   // the split's aim: 3.5 an SM
constexpr int FP_WBOX = FP_KS * FP_BJ * 2; // bytes of a W box (one run)
constexpr int FP_XROW = FP_KS * 2 + 16;    // bytes of a shared x row
constexpr int FP_PROW = FP_BJ * 4 + 16;    // bytes of a shared word row
constexpr int FP_PSLOT = 4 * PAIR_PLANES * 4 + 16;  // a slot's planes
constexpr int FP_HALF = 4 * PAIR_PLANES * 4;        // plane bytes a stage
static_assert(128 % FP_BJ == 0, "a tile lies in one pair group");
static_assert(FP_KS * 2 == PAIR_CHUNK, "a stage is half a 1-bit chunk");
static_assert(FP_DT % 2 == 0, "an MMA takes two tenants");
static_assert(FP_THREADS >= FP_SLAB, "a thread a row of the slab");
static_assert(FP_BJ * 2 == 64, "a W box row is one 64-byte swizzle span");

// Byte offsets in a ring stage (1024-byte aligned, as the W boxes'
// swizzle needs): the W boxes (the low run, then the high run), x rows,
// words, planes.
template <int NT>
struct FpStage {
  static constexpr int X = 2 * FP_WBOX;
  static constexpr int WORDS = X + NT * 8 * FP_XROW;
  static constexpr int PLANES = WORDS + FP_DT * (FP_KS / 16) * FP_PROW;
  static constexpr int BYTES =
      (PLANES + NT * 8 * FP_PSLOT + 1023) / 1024 * 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for phase ``parity`` of a barrier; a wait past about 2^32 cycles
// (seconds) traps, so a lost copy fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// A TMA copy of the box at (column c0, row r0) of a 2-D tensor map into
// shared memory, completing on barrier bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
         "r"(bar) : "memory");
}

// W rows k0 .. k0 + FP_KS - 1 at the tile's columns (natural nlo ..
// nlo + FP_BJ - 1, then nlo + 128 ..), two TMA boxes issued by one
// thread (rows past k come as zeros), and the slab's x at the same K.
template <int NT>
__device__ __forceinline__ void fp_load_base(
    uint8_t* st, const CUtensorMap* wmap, uint32_t bar,
    const __nv_bfloat16* __restrict__ x, int x_stride, int row0, int slab,
    int k0, int k, int nlo) {
  if (threadIdx.x == 0) {
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(st));
    // The stage was read (ldmatrix) before the block's last barrier.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * FP_WBOX);
    tma_load_2d(dst, wmap, nlo, k0, bar);
    tma_load_2d(dst + FP_WBOX, wmap, nlo + 128, k0, bar);
  }
  uint8_t* xs = st + FpStage<NT>::X;
  constexpr int XCH = FP_KS * 2 / 16;          // 16-byte copies an x row
  for (int i = threadIdx.x; i < NT * 8 * XCH; i += FP_THREADS) {
    const int r = i / XCH, c = i % XCH;
    const bool ok = r < slab && k0 + 8 * c < k;
    cp_async16(xs + r * FP_XROW + 16 * c,
               x + (ok ? (size_t)(row0 + r) * x_stride + k0 + 8 * c : 0),
               ok);
  }
}

// Word rows kw0 .. kw0 + 7 of the pass's tenants at the tile's pair
// columns (rows past k16 zero).
__device__ __forceinline__ void fp_load_words(
    uint8_t* ws, const uint32_t* __restrict__ pairs, const int* tenants,
    int count, int kw0, int k16, int n2, int pc0) {
  constexpr int CH = FP_BJ * 4 / 16;           // 16-byte copies a row
  for (int i = threadIdx.x; i < count * 8 * CH; i += FP_THREADS) {
    const int j = i / (8 * CH), r = (i / CH) % 8, c = i % CH;
    const int kw = kw0 + r;
    const bool ok = kw < k16;
    cp_async16(ws + (j * 8 + r) * FP_PROW + 16 * c,
               pairs + (ok ? ((size_t)tenants[j] * k16 + kw) * n2 + pc0
                                 + 4 * c : 0), ok);
  }
}

// The planes of half chunk h (its four 32-K groups) for each row slot
// (slots past the slab zero).
template <int NT>
__device__ __forceinline__ void fp_load_planes(
    uint8_t* ps, const uint8_t* __restrict__ planes, const int* slot_row,
    int slab, int row0, int h, int n_chunks) {
  constexpr int CH = FP_HALF / 16;
  for (int i = threadIdx.x; i < NT * 8 * CH; i += FP_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < slab;
    cp_async16(ps + r * FP_PSLOT + 16 * c,
               planes + (ok ? ((size_t)(row0 + slot_row[r]) * n_chunks
                               + h / 2) * PAIR_XCHUNK + (h % 2) * FP_HALF
                              + 16 * c : 0), ok);
  }
}

// Block (tile, split): FP_BJ pair columns, every row of the slab row0 ..
// row0 + slab - 1, one K range. 128 threads, at most two blocks an SM.
template <int NT>
__global__ void __launch_bounds__(FP_THREADS)
fused_pair_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ x, int x_stride,
                     const uint8_t* __restrict__ planes,
                     const uint32_t* __restrict__ pairs,
                     const void* __restrict__ ids, int ids64,
                     const float* __restrict__ coef,
                     const float* __restrict__ colsum,
                     float* __restrict__ out, int bsz, int row0, int slab,
                     int k, int n2) {
  namespace cg = cooperative_groups;
  constexpr int ROWS = NT * 8;                 // row slots
  constexpr int G = ROWS / 4;                  // groups of 4 slots
  using S = FpStage<NT>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t wbar[FP_STAGES];
  __shared__ int sid[ROWS], first[ROWS], sd[ROWS];
  __shared__ int slot_row[ROWS], slot_d[ROWS], d_tenant[ROWS];
  __shared__ unsigned gmask[G];
  __shared__ float sa1[ROWS], sa2[ROWS], ssxq[ROWS];
  __shared__ int s_nd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int n = 2 * n2, k16 = k / 16;
  const int n_chunks = (k + PAIR_CHUNK - 1) / PAIR_CHUNK;
  const int pc0 = blockIdx.x * FP_BJ;          // the tile's first pair column
  const int nlo = (pc0 / 128) * 256 + pc0 % 128;
  const int n_st = (k + FP_KS - 1) / FP_KS;
  const int h0 = (int)((long long)split * n_st / n_split);
  const int n_h = (int)((long long)(split + 1) * n_st / n_split) - h0;
  // The ring from the first 1024-byte boundary (the allocation has 1024
  // bytes to spare); stage s's W boxes complete on wbar[s].
  uint8_t* smem_fp = smem_raw + ((1024u - static_cast<uint32_t>(
      __cvta_generic_to_shared(smem_raw)) % 1024u) % 1024u);
  const uint32_t bar0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(wbar));
  const CUtensorMap* wmp = &wmap;
  if (tid == 0) {
    for (int st = 0; st < FP_STAGES; ++st) mbar_init(bar0 + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // Slots: the slab's rows ordered by their tenant's rank d among the
  // distinct tenants (order of first occurrence), then by row.
  if (tid < slab) sid[tid] = load_id(ids, ids64, row0 + tid);
  __syncthreads();
  if (tid < slab) {
    int f = 0;
    while (sid[f] != sid[tid]) ++f;
    first[tid] = f;
  }
  __syncthreads();
  if (tid < slab) {
    int d = 0;
    for (int j = 0; j < first[tid]; ++j) d += first[j] == j;
    sd[tid] = d;
  }
  __syncthreads();
  if (tid < slab) {
    int slot = 0;
    for (int j = 0; j < slab; ++j)
      slot += sd[j] < sd[tid] || (sd[j] == sd[tid] && j < tid);
    slot_row[slot] = tid;
    slot_d[slot] = sd[tid];
    if (first[tid] == tid) d_tenant[sd[tid]] = sid[tid];
  } else if (tid < ROWS) {
    slot_d[tid] = -1;                          // slots past the slab
  }
  __syncthreads();
  if (tid < G) {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (slot_d[4 * tid + i] >= 0) m |= 1u << slot_d[4 * tid + i];
    gmask[tid] = m;
  }
  if (tid == 0) {
    int nd = 0;
    for (int j = 0; j < slab; ++j) nd += first[j] == j;
    s_nd = nd;
  }
  __syncthreads();
  const int nd = s_nd;
  const int n_items = (nd + FP_DT - 1) / FP_DT * n_h;

  // Item it: pass it / n_h (tenants FP_DT * pass ..), half chunk h0 +
  // it % n_h. W, x and the words need nothing of the prep.
  auto load_inputs = [&](int it) {
    const int pass = it / n_h, h = h0 + it % n_h;
    uint8_t* st = smem_fp + (it % FP_STAGES) * S::BYTES;
    if (pass == 0)
      fp_load_base<NT>(st, wmp, bar0 + 8 * (it % FP_STAGES), x, x_stride,
                       row0, slab, h * FP_KS, k, nlo);
    fp_load_words(st + S::WORDS, pairs, d_tenant + pass * FP_DT,
                  min(FP_DT, nd - pass * FP_DT), h * (FP_KS / 16), k16, n2,
                  pc0);
  };
  auto load_planes = [&](int it) {
    uint8_t* st = smem_fp + (it % FP_STAGES) * S::BYTES;
    fp_load_planes<NT>(st + S::PLANES, planes, slot_row, slab, row0,
                       h0 + it % n_h, n_chunks);
  };
#pragma unroll
  for (int s = 0; s < FP_STAGES - 1; ++s)
    if (s < n_items) load_inputs(s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid < slab) {
    sa1[tid] = coef[row0 + tid];
    sa2[tid] = coef[bsz + row0 + tid];
    ssxq[tid] = coef[2 * bsz + row0 + tid];
  }
#pragma unroll
  for (int s = 0; s < FP_STAGES - 1; ++s) {
    if (s < n_items) load_planes(s);
    cp_async_commit();                         // group 0 holds them all
  }

  const uint32_t smem_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_fp));
  // ldmatrix.trans of W: lane l gives row i = (l / 16) * 8 + l % 8 of the
  // k16 step in the low (l / 8 even) or high box, at the warp's 16-byte
  // chunk: a0 (rows g, K 2t..), a1 (rows g + 8), a2 (K 2t + 8..), a3. A
  // box row is 64 bytes, its chunk c stored at c ^ ((row / 2) % 4) (the
  // 64-byte swizzle), which leaves the 8 rows of a matrix in 8 distinct
  // bank groups; (row / 2) % 4 = (l % 8) / 2 at every k16 step.
  const uint32_t w_lane = ((lane / 8) % 2) * FP_WBOX
                          + ((lane / 16) * 8 + lane % 8) * FP_BJ * 2
                          + ((warp ^ ((lane % 8) / 2)) * 16);
  // ldmatrix of x: lane l gives row l % 8 of an n8 tile at K 8 * (l / 8)
  // of two k16 steps: b0, b1 of the first, b0, b1 of the second.
  const uint32_t x_lane = (lane % 8) * FP_XROW + (lane / 8) * 16;
  // The 1-bit B of tile (r4, pp): slot 4 * r4 + g / 2, plane 2pp + g % 2
  // of 32-K group tq; the 1-bit A: word rows 2tq, 2tq + 1 of pair column
  // 8 * warp + g.
  const uint32_t p_lane = (g / 2) * FP_PSLOT + (g % 2) * 4
                          + tq * PAIR_PLANES * 4;
  const uint32_t a_lane = 2 * tq * FP_PROW + (8 * warp + g) * 4;

  float tot[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[nt][e] = 0.0f;
  int s_lo[G], s_hi[G];
#pragma unroll
  for (int r4 = 0; r4 < G; ++r4) s_lo[r4] = s_hi[r4] = 0;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<FP_STAGES - 2>();            // item it has landed
    __syncthreads();                           // and item it - 1 is read
    {
      const int nx = it + FP_STAGES - 1;
      if (nx < n_items) {
        load_inputs(nx);
        load_planes(nx);
      }
      cp_async_commit();
    }
    const uint8_t* stp = smem_fp + (it % FP_STAGES) * S::BYTES;
    const uint32_t st = smem_s + (it % FP_STAGES) * S::BYTES;
    const int pass = it / n_h;
    if (pass == 0) {
      // The base: FP_KS / 16 MMAs a tile into a fresh accumulator.
      mbar_wait(bar0 + 8 * (it % FP_STAGES), (it / FP_STAGES) & 1);
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < FP_KS / 16; kk += 2) {
        uint32_t a0[4], a1[4];
        ldsm_x4<true>(a0, stp + kk * 16 * FP_BJ * 2 + w_lane);
        ldsm_x4<true>(a1, stp + (kk + 1) * 16 * FP_BJ * 2 + w_lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[4];
          ldsm_x4<false>(b, stp + S::X + nt * 8 * FP_XROW + kk * 32
                            + x_lane);
          mma_16816(acc[nt], a0, b[0], b[1]);
          mma_16816(acc[nt], a1, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tot[nt][e] = __fadd_rn(tot[nt][e], acc[nt][e]);
    }
    // The delta: the pass's tenants' A fragments (the first 128 K of
    // m16n8k256), then each group of slots against the tenants it holds,
    // two tenants an MMA.
    const int dp = pass * FP_DT;
    uint32_t aw[FP_DT][2];
#pragma unroll
    for (int j = 0; j < FP_DT; ++j) {
      const uint32_t wa = st + S::WORDS + j * 8 * FP_PROW + a_lane;
      const uint32_t w0 = lds32(wa), w1 = lds32(wa + FP_PROW);
      aw[j][0] = __byte_perm(w0, w1, 0x5410);   // low column, K 32t ..
      aw[j][1] = __byte_perm(w0, w1, 0x7632);   // high column
    }
#pragma unroll
    for (int r4 = 0; r4 < G; ++r4) {
      const unsigned gm = (gmask[r4] >> dp) & ((1u << FP_DT) - 1u);
      if (gm == 0u) continue;                  // the same in every lane
      const int my_d = slot_d[4 * r4 + g / 2];  // B column g's slot
      uint32_t bp[6];
#pragma unroll
      for (int pp = 0; pp < 6; ++pp)
        bp[pp] = lds32(st + S::PLANES + r4 * 4 * FP_PSLOT + p_lane + pp * 8);
      int iacc[6][4];
#pragma unroll
      for (int pp = 0; pp < 6; ++pp)
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[pp][e] = 0;
#pragma unroll
      for (int jp = 0; jp < FP_DT; jp += 2) {
        if (((gm >> jp) & 3u) == 0u) continue;
        const uint32_t m0 = my_d == dp + jp ? 0xffffffffu : 0u;
        const uint32_t m1 = my_d == dp + jp + 1 ? 0xffffffffu : 0u;
        const uint32_t a[4] = {aw[jp][0], aw[jp][1], aw[jp + 1][0],
                               aw[jp + 1][1]};
#pragma unroll
        for (int pp = 0; pp < 6; ++pp)
          bmma_16_8_256(iacc[pp], a, bp[pp] & m0, bp[pp] & m1);
      }
      // c0 / c2: plane 2pp of slot 4 * r4 + tq, low / high column; c1 /
      // c3: plane 2pp + 1.
#pragma unroll
      for (int pp = 0; pp < 6; ++pp) {
        s_lo[r4] += (iacc[pp][0] << (2 * pp)) + (iacc[pp][1] << (2 * pp + 1));
        s_hi[r4] += (iacc[pp][2] << (2 * pp)) + (iacc[pp][3] << (2 * pp + 1));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is free

  // The two products meet in shared memory: base[row][c] (base D: lane
  // (g, tq) holds rows 8nt + 2tq, + 1) and S[row][c] (delta: slot 4r4 +
  // tq, its row slot_row[..]); c < FP_BJ the low columns, then the high.
  float* pb = reinterpret_cast<float*>(smem_fp);
  int* ps = reinterpret_cast<int*>(smem_fp + ROWS * FP_COLS * 4);
  const int c_lo = 8 * warp + g, c_hi = FP_BJ + 8 * warp + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * tq + e;
      pb[r * FP_COLS + c_lo] = tot[nt][e];
      pb[r * FP_COLS + c_hi] = tot[nt][2 + e];
    }
#pragma unroll
  for (int r4 = 0; r4 < G; ++r4) {
    const int slot = 4 * r4 + tq;
    if (slot < slab) {
      const int r = slot_row[slot];
      ps[r * FP_COLS + c_lo] = s_lo[r4];
      ps[r * FP_COLS + c_hi] = s_hi[r4];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* rb[FP_MAX_SPLITS];
  const int* rs[FP_MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < FP_MAX_SPLITS; ++r) {
    rb[r] = cluster.map_shared_rank(pb, r < n_split ? r : 0);
    rs[r] = cluster.map_shared_rank(ps, r < n_split ? r : 0);
  }
  const int slice = FP_COLS / n_split, c0 = split * slice;
  for (int it = tid; it < slab * slice; it += FP_THREADS) {
    const int i = it / slice, c = c0 + it % slice;
    float vb[FP_MAX_SPLITS];
    int vs[FP_MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < FP_MAX_SPLITS; ++r) {
      vb[r] = r < n_split ? rb[r][i * FP_COLS + c] : 0.0f;
      vs[r] = r < n_split ? rs[r][i * FP_COLS + c] : 0;
    }
    float base = vb[0];
    int sum = vs[0];
#pragma unroll
    for (int r = 1; r < FP_MAX_SPLITS; ++r)
      if (r < n_split) {                       // in rank order
        base = __fadd_rn(base, vb[r]);
        sum += vs[r];
      }
    const int col = c < FP_BJ ? nlo + c : nlo + 128 + (c - FP_BJ);
    const float two_a1 = __fmul_rn(2.0f, sa1[i]);
    const float off = __fmul_rn(sa1[i], ssxq[i]);
    const float delta = __fadd_rn(
        __fmul_rn(two_a1, static_cast<float>(sum)),
        __fsub_rn(__fmul_rn(sa2[i], colsum[(size_t)sid[i] * n + col]), off));
    out[(size_t)(row0 + i) * n + col] = __fadd_rn(base, delta);
  }
  cluster.sync();                              // the partials stay until read
}

// cuTensorMapEncodeTiled, looked up once through the runtime.
static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static std::atomic<void*> cached{nullptr};
  void* fn = cached.load();
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return nullptr;
    cached.store(fn);
  }
  return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
}

// W (k, n) bf16 row-major as TMA boxes of box_rows rows x box_cols
// columns with the given swizzle; rows past k and columns past n read as
// zeros.
static cudaError_t w_tensor_map(CUtensorMap* map, const void* w, int k,
                                int n, int box_cols, int box_rows,
                                CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The main kernel over rows row0 .. row0 + slab - 1: K splits, the
// largest power of two (at most FP_MAX_SPLITS and the stages) that keeps
// the grid within FP_HALF_BLOCKS_PER_SM / 2 blocks a multiprocessor, and
// within one wave of resident blocks.
template <int NT>
static cudaError_t launch_fused_pair_tc(
    const CUtensorMap& wmap, const void* x, int x_stride,
    const uint8_t* planes, const void* pairs, const void* ids, int ids64,
    const float* coef, const void* colsum, void* out, int bsz, int row0,
    int slab, int k, int n2, int dev, int sms, cudaStream_t s) {
  static std::atomic<unsigned long long> limit_set{0};
  static std::atomic<int> live_cache{0};
  constexpr int smem = FpStage<NT>::BYTES * FP_STAGES + 1024;
  static_assert(smem >= NT * 8 * FP_COLS * 8,
                "the partials of the block's rows fit in the ring");
  const void* fn = (const void*)fused_pair_tc_kernel<NT>;
  cudaError_t err = smem_limit_once(fn, smem, dev, limit_set);
  if (err != cudaSuccess) return err;
  int live = live_cache.load();
  if (live == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&live, fn,
                                                        FP_THREADS, smem);
    if (err != cudaSuccess) return err;
    live = live < 1 ? 1 : live;
    live_cache.store(live);
  }
  const int tiles = n2 / FP_BJ;
  const int n_st = (k + FP_KS - 1) / FP_KS;
  const int cap = n_st < FP_MAX_SPLITS ? n_st : FP_MAX_SPLITS;
  const int aim = (FP_HALF_BLOCKS_PER_SM < 2 * live ? FP_HALF_BLOCKS_PER_SM
                                                    : 2 * live) * sms;
  int splits = 1;
  while (splits * 2 <= cap && 2 * tiles * splits * 2 <= aim) splits *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits, 1);
  cfg.blockDim = dim3(FP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, fused_pair_tc_kernel<NT>, wmap,
                           (const __nv_bfloat16*)x, x_stride, planes,
                           (const uint32_t*)pairs, ids, ids64, coef,
                           (const float*)colsum, (float*)out, bsz, row0,
                           slab, k, n2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// bf16 x (bsz, k) with row stride x_stride, W (k, 2 * n2) bf16, pairs
// (t, k / 16, n2) int32, colsum (t, 2 * n2) and scales (t,) fp32; buf:
// bd_pair_delta_scratch_bytes(bsz, k) bytes; out (bsz, 2 * n2) fp32. The
// prep, then the main kernel once a slab of FP_SLAB rows (each slab after
// the first waits for the one before).
extern "C" int bd_fused_base_pair_tc(const void* x, int x_stride,
                                     const void* w, const void* pairs,
                                     const void* colsum, const void* scales,
                                     const void* ids, int ids64, void* buf,
                                     void* out, int bsz, int k, int n2,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = (k + PAIR_CHUNK - 1) / PAIR_CHUNK;
  if (bsz < 1 || k < 16 || k % 16 != 0 || n2 < 128 || n2 % 128 != 0
      || x_stride % 8 != 0 || ((uintptr_t)x % 16) != 0
      || ((uintptr_t)w % 16) != 0 || ((uintptr_t)pairs % 16) != 0
      || ((uintptr_t)buf % 16) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  uint8_t* planes = static_cast<uint8_t*>(buf);
  float* coef = reinterpret_cast<float*>(planes + (size_t)bsz * n_chunks
                                                  * PAIR_XCHUNK);
  CUtensorMap wmap;
  // Boxes of FP_KS rows x FP_BJ columns, the 64-byte swizzle.
  err = w_tensor_map(&wmap, w, k, 2 * n2, FP_BJ, FP_KS,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  err = launch_pair_prep<__nv_bfloat16>(x, x_stride, 1, scales, ids, ids64,
                                        planes, coef, bsz, k, n_chunks, s);
  for (int row0 = 0; row0 < bsz && err == cudaSuccess; row0 += FP_SLAB) {
    const int slab = bsz - row0 < FP_SLAB ? bsz - row0 : FP_SLAB;
    if (slab <= 8)
      err = launch_fused_pair_tc<1>(wmap, x, x_stride, planes, pairs, ids,
                                    ids64, coef, colsum, out, bsz, row0,
                                    slab, k, n2, dev, sms, s);
    else if (slab <= 16)
      err = launch_fused_pair_tc<2>(wmap, x, x_stride, planes, pairs, ids,
                                    ids64, coef, colsum, out, bsz, row0,
                                    slab, k, n2, dev, sms, s);
    else
      err = launch_fused_pair_tc<4>(wmap, x, x_stride, planes, pairs, ids,
                                    ids64, coef, colsum, out, bsz, row0,
                                    slab, k, n2, dev, sms, s);
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// 3, bf16: the tensor-core kernel of the tenant-routed dense matmul (the
// design note stands at section 3). A block: one work unit (a distinct
// tenant and up to NT * 8 of its rows), one K split, DN_COLS columns.
// ---------------------------------------------------------------------------

constexpr int DN_BOXES = 2;                 // 64-column W boxes a block
constexpr int DN_WARPS = 4 * DN_BOXES;      // a warp: 16 columns
constexpr int DN_THREADS = DN_WARPS * 32;
constexpr int DN_COLS = 64 * DN_BOXES;      // output columns a block
constexpr int DN_KS = 128;                  // K a ring stage
constexpr int DN_STAGES = 2;                // stages in the ring
constexpr int DN_SLAB = 128;                // rows a launch takes
constexpr int DN_MAX_NT = 4;                // n8 tiles a unit at most
constexpr int DN_MAX_SPLITS = 8;            // a portable cluster
constexpr int DN_HALF_BLOCKS_PER_SM = 7;    // the split's aim: 3.5 an SM
constexpr int DN_WBOX = DN_KS * 128;        // bytes of a W box (64 columns)
constexpr int DN_XROW = DN_KS * 2 + 16;     // bytes of a shared x row
constexpr int DN_PSTRIDE = DN_COLS + 4;     // floats of a partials row
static_assert(DN_THREADS >= DN_SLAB, "a thread a row of the slab");
static_assert(DN_KS % 32 == 0 && DN_KS <= 256, "k16 steps in pairs; a box");
static_assert(DN_STAGES >= 2, "a ring");
static_assert(DN_MAX_NT == 4 || DN_MAX_NT == 8, "units of 32 or 64 rows");

// Byte offsets in a ring stage (1024-byte aligned, as the 128-byte
// swizzle needs): the W boxes, then the unit's x rows.
template <int NT>
struct DnStage {
  static constexpr int X = DN_BOXES * DN_WBOX;
  static constexpr int BYTES = (X + NT * 8 * DN_XROW + 1023) / 1024 * 1024;
};

// A TMA copy of the box at (column c0, row r0, plane p) of a 3-D tensor
// map into shared memory, completing on barrier bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int r0, int p, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
         "r"(p), "r"(bar) : "memory");
}

// Block (tile * units + unit, split) over the slab row0 .. row0 + slab - 1.
template <int NT>
__global__ void __launch_bounds__(DN_THREADS)
tenant_dense_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __nv_bfloat16* __restrict__ x, int x_stride,
                       const void* __restrict__ ids, int ids64,
                       float* __restrict__ out, int row0, int slab,
                       int units, int k, int n) {
  namespace cg = cooperative_groups;
  constexpr int R = NT * 8;                    // row slots
  using S = DnStage<NT>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t wbar[DN_STAGES];
  __shared__ int sid[DN_SLAB], first[DN_SLAB], sd[DN_SLAB], srank[DN_SLAB];
  __shared__ int units_of[DN_SLAB];
  __shared__ int slot_row[R];
  __shared__ int s_t, s_d, s_c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int unit = blockIdx.x % units, split = blockIdx.y;
  const int n_split = gridDim.y;
  const int c0 = blockIdx.x / units * DN_COLS;
  const int n_st = (k + DN_KS - 1) / DN_KS;
  const int st0 = (int)((long long)split * n_st / n_split);
  const int n_it = (int)((long long)(split + 1) * n_st / n_split) - st0;
  // The ring from the first 1024-byte boundary (the allocation has 1024
  // bytes to spare); stage s's W boxes complete on wbar[s].
  uint8_t* ring = smem_raw + ((1024u - static_cast<uint32_t>(
      __cvta_generic_to_shared(smem_raw)) % 1024u) % 1024u);
  const uint32_t bar0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(wbar));
  const CUtensorMap* wmp = &wmap;
  if (tid == 0) {
    for (int st = 0; st < DN_STAGES; ++st) mbar_init(bar0 + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    s_t = -1;
  }

  // The unit: tenants by rank d (order of first occurrence), each cut
  // into ceil(count / R) units of R rows in row order, d before d + 1.
  if (tid < slab) sid[tid] = load_id(ids, ids64, row0 + tid);
  if (tid < R) slot_row[tid] = -1;
  __syncthreads();
  if (tid < slab) {
    int f = 0;
    while (sid[f] != sid[tid]) ++f;
    first[tid] = f;
  }
  __syncthreads();
  if (tid < slab) {
    int d = 0, r = 0;
    for (int j = 0; j < tid; ++j) {
      d += j < first[tid] && first[j] == j;
      r += first[j] == first[tid];
    }
    sd[tid] = d;
    srank[tid] = r;                            // the row's place in its tenant
    if (first[tid] == tid) {
      int count = 1;
      for (int j = tid + 1; j < slab; ++j) count += first[j] == tid;
      units_of[d] = (count + R - 1) / R;
    }
  }
  __syncthreads();
  if (tid < slab && first[tid] == tid) {
    const int d = sd[tid];
    int before = 0;
    for (int e = 0; e < d; ++e) before += units_of[e];
    if (unit >= before && unit < before + units_of[d]) {
      s_t = sid[tid];
      s_d = d;
      s_c = unit - before;
    }
  }
  __syncthreads();
  const int t = s_t;
  if (t < 0) return;                           // no such unit: the whole cluster
  if (tid < slab && sd[tid] == s_d && srank[tid] / R == s_c)
    slot_row[srank[tid] % R] = tid;
  __syncthreads();

  // Stage it: W rows k0 .. k0 + DN_KS - 1 of tenant t at the tile's
  // columns (one box a 64 columns, rows past k and columns past n zero)
  // and the unit's x rows at the same K (slots past the unit zero).
  auto load_stage = [&](int it) {
    const int slot = it % DN_STAGES;
    uint8_t* st = ring + slot * S::BYTES;
    const int k0 = (st0 + it) * DN_KS;
    if (tid == 0) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(st));
      // The stage was read (ldmatrix) before the block's last barrier.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar0 + 8 * slot, DN_BOXES * DN_WBOX);
#pragma unroll
      for (int b = 0; b < DN_BOXES; ++b)
        tma_load_3d(dst + b * DN_WBOX, wmp, c0 + 64 * b, k0, t,
                    bar0 + 8 * slot);
    }
    uint8_t* xs = st + S::X;
    constexpr int XCH = DN_KS * 2 / 16;        // 16-byte copies an x row
    for (int i = tid; i < R * XCH; i += DN_THREADS) {
      const int r = i / XCH, c = i % XCH;
      const int row = slot_row[r];
      const bool ok = row >= 0 && k0 + 8 * c < k;
      cp_async16(xs + r * DN_XROW + 16 * c,
                 x + (ok ? (size_t)(row0 + row) * x_stride + k0 + 8 * c
                         : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < DN_STAGES - 1; ++s) {
    if (s < n_it) load_stage(s);
    cp_async_commit();
  }

  // ldmatrix.trans of W: lane l gives row (l / 16) * 8 + l % 8 of the k16
  // step, 16-byte chunk 2 (warp % 4) + (l / 8) % 2 of box warp / 4: a0
  // (columns 16w + g, K 2t..), a1 (columns 16w + 8 + g), a2 (K 2t + 8..),
  // a3. A box row is 128 bytes, its chunk c stored at c ^ (row % 8) (the
  // 128-byte swizzle), which leaves the 8 rows of a matrix in 8 distinct
  // bank groups; row % 8 = l % 8 at every k16 step.
  const uint32_t w_lane =
      (warp / 4) * DN_WBOX + ((lane / 16) * 8 + lane % 8) * 128
      + (((2 * (warp % 4) + (lane / 8) % 2) ^ (lane % 8)) * 16);
  // ldmatrix of x: lane l gives slot row l % 8 of an n8 tile at K
  // 8 * (l / 8) of two k16 steps: b0, b1 of the first, b0, b1 of the
  // second.
  const uint32_t x_lane = (lane % 8) * DN_XROW + (lane / 8) * 16;

  float tot[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[nt][e] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<DN_STAGES - 2>();            // stage it's x has landed
    __syncthreads();                           // and stage it - 1 is read
    {
      const int nx = it + DN_STAGES - 1;
      if (nx < n_it) load_stage(nx);
      cp_async_commit();
    }
    const int slot = it % DN_STAGES;
    const uint8_t* stp = ring + slot * S::BYTES;
    mbar_wait(bar0 + 8 * slot, (it / DN_STAGES) & 1);
    // DN_KS / 16 MMAs a tile into a fresh accumulator.
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DN_KS / 16; kk += 2) {
      uint32_t a0[4], a1[4];
      ldsm_x4<true>(a0, stp + kk * 16 * 128 + w_lane);
      ldsm_x4<true>(a1, stp + (kk + 1) * 16 * 128 + w_lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[4];
        ldsm_x4<false>(b, stp + S::X + nt * 8 * DN_XROW + kk * 32 + x_lane);
        mma_16816(acc[nt], a0, b[0], b[1]);
        mma_16816(acc[nt], a1, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[nt][e] = __fadd_rn(tot[nt][e], acc[nt][e]);
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is free

  // The partials in shared memory, [slot][column] (D: lane (g, tq) holds
  // slots 8nt + 2tq, + 1 at columns 16w + g and 16w + 8 + g); then block
  // q of the cluster adds, for its DN_COLS / n_split columns, every
  // block's partials in rank order and writes the unit's rows.
  float* pb = reinterpret_cast<float*>(ring);
  const int col = 64 * (warp / 4) + 16 * (warp % 4) + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * tq + e;
      pb[r * DN_PSTRIDE + col] = tot[nt][e];
      pb[r * DN_PSTRIDE + col + 8] = tot[nt][2 + e];
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* rb[DN_MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < DN_MAX_SPLITS; ++r)
    rb[r] = cluster.map_shared_rank(pb, r < n_split ? r : 0);
  const int slice = DN_COLS / n_split, cs = split * slice;
  for (int i = tid; i < R * slice; i += DN_THREADS) {
    const int r = i / slice, c = cs + i % slice;
    const int row = slot_row[r];
    if (row < 0 || c0 + c >= n) continue;
    float v[DN_MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < DN_MAX_SPLITS; ++q)
      v[q] = q < n_split ? rb[q][r * DN_PSTRIDE + c] : 0.0f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < DN_MAX_SPLITS; ++q)
      if (q < n_split) sum = __fadd_rn(sum, v[q]);   // in rank order
    out[(size_t)(row0 + row) * n + c0 + c] = sum;
  }
  cluster.sync();                              // the partials stay until read
}

// W (t, k, n) bf16 row-major as a 3-D map (n, k, t) of boxes {64, DN_KS,
// 1} with the 128-byte swizzle; rows past k and columns past n read as
// zeros.
static cudaError_t w_stack_tensor_map(CUtensorMap* map, const void* w, int t,
                                      int k, int n) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)k, (cuuint64_t)t};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 2, (cuuint64_t)k * n * 2};
  const cuuint32_t box[3] = {64, DN_KS, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel over rows row0 .. row0 + slab - 1: grid (tiles * units,
// splits), with units the most the slab can hold (min(slab, t) distinct
// tenants plus one for each further R rows); K splits, the largest power
// of two (at most DN_MAX_SPLITS and the stages) that keeps the grid
// within DN_HALF_BLOCKS_PER_SM / 2 blocks a multiprocessor and within one
// wave of resident blocks.
template <int NT>
static cudaError_t launch_dense_tc(const CUtensorMap& wmap, const void* x,
                                   int x_stride, const void* ids, int ids64,
                                   void* out, int row0, int slab, int k,
                                   int n, int t, int dev, int sms,
                                   cudaStream_t s) {
  static std::atomic<unsigned long long> limit_set{0};
  static std::atomic<int> live_cache{0};
  constexpr int smem = DnStage<NT>::BYTES * DN_STAGES + 1024;
  static_assert(DnStage<NT>::BYTES * DN_STAGES >= NT * 8 * DN_PSTRIDE * 4,
                "the partials of the unit's rows fit in the ring");
  const void* fn = (const void*)tenant_dense_tc_kernel<NT>;
  cudaError_t err = smem_limit_once(fn, smem, dev, limit_set);
  if (err != cudaSuccess) return err;
  int live = live_cache.load();
  if (live == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&live, fn,
                                                        DN_THREADS, smem);
    if (err != cudaSuccess) return err;
    live = live < 1 ? 1 : live;
    live_cache.store(live);
  }
  const int tiles = (n + DN_COLS - 1) / DN_COLS;
  const int lead = slab < t ? slab : t;
  const int units = lead + (slab - lead) / (NT * 8);
  const int n_st = (k + DN_KS - 1) / DN_KS;
  const int cap = n_st < DN_MAX_SPLITS ? n_st : DN_MAX_SPLITS;
  const int aim = (DN_HALF_BLOCKS_PER_SM < 2 * live ? DN_HALF_BLOCKS_PER_SM
                                                    : 2 * live) * sms;
  const long long blocks = (long long)tiles * units;
  int splits = 1;
  while (splits * 2 <= cap && 2 * blocks * splits * 2 <= aim) splits *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * units, splits, 1);
  cfg.blockDim = dim3(DN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tenant_dense_tc_kernel<NT>, wmap,
                           (const __nv_bfloat16*)x, x_stride, ids, ids64,
                           (float*)out, row0, slab, units, k, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// bf16 x (bsz, k) with row stride x_stride, W (t, k, n) bf16, ids (bsz,)
// int32 or int64 (ids64); out (bsz, n) fp32. K and N multiples of 8. One
// launch for each DN_SLAB rows.
extern "C" int bd_tenant_dense_tc(const void* x, int x_stride, const void* w,
                                  const void* ids, int ids64, void* out,
                                  int bsz, int k, int n, int t,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bsz < 1 || t < 1 || k < 8 || k % 8 != 0 || n < 8 || n % 8 != 0
      || x_stride % 8 != 0
      || ((uintptr_t)x % 16) != 0 || ((uintptr_t)w % 16) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap wmap;
  err = w_stack_tensor_map(&wmap, w, t, k, n);
  for (int row0 = 0; row0 < bsz && err == cudaSuccess; row0 += DN_SLAB) {
    const int slab = bsz - row0 < DN_SLAB ? bsz - row0 : DN_SLAB;
    if (slab <= 8)
      err = launch_dense_tc<1>(wmap, x, x_stride, ids, ids64, out, row0,
                               slab, k, n, t, dev, sms, s);
    else if (slab <= 16)
      err = launch_dense_tc<2>(wmap, x, x_stride, ids, ids64, out, row0,
                               slab, k, n, t, dev, sms, s);
    else if (slab <= 32 || DN_MAX_NT == 4)
      err = launch_dense_tc<4>(wmap, x, x_stride, ids, ids64, out, row0,
                               slab, k, n, t, dev, sms, s);
    else
      err = launch_dense_tc<DN_MAX_NT>(wmap, x, x_stride, ids, ids64, out,
                                       row0, slab, k, n, t, dev, sms, s);
  }
  return (int)err;
}

// ---------------------------------------------------------------------------
// 9 on the tensor cores (bf16 x and W, N a multiple of 8):
// bd_fused_tenant_tc
//    Y[b] = x[b] @ W + scale[ids[b]] * (x[b] @ sign(P[ids[b]]))
// replaces bitdelta_tpu/ops/pallas_binary_gemm.py
// ::fused_tenant_matmul_pallas: W (K, N) natural layout, P the canonical
// layout (T, K/32, N) int32 (bit s of word (kw, n) set: +1 at K = 32 kw +
// s), the delta a float dot of x with ±1 in x's dtype, summed in fp32 (no
// x grid), then y = base + scale * delta in fp32.
//
// Bound on the H100: bytes. A Mistral-7B layer at B = 8 over 3 tenants
// reads its bf16 base once (436 MB) and the distinct tenants' words (3 x
// 27 MB): 0.155 ms at 3.35 TB/s, against 2 * (2 B K N) = 7 GFLOP of base
// and delta products (7 us at the bf16 rate). So W streams at the memory
// rate, read once for all the rows, and both products ride under it on
// the bf16 tensor cores. One launch a slab of FT_SLAB rows, nothing else:
//
// * the tile is row 3's: a block owns FT_COLS = 128 columns (two 64-column
//   W boxes by TMA with the 128-byte swizzle; a warp 16 columns, one m16
//   tile), every row of the slab (NT n8 tiles) and one K split, in an
//   FT_STAGES-deep ring of FT_KS-deep stages;
// * the base on mma.sync.m16n8k16 (bf16, fp32 sums): W is the A operand
//   by ldmatrix.trans, the slab's x rows the n8 side by ldmatrix;
// * the delta on the same MMA, sharing that x fragment: its A operand is
//   the ±1 sign matrix of one tenant (m16 rows = the warp's columns, k =
//   K), built in registers from the canonical words. Lane (g, t) of k16
//   step e of a 32-K word needs bits 16e + 2t, + 1 (a0, a1) and 16e + 2t
//   + 8, + 9 (a2, a3) of the words of columns 16w + g (a0, a2) and 16w + 8
//   + g (a1, a3): one word serves two k16 steps, and each bit becomes an
//   exact bf16 ±1 (0xBF80 with the sign flipped where the bit is set), two
//   to a register, by one prmt and one logic op a register;
// * slots and masks: the slab's rows are ordered into slots by tenant
//   (rank d, order of first occurrence; the x rows are staged by slot), so
//   an n8 tile of 8 slots mostly holds one tenant. For tenant d, B is the
//   x fragment with each lane's registers zeroed unless its column's slot
//   (8 nt + g) belongs to d, so each D column sums its own tenant's signs
//   only; the delta MMAs of a tile run only for the tenants it holds. A NaN
//   in one row's x reaches that row's D columns alone, as in JAX's masked
//   per-row accumulation;
// * words: each distinct tenant's words of the tile are read once, by
//   16-byte cp.async copies into the stage (FT_KS / 32 word rows of 128
//   columns a tenant); a stage holds the words of FT_DT tenants, and a
//   slab with more walks its K range once more for each further FT_DT
//   (words and x only);
// * each stage sums both products into fresh fp32 accumulators that are
//   then added to the running sums (the tensor cores truncate as they
//   accumulate, as rows 3, 5, 6, 8 and 10 do);
// * the K splits of a column tile form one thread block cluster (at most
//   FT_MAX_SPLITS, portable): each block leaves its fp32 base and delta
//   partials in shared memory ([slot][column]); after a cluster barrier
//   block q adds, for its ceil(FT_COLS / n_split) columns, every block's
//   partials in rank order and writes y = base + scale * delta (round-to-
//   nearest ops, the plain version's order). No atomics, no scratch, no
//   second launch: the result does not depend on scheduling. The split
//   count is the most (any count, not only a power of two) that keeps
//   the grid within one wave of resident blocks, and whose clusters the
//   card holds all at once (a cluster's blocks share a GPC: at 2 blocks an SM the H100
//   holds fewer than 32 clusters of 8, so the 32 tiles of a 4096-wide
//   projection take clusters of 7; one past what the card holds would
//   wait for a second wave). At B = 8 that is 2 splits for gate/up_proj,
//   7 for q/o/down_proj and 8 for k/v_proj; scripts/sweep_fused_tenant.py
//   sized the stage, the ring and the tenants a stage (PERF.md);
// * any B: a launch takes a slab of up to FT_SLAB rows, and each slab reads
//   W once more. K past the end reads as zeros (W by TMA, x and the words
//   by zero-filled copies).
// tests/test_torch_fused_tenant_numerics.py models the fragments, the
// slots and masks, the cluster's sum and the kernel's arithmetic on the
// CPU.
// ---------------------------------------------------------------------------

constexpr int FT_BOXES = 2;                 // 64-column W boxes a block
constexpr int FT_WARPS = 4 * FT_BOXES;      // a warp: 16 columns
constexpr int FT_THREADS = FT_WARPS * 32;
constexpr int FT_COLS = 64 * FT_BOXES;      // output columns a block
constexpr int FT_KS = 128;                  // K a ring stage
constexpr int FT_STAGES = 2;                // stages in the ring
constexpr int FT_SLAB = 32;                 // rows a launch takes
constexpr int FT_DT = 4;                    // tenants' words a stage holds
constexpr int FT_MAX_SPLITS = 8;            // a portable cluster
constexpr int FT_WBOX = FT_KS * 128;        // bytes of a W box (64 columns)
constexpr int FT_XROW = FT_KS * 2 + 16;     // bytes of a shared x row
constexpr int FT_WROWS = FT_KS / 32;        // word rows a stage and tenant
constexpr int FT_PROW = FT_COLS * 4;        // bytes of a shared word row
constexpr int FT_PSTRIDE = FT_COLS + 4;     // floats of a partials row
static_assert(FT_THREADS >= FT_SLAB, "a thread a row of the slab");
static_assert(FT_KS % 32 == 0 && FT_KS <= 256, "whole words; a box");
static_assert(FT_STAGES >= 2, "a ring");
static_assert(FT_SLAB <= 32 && 32 % FT_DT == 0,
              "a tenant rank (up to a pass's last) fits a 32-bit mask");

// Byte offsets in a ring stage (1024-byte aligned, as the 128-byte
// swizzle needs): the W boxes, the slots' x rows, the words.
template <int NT>
struct FtStage {
  static constexpr int X = FT_BOXES * FT_WBOX;
  static constexpr int WORDS = X + NT * 8 * FT_XROW;
  static constexpr int BYTES =
      (WORDS + FT_DT * FT_WROWS * FT_PROW + 1023) / 1024 * 1024;
};

// Pair J of the four ±1 bf16 pairs that lane t takes from a 32-K word w,
// given u = w << (7 - 2t) and v = w << (6 - 2t): bits 2t + 8J (low half)
// and 2t + 8J + 1 (high half), a set bit +1. u holds bit 2t + 8J at bit 7
// of byte J and v bit 2t + 8J + 1; one prmt with sign-replicating
// selectors spreads them over bytes 1 and 3 (0xFF where set), and the XOR
// flips the sign bit of a bf16 -1 (0xBF80) there.
template <int J>
__device__ __forceinline__ uint32_t sign_pair(uint32_t u, uint32_t v) {
  constexpr uint32_t sel = ((0xCu + J) << 12) | ((0x8u + J) << 4);
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(m) : "r"(u), "r"(v), "n"(sel));
  return 0xBF80BF80u ^ (m & 0x80008000u);
}

// Block (tile, split): FT_COLS columns, every row of the slab row0 ..
// row0 + slab - 1, one K range.
template <int NT>
__global__ void __launch_bounds__(FT_THREADS)
fused_tenant_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __nv_bfloat16* __restrict__ x, int x_stride,
                       const uint32_t* __restrict__ packed,
                       const float* __restrict__ scales,
                       const void* __restrict__ ids, int ids64,
                       float* __restrict__ out, int row0, int slab, int k,
                       int n) {
  namespace cg = cooperative_groups;
  constexpr int ROWS = NT * 8;                 // row slots
  using S = FtStage<NT>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t wbar[FT_STAGES];
  __shared__ int sid[ROWS], first[ROWS], sd[ROWS];
  __shared__ int slot_row[ROWS], slot_d[ROWS], d_tenant[ROWS];
  __shared__ unsigned tmask[NT];
  __shared__ float salpha[ROWS];
  __shared__ int s_nd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int k32 = k / 32;
  const int c0 = blockIdx.x * FT_COLS;
  const int n_st = (k + FT_KS - 1) / FT_KS;
  const int st0 = (int)((long long)split * n_st / n_split);
  const int n_h = (int)((long long)(split + 1) * n_st / n_split) - st0;
  // The ring from the first 1024-byte boundary (the allocation has 1024
  // bytes to spare); stage s's W boxes complete on wbar[s].
  uint8_t* ring = smem_raw + ((1024u - static_cast<uint32_t>(
      __cvta_generic_to_shared(smem_raw)) % 1024u) % 1024u);
  const uint32_t bar0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(wbar));
  const CUtensorMap* wmp = &wmap;
  if (tid == 0) {
    for (int st = 0; st < FT_STAGES; ++st) mbar_init(bar0 + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // Slots: the slab's rows ordered by their tenant's rank d among the
  // distinct tenants (order of first occurrence), then by row.
  if (tid < slab) sid[tid] = load_id(ids, ids64, row0 + tid);
  __syncthreads();
  if (tid < slab) {
    int f = 0;
    while (sid[f] != sid[tid]) ++f;
    first[tid] = f;
  }
  __syncthreads();
  if (tid < slab) {
    int d = 0;
    for (int j = 0; j < first[tid]; ++j) d += first[j] == j;
    sd[tid] = d;
  }
  __syncthreads();
  if (tid < slab) {
    int slot = 0;
    for (int j = 0; j < slab; ++j)
      slot += sd[j] < sd[tid] || (sd[j] == sd[tid] && j < tid);
    slot_row[slot] = tid;
    slot_d[slot] = sd[tid];
    salpha[slot] = scales[sid[tid]];
    if (first[tid] == tid) d_tenant[sd[tid]] = sid[tid];
  } else if (tid < ROWS) {
    slot_row[tid] = 0;                         // slots past the slab
    slot_d[tid] = -1;
    salpha[tid] = 0.0f;
  }
  __syncthreads();
  if (tid < NT) {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (slot_d[8 * tid + i] >= 0) m |= 1u << slot_d[8 * tid + i];
    tmask[tid] = m;
  }
  if (tid == 0) {
    int nd = 0;
    for (int j = 0; j < slab; ++j) nd += first[j] == j;
    s_nd = nd;
  }
  __syncthreads();
  const int nd = s_nd;
  const int n_items = (nd + FT_DT - 1) / FT_DT * n_h;

  // Item it: pass it / n_h (tenants FT_DT * pass ..), stage st0 + it %
  // n_h. Pass 0 brings W (TMA), every pass the slots' x rows and the
  // pass's words.
  auto load_stage = [&](int it) {
    const int pass = it / n_h, slot = it % FT_STAGES;
    uint8_t* sp = ring + slot * S::BYTES;
    const int k0 = (st0 + it % n_h) * FT_KS;
    if (pass == 0 && tid == 0) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(sp));
      // The stage was read (ldmatrix) before the block's last barrier.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar0 + 8 * slot, FT_BOXES * FT_WBOX);
#pragma unroll
      for (int b = 0; b < FT_BOXES; ++b)
        tma_load_2d(dst + b * FT_WBOX, wmp, c0 + 64 * b, k0,
                    bar0 + 8 * slot);
    }
    constexpr int XCH = FT_KS * 2 / 16;        // 16-byte copies an x row
    for (int i = tid; i < ROWS * XCH; i += FT_THREADS) {
      const int r = i / XCH, c = i % XCH;
      const bool ok = r < slab && k0 + 8 * c < k;
      cp_async16(sp + S::X + r * FT_XROW + 16 * c,
                 x + (ok ? (size_t)(row0 + slot_row[r]) * x_stride + k0
                           + 8 * c : 0), ok);
    }
    const int dp = pass * FT_DT;
    const int count = nd - dp < FT_DT ? nd - dp : FT_DT;
    constexpr int CH = FT_PROW / 16;           // 16-byte copies a word row
    for (int i = tid; i < count * FT_WROWS * CH; i += FT_THREADS) {
      const int j = i / (FT_WROWS * CH), r = (i / CH) % FT_WROWS;
      const int c = i % CH;
      const int kw = k0 / 32 + r, col = c0 + 4 * c;
      const bool ok = kw < k32 && col < n;
      cp_async16(sp + S::WORDS + (j * FT_WROWS + r) * FT_PROW + 16 * c,
                 packed + (ok ? ((size_t)d_tenant[dp + j] * k32 + kw) * n
                                + col : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < FT_STAGES - 1; ++s) {
    if (s < n_items) load_stage(s);
    cp_async_commit();
  }

  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  // ldmatrix.trans of W, as row 3: lane l gives row (l / 16) * 8 + l % 8
  // of the k16 step, 16-byte chunk 2 (warp % 4) + (l / 8) % 2 of box
  // warp / 4, stored at that chunk ^ (l % 8) (the 128-byte swizzle): a0
  // (columns 16w + g, K 2t..), a1 (columns 16w + 8 + g), a2 (K 2t + 8..),
  // a3.
  const uint32_t w_lane =
      (warp / 4) * FT_WBOX + ((lane / 16) * 8 + lane % 8) * 128
      + (((2 * (warp % 4) + (lane / 8) % 2) ^ (lane % 8)) * 16);
  // ldmatrix of x: lane l gives slot l % 8 of an n8 tile at K 8 * (l / 8)
  // of two k16 steps: b0, b1 of the first, b0, b1 of the second.
  const uint32_t x_lane = (lane % 8) * FT_XROW + (lane / 8) * 16;
  // The words of columns 16w + g (a0, a2) and 16w + 8 + g (a1, a3).
  const uint32_t p_lane = (16 * warp + g) * 4;
  // The tenant rank of the lane's B column (slot 8 nt + g) in each tile,
  // and each tile's ranks.
  int my_d[NT];
  unsigned tm[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    my_d[nt] = slot_d[8 * nt + g];
    tm[nt] = tmask[nt];
  }

  float tb[NT][4], td[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tb[nt][e] = td[nt][e] = 0.0f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<FT_STAGES - 2>();            // item it has landed
    __syncthreads();                           // and item it - 1 is read
    {
      const int nx = it + FT_STAGES - 1;
      if (nx < n_items) load_stage(nx);
      cp_async_commit();
    }
    const int slot = it % FT_STAGES;
    const uint8_t* stp = ring + slot * S::BYTES;
    const uint32_t st = ring_s + slot * S::BYTES;
    const int pass = it / n_h, dp = pass * FT_DT;
    if (pass == 0) mbar_wait(bar0 + 8 * slot, (it / FT_STAGES) & 1);
    // FT_KS / 16 MMAs a tile and product into fresh accumulators.
    float ab[NT][4], ad[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ab[nt][e] = ad[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < FT_KS / 16; kk += 2) {
      uint32_t b[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ldsm_x4<false>(b[nt], stp + S::X + nt * 8 * FT_XROW + kk * 32
                              + x_lane);
      if (pass == 0) {
        uint32_t a0[4], a1[4];
        ldsm_x4<true>(a0, stp + kk * 16 * 128 + w_lane);
        ldsm_x4<true>(a1, stp + (kk + 1) * 16 * 128 + w_lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_16816(ab[nt], a0, b[nt][0], b[nt][1]);
          mma_16816(ab[nt], a1, b[nt][2], b[nt][3]);
        }
      }
      // The delta: word row kk / 2 (k16 steps kk and kk + 1) of each of
      // the pass's tenants, against the slots of that tenant alone. The
      // signs of every one of the FT_DT come in straight-line code (a
      // tenant past the slab's has no slot, so its stale words meet no
      // MMA): no branch keeps the loads of one tenant from overlapping the
      // MMAs of the one before.
#pragma unroll
      for (int j = 0; j < FT_DT; ++j) {
        const int d = dp + j;
        const uint32_t wa = st + S::WORDS + (j * FT_WROWS + kk / 2) * FT_PROW
                            + p_lane;
        const uint32_t wlo = lds32(wa), whi = lds32(wa + 32);
        const uint32_t ul = wlo << (7 - 2 * tq), vl = wlo << (6 - 2 * tq);
        const uint32_t uh = whi << (7 - 2 * tq), vh = whi << (6 - 2 * tq);
        // k16 step kk: K 2t.. (pair 0) and 2t + 8.. (pair 1) of the word;
        // step kk + 1: 16 + 2t.. (pair 2) and 24 + 2t.. (pair 3).
        const uint32_t s0[4] = {sign_pair<0>(ul, vl), sign_pair<0>(uh, vh),
                                sign_pair<1>(ul, vl), sign_pair<1>(uh, vh)};
        const uint32_t s1[4] = {sign_pair<2>(ul, vl), sign_pair<2>(uh, vh),
                                sign_pair<3>(ul, vl), sign_pair<3>(uh, vh)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (((tm[nt] >> d) & 1u) == 0u) continue;   // uniform
          const uint32_t m = my_d[nt] == d ? 0xffffffffu : 0u;
          mma_16816(ad[nt], s0, b[nt][0] & m, b[nt][1] & m);
          mma_16816(ad[nt], s1, b[nt][2] & m, b[nt][3] & m);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (pass == 0) tb[nt][e] = __fadd_rn(tb[nt][e], ab[nt][e]);
        td[nt][e] = __fadd_rn(td[nt][e], ad[nt][e]);
      }
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is free

  // The partials in shared memory, [slot][column] (D: lane (g, tq) holds
  // slots 8nt + 2tq, + 1 at columns 16w + g and 16w + 8 + g), the base's
  // then the delta's; then block q of the cluster adds, for its FT_COLS /
  // n_split columns, every block's partials in rank order.
  float* pb = reinterpret_cast<float*>(ring);
  float* pd = pb + ROWS * FT_PSTRIDE;
  const int col = 16 * warp + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * tq + e;
      pb[r * FT_PSTRIDE + col] = tb[nt][e];
      pb[r * FT_PSTRIDE + col + 8] = tb[nt][2 + e];
      pd[r * FT_PSTRIDE + col] = td[nt][e];
      pd[r * FT_PSTRIDE + col + 8] = td[nt][2 + e];
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* rb[FT_MAX_SPLITS];
  const float* rd[FT_MAX_SPLITS];
#pragma unroll
  for (int r = 0; r < FT_MAX_SPLITS; ++r) {
    rb[r] = cluster.map_shared_rank(pb, r < n_split ? r : 0);
    rd[r] = cluster.map_shared_rank(pd, r < n_split ? r : 0);
  }
  const int slice = (FT_COLS + n_split - 1) / n_split, cs = split * slice;
  for (int i = tid; i < slab * slice; i += FT_THREADS) {
    const int r = i / slice, c = cs + i % slice;
    if (c >= FT_COLS || c0 + c >= n) continue;
    float vb[FT_MAX_SPLITS], vd[FT_MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < FT_MAX_SPLITS; ++q) {
      vb[q] = q < n_split ? rb[q][r * FT_PSTRIDE + c] : 0.0f;
      vd[q] = q < n_split ? rd[q][r * FT_PSTRIDE + c] : 0.0f;
    }
    float base = vb[0], delta = vd[0];
#pragma unroll
    for (int q = 1; q < FT_MAX_SPLITS; ++q)
      if (q < n_split) {                       // in rank order
        base = __fadd_rn(base, vb[q]);
        delta = __fadd_rn(delta, vd[q]);
      }
    out[(size_t)(row0 + slot_row[r]) * n + c0 + c] =
        __fadd_rn(base, __fmul_rn(salpha[r], delta));
  }
  cluster.sync();                              // the partials stay until read
}

// The launch of fused_tenant_tc_kernel<NT> for K = k, N = n: its shared
// memory and its K splits, the most (at most FT_MAX_SPLITS and the
// stages) that keep the grid within one wave of resident blocks, and
// whose clusters (one a column tile) the card can all hold at once (a cluster's
// blocks share a GPC, so the card holds fewer clusters of 8 than its
// slots / 8; one cluster more would wait for a second wave).
template <int NT>
static cudaError_t fused_tenant_tc_plan(int k, int n, int dev, int sms,
                                        int* smem, int* splits) {
  static std::atomic<unsigned long long> limit_set{0};
  static std::atomic<int> live_cache{0};
  static std::atomic<int> fit_cache[FT_MAX_SPLITS + 1];
  *smem = FtStage<NT>::BYTES * FT_STAGES + 1024;
  static_assert(FtStage<NT>::BYTES * FT_STAGES
                    >= 2 * NT * 8 * FT_PSTRIDE * 4,
                "the base and delta partials of the slab fit in the ring");
  const void* fn = (const void*)fused_tenant_tc_kernel<NT>;
  cudaError_t err = smem_limit_once(fn, *smem, dev, limit_set);
  if (err != cudaSuccess) return err;
  int live = live_cache.load();
  if (live == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&live, fn,
                                                        FT_THREADS, *smem);
    if (err != cudaSuccess) return err;
    live = live < 1 ? 1 : live;
    live_cache.store(live);
  }
  const int tiles = (n + FT_COLS - 1) / FT_COLS;
  const int n_st = (k + FT_KS - 1) / FT_KS;
  const int cap = n_st < FT_MAX_SPLITS ? n_st : FT_MAX_SPLITS;
  int sp = live * sms / tiles;
  sp = sp < 1 ? 1 : sp > cap ? cap : sp;
  for (; sp > 1; --sp) {
    int fit = fit_cache[sp].load();
    if (fit == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1, sp, 1);
      cfg.blockDim = dim3(FT_THREADS);
      cfg.dynamicSmemBytes = *smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = sp;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&fit, fn, &cfg);
      if (err != cudaSuccess) return err;
      fit_cache[sp].store(fit > 0 ? fit : -1);
    }
    if (fit >= tiles) break;
  }
  *splits = sp;
  return cudaSuccess;
}

// Launches of fused_tenant_tc_kernel since the library was loaded, one a
// slab, counted where they are made (a profiler trace may drop records).
static std::atomic<long long> fused_tenant_tc_launched{0};

extern "C" long long bd_fused_tenant_tc_launched() {
  return fused_tenant_tc_launched.load();
}

// The kernel over rows row0 .. row0 + slab - 1: grid (tiles, splits).
template <int NT>
static cudaError_t launch_fused_tenant_tc(
    const CUtensorMap& wmap, const void* x, int x_stride, const void* packed,
    const void* scales, const void* ids, int ids64, void* out, int row0,
    int slab, int k, int n, int dev, int sms, cudaStream_t s) {
  int smem = 0, splits = 1;
  cudaError_t err = fused_tenant_tc_plan<NT>(k, n, dev, sms, &smem, &splits);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + FT_COLS - 1) / FT_COLS, splits, 1);
  cfg.blockDim = dim3(FT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_tenant_tc_kernel<NT>, wmap,
                           (const __nv_bfloat16*)x, x_stride,
                           (const uint32_t*)packed, (const float*)scales,
                           ids, ids64, (float*)out, row0, slab, k, n);
  if (err != cudaSuccess) return err;
  fused_tenant_tc_launched.fetch_add(1);
  return cudaGetLastError();
}

// The K splits a launch of fused_tenant_tc_kernel takes for a slab of
// `slab` rows at K = k, N = n on the current device (0 on an error).
extern "C" int bd_fused_tenant_tc_splits(int slab, int k, int n) {
  int dev = 0, sms = 0, smem = 0, splits = 0;
  if (current_device(&dev, &sms) != cudaSuccess) return 0;
  const cudaError_t err =
      slab <= 8 ? fused_tenant_tc_plan<1>(k, n, dev, sms, &smem, &splits)
      : slab <= 16 ? fused_tenant_tc_plan<2>(k, n, dev, sms, &smem, &splits)
                   : fused_tenant_tc_plan<4>(k, n, dev, sms, &smem, &splits);
  return err == cudaSuccess ? splits : 0;
}

// bf16 x (bsz, k) with row stride x_stride, W (k, n) bf16, packed (t, k /
// 32, n) int32, scales (t,) fp32, ids (bsz,) int32 or int64 (ids64); out
// (bsz, n) fp32. K a multiple of 32, N a multiple of 8. One launch for
// each FT_SLAB rows.
extern "C" int bd_fused_tenant_tc(const void* x, int x_stride, const void* w,
                                  const void* packed, const void* scales,
                                  const void* ids, int ids64, void* out,
                                  int bsz, int k, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bsz < 1 || k < 32 || k % 32 != 0 || n < 8 || n % 8 != 0
      || x_stride % 8 != 0 || ((uintptr_t)x % 16) != 0
      || ((uintptr_t)w % 16) != 0 || ((uintptr_t)packed % 16) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap wmap;
  // Boxes of FT_KS rows x 64 columns (128 bytes), the 128-byte swizzle.
  err = w_tensor_map(&wmap, w, k, n, 64, FT_KS, CU_TENSOR_MAP_SWIZZLE_128B);
  for (int row0 = 0; row0 < bsz && err == cudaSuccess; row0 += FT_SLAB) {
    const int slab = bsz - row0 < FT_SLAB ? bsz - row0 : FT_SLAB;
    if (slab <= 8)
      err = launch_fused_tenant_tc<1>(wmap, x, x_stride, packed, scales, ids,
                                      ids64, out, row0, slab, k, n, dev, sms,
                                      s);
    else if (slab <= 16)
      err = launch_fused_tenant_tc<2>(wmap, x, x_stride, packed, scales, ids,
                                      ids64, out, row0, slab, k, n, dev, sms,
                                      s);
    else
      err = launch_fused_tenant_tc<4>(wmap, x, x_stride, packed, scales, ids,
                                      ids64, out, row0, slab, k, n, dev, sms,
                                      s);
  }
  return (int)err;
}
