// Tensor-core and async-copy helpers shared by the kernels that feed
// mma.sync from shared memory (binary_gemm.cu rows 5 and 6,
// flash_prefill.cu row 4): 16-byte cp.async copies with zero-fill,
// ldmatrix (plain and transposed) and the m16n8k16 bf16 -> fp32 MMA.
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16x16, row-major) a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)
//                        a3: (g+8, 2t+8..);
//   B (16x8, "col")      b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g);
//   C/D (16x8)           c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1);
// each register holds two bf16 values, the lower index in the low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
        : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
