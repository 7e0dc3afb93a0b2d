// Issue rate of the warp-level MMA forms a decode kernel can use on
// Hopper (sm_90a), one CUDA card: each warp runs 8 independent chains of
// one mma.sync form; the card's clock rate turns the time into MMAs per
// clock per SM and cycles per MMA per SM sub-partition. Row 1's kernel
// (bitdelta_torch/csrc/binary_gemm.cu) was chosen from these: the 1-bit
// m16n8k256 form covers 8x the K of the int8 m16n8k32 one at the same
// rate.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//         -o bitdelta_torch/build/mma_rate scripts/mma_rate.cu &&
//     bitdelta_torch/build/mma_rate
//
// Prints one line a form and block size; the numbers depend on the
// card's clock and power limit (nvidia-smi names both).

#include <cuda_runtime.h>
#include <cstdio>
#include <cstdint>
// KIND: 0 int8 m16n8k32 s8.u8, 1 bf16 m16n8k16, 2 fp8 e4m3 m16n8k32,
// 3 int8 m16n8k32 u8.u8, 5 1-bit m16n8k256 and.popc, 6 1-bit m16n8k128,
// else int8 m16n8k16.
template <int KIND>
__global__ void k(int* out, int iters) {
  int acc[8][4] = {};
  float facc[8][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 ^ 9, b1 = a0 ^ 11;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 1)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(facc[j][0]), "+f"(facc[j][1]), "+f"(facc[j][2]), "+f"(facc[j][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 2)
        asm volatile("mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(facc[j][0]), "+f"(facc[j][1]), "+f"(facc[j][2]), "+f"(facc[j][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 3)
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 5)
        asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 6)
        asm volatile("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3]) : "r"(a0), "r"(a1), "r"(b0));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3]) : "r"(a0), "r"(a1), "r"(b0));
    }
  }
  int s = 0;
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) s += acc[j][e] + (int)facc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int KIND> void run(const char* name, int* out, int blocks, int threads) {
  const int iters = 4096;
  k<KIND><<<blocks, threads>>>(out, 16);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  k<KIND><<<blocks, threads>>>(out, iters);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  double mmas = (double)blocks * threads / 32 * iters * 8;
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  double cyc = ms * 1e-3 * clk * 1e3;
  printf("%s blocks %d threads %d: %.3f ms, %.2f MMA/clk/SM, %.1f cycles per MMA per SMSP (err %s)\n", name, blocks, threads, ms,
         mmas / cyc / 132, cyc * 132 * 4 / mmas, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  int* out; cudaMalloc(&out, 1 << 24);
  for (int t : {128, 512}) {
    run<0>("imma.m16n8k32.s8.u8", out, 132 * 4, t);
    run<3>("imma.m16n8k32.u8.u8", out, 132 * 4, t);
    run<4>("imma.m16n8k16.s8.s8", out, 132 * 4, t);
    run<1>("hmma.m16n8k16.bf16  ", out, 132 * 4, t);
    run<2>("mma.m16n8k32.e4m3   ", out, 132 * 4, t);
    run<5>("mma.m16n8k256.b1    ", out, 132 * 4, t);
    run<6>("mma.m16n8k128.b1    ", out, 132 * 4, t);
  }
  return 0;
}
