// Cycles an SM takes per wgmma of the shapes the SSD tensor-core kernel
// issues (tf32 m64n64k8 and m64n128k8, A from registers), beside tf32 and
// bf16 m64n64k16 with A from shared memory: one block of one or two
// warpgroups per SM, each issuing groups of G wgmmas into one accumulator
// and waiting for each group, on zeros in shared memory.  Built and run by
// tools/wgmma_rate.py.  It includes the kernel's source for its wrappers.
#include "ssd_scan.cu"

namespace {

// D (64 x 64) += A (64 x 8, tf32) * B (8 x 64, tf32), both from shared
// memory; and the same with bfloat16 at k 16.
__device__ __forceinline__ void wgmma_ss_tf32_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_ss_bf16_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

constexpr int kSmem = 64 * 1024;

// MODE 0: tf32 RS n64; 1: tf32 RS n128; 2: tf32 SS n64; 3: bf16 SS n64.
template <int MODE, int G>
__global__ void __launch_bounds__(256, 1)
rate(float* out, long long* cycles, int iters) {
  extern __shared__ __align__(1024) uint8_t smem[];
  for (int i = threadIdx.x; i < kSmem / 4; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  fence_proxy_async();
  __syncthreads();
  const uint32_t base = smem_u32(smem);
  float d[32] = {0.f};
  float d2[64] = {0.f};
  uint32_t a[4] = {0u, 0u, 0u, 0u};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    fence_regs(d);
    fence_regs(d2);
    fence_regs(a);
    wg_fence();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint64_t db = sw128_desc(base + 8192 * (j & 3), 16, 1024);
      const uint64_t da = sw128_desc(base + 32768 + 32 * (j & 3), 16, 1024);
      if constexpr (MODE == 0) wgmma_tf32_n64(d, a, db);
      if constexpr (MODE == 1) wgmma_tf32_n128(d2, a, db);
      if constexpr (MODE == 2) wgmma_ss_tf32_n64(d, da, db);
      if constexpr (MODE == 3) wgmma_ss_bf16_n64(d, da, db);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(d);
    fence_regs(d2);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += d[i];
  for (int i = 0; i < 64; ++i) s += d2[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int MODE, int G>
int run(float* out, long long* cycles, int iters, int blocks, int threads) {
  cudaError_t e = cudaFuncSetAttribute(
      rate<MODE, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  rate<MODE, G><<<blocks, threads, kSmem>>>(out, cycles, iters);
  return (int)cudaDeviceSynchronize();
}

}  // namespace

// Runs MODE (0-3 as rate's; 4: MODE 0 in groups of 48) on `blocks` blocks
// of `threads` (128 or 256) threads; each block's clock64 cycles land in
// cycles[block].  Returns the CUDA error after synchronising.
extern "C" int wgmma_rate(int mode, float* out, long long* cycles, int iters,
                          int blocks, int threads) {
  switch (mode) {
    case 0: return run<0, 12>(out, cycles, iters, blocks, threads);
    case 1: return run<1, 12>(out, cycles, iters, blocks, threads);
    case 2: return run<2, 12>(out, cycles, iters, blocks, threads);
    case 3: return run<3, 12>(out, cycles, iters, blocks, threads);
    case 4: return run<0, 48>(out, cycles, iters, blocks, threads);
  }
  return (int)cudaErrorInvalidValue;
}
