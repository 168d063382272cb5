// Cycles per warp-level tensor-core instruction (mma.sync) on the card:
// one block per SM of `threads` threads; every warp issues `iters` rounds
// of eight independent products (eight accumulators), and thread 0 records
// the block's cycles (clock64) between two barriers.  mode 0: bfloat16
// m16n8k16, 1: tf32 m16n8k8, 2: tf32 m16n8k8 three to a product on one
// accumulator (3xTF32 as flash_fwd_mma and knn_tiled issue it).  Built and
// run by tools/mma_rate.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

template <int MODE>
__global__ void mma_rate_kernel(float* out, long long* cycles, int iters) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x ^ 5u,
                         7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x + 13u;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (MODE == 0) {
        mma_bf16(acc[j], a, b0, b1);
      } else if constexpr (MODE == 1) {
        mma_tf32(acc[j], a, b0, b1);
      } else {
        mma_3xtf32(acc[j], a, a, b0, b1, b1, b0);
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" int mma_rate(int mode, void* out, void* cycles, int iters,
                        int blocks, int threads) {
  float* o = static_cast<float*>(out);
  long long* c = static_cast<long long*>(cycles);
  if (mode == 0)
    mma_rate_kernel<0><<<blocks, threads>>>(o, c, iters);
  else if (mode == 1)
    mma_rate_kernel<1><<<blocks, threads>>>(o, c, iters);
  else
    mma_rate_kernel<2><<<blocks, threads>>>(o, c, iters);
  cudaError_t rc = cudaGetLastError();
  if (rc == cudaSuccess) rc = cudaDeviceSynchronize();
  return (int)rc;
}
