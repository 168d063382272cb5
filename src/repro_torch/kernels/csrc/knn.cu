// kNN dot-product scores: scores[b, n] = sum_v test[b, v] * train[n, v],
// accumulated in float32 from float32 or bfloat16 inputs.
//
// Replaces the TPU kernel src/repro/kernels/knn.py:knn_scores_pallas (body
// _matmul_kernel).  As there, top-k runs outside the kernel.
//
// What bounds it on the card: on the analytic's path B = 1 (one test
// patient per query), so the work is a matrix-vector product that reads
// train once, N * V * itemsize bytes, with 2 flops per element read: memory
// bound, and at N = 4096, V = 224 so small that launch latency dominates.
// At larger B it tends toward a GEMM, which a later kernel would give to
// the tensor cores.
//
// Design.  One warp per train row, eight warps per block, and a tile of up
// to eight test rows per block staged in shared memory as float32 (V is
// walked in chunks of 1024 so any V fits).  Lanes stride over V so that a
// warp's loads of a train row are contiguous; where V and the pointers
// allow it each lane loads 16 bytes at a time (four floats or eight
// bfloat16s).  Every lane keeps one float32 partial sum per staged test
// row, and a warp shuffle reduction finishes each dot product.  Ragged N,
// B and V are masked.  The summation order differs from the plain version's,
// so float32 results agree to rounding, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // train rows per block
constexpr int kBT = 8;            // test rows per block
constexpr int kVC = 1024;         // V chunk staged in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC consecutive elements starting at p (p aligned to VEC * sizeof(T)
// bytes when VEC > 1) as floats.
template <typename T, int VEC>
struct Loader {
  static __device__ __forceinline__ void load(const T* p, float* w) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) w[e] = to_f32(p[e]);
  }
};

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* w) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* w) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      w[2 * e] = f.x;
      w[2 * e + 1] = f.y;
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
knn_scores_kernel(const T* __restrict__ train, const T* __restrict__ test,
                  float* __restrict__ scores, int n_train, int n_test,
                  int v_len) {
  __shared__ __align__(16) float tst[kBT * kVC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int b0 = blockIdx.y * kBT;
  const int nb = min(kBT, n_test - b0);

  float acc[kBT];
#pragma unroll
  for (int j = 0; j < kBT; ++j) acc[j] = 0.f;

  for (int v0 = 0; v0 < v_len; v0 += kVC) {
    const int vc = min(kVC, v_len - v0);
    for (int i = threadIdx.x; i < nb * vc; i += blockDim.x) {
      const int j = i / vc;
      const int v = i - j * vc;
      tst[j * kVC + v] = to_f32(test[(size_t)(b0 + j) * v_len + v0 + v]);
    }
    __syncthreads();
    if (n < n_train) {
      const T* row = train + (size_t)n * v_len + v0;
      for (int v = lane * VEC; v < vc; v += 32 * VEC) {
        float w[VEC];
        Loader<T, VEC>::load(row + v, w);
#pragma unroll
        for (int j = 0; j < kBT; ++j) {
          if (j < nb) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j] = fmaf(w[e], tst[j * kVC + v + e], acc[j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kBT; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane == 0 && n < n_train) {
    for (int j = 0; j < nb; ++j) scores[(size_t)(b0 + j) * n_train + n] = acc[j];
  }
}

template <typename T, int VEC>
int launch(const void* train, const void* test, float* scores, int n_train,
           int n_test, int v_len, cudaStream_t stream) {
  dim3 grid((unsigned)((n_train + kWarps - 1) / kWarps),
            (unsigned)((n_test + kBT - 1) / kBT));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  knn_scores_kernel<T, VEC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(train), static_cast<const T*>(test), scores,
      n_train, n_test, v_len);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// train: (n_train, v_len), test: (n_test, v_len), both row-major and of
// one dtype (float32 when is_bf16 == 0, else bfloat16); scores: (n_test,
// n_train) float32.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int knn_scores_launch(const void* train, const void* test,
                                 void* scores, int n_train, int n_test,
                                 int v_len, int is_bf16, void* stream) {
  if (n_train < 0 || n_test < 0 || v_len < 0) return (int)cudaErrorInvalidValue;
  if (n_train == 0 || n_test == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(scores);
  const bool vec_ok = aligned16(train);
  if (is_bf16) {
    if (vec_ok && v_len % 8 == 0)
      return launch<__nv_bfloat16, 8>(train, test, out, n_train, n_test,
                                      v_len, s);
    return launch<__nv_bfloat16, 1>(train, test, out, n_train, n_test, v_len,
                                    s);
  }
  if (vec_ok && v_len % 4 == 0)
    return launch<float, 4>(train, test, out, n_train, n_test, v_len, s);
  return launch<float, 1>(train, test, out, n_train, n_test, v_len, s);
}
