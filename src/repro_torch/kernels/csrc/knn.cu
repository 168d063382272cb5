// kNN dot-product scores: scores[b, n] = sum_v test[b, v] * train[n, v],
// accumulated in float32 from float32 or bfloat16 inputs.
//
// Replaces the TPU kernel src/repro/kernels/knn.py:knn_scores_pallas (body
// _matmul_kernel).  As there, top-k runs outside the kernel.
//
// What bounds it on the card: the work reads train once, N * V * itemsize
// bytes, and does 2 * B * N * V operations.  On the analytic's path B = 1
// (one test patient per query): a matrix-vector product, memory bound, and
// at N = 4096, V = 224 (3.7 MB in float32) so small that the latency of
// the loads and of the launch dominates.  At larger B the operations grow
// with B and the bytes do not: a product.  Two kernels, chosen by the
// caller (kernels/knn.py: variant) by B:
//
// knn_gemv (B <= 8, kind 0): latency bound.  Each warp takes kGemvRows
//   train rows and issues all their 16-byte loads (non-coherent, no L1
//   allocation: train is read once) before its first FMA, so every byte of
//   train is in flight at once; each lane holds its slice of the B test
//   rows in registers, read once per V chunk (once, where V <= 256 float32
//   or 512 bfloat16).  No shared memory and no barrier.  The grid is a
//   whole number of waves of resident blocks over the SMs, and warps stride
//   over the rows.  A warp shuffle tree finishes each dot product.  One row
//   a warp (two 16-byte loads a lane at V 224 in float32): with four rows a
//   warp the kernel was slower than torch.matmul at N 4096, B 1 (PERF.md);
//   more warps in flight and shorter reductions won.
//
// knn_tiled (B > 8, kind 1): a product on the tensor cores (mma.sync;
//   bfloat16 m16n8k16, float32 as 3xTF32 m16n8k8, see hopper.cuh).  A
//   block of kWM x kWN warps takes kTM train rows against kTB test rows and
//   stages both in shared memory by cp.async, V in chunks of kKC copied in
//   groups of kKG columns, so the products of a group start while the next
//   is in flight; at B <= 64 one block holds every test row, so train is
//   read from device memory once.  Tensor cores rather than the CUDA cores:
//   in float32 at B 64 the CUDA cores' operation bound (0.00175 ms at
//   N 4096, V 224) is above the byte bound (0.0011 ms), 3xTF32's (0.0007
//   ms) is below it.
//
// Ragged N, B and V are masked (rows and columns past the ends read as
// zeros).  The summation order differs from the plain version's, so
// float32 results agree to rounding, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// B <= 8: the matrix-vector kernel
// ---------------------------------------------------------------------------

constexpr int kGemvWarps = 8;     // warps per block
constexpr int kGemvRows = 1;      // train rows per warp at a time
constexpr int kGemvChunks = 2;    // 16-byte loads per lane per row
constexpr int kMaxGemvB = 8;

// VEC consecutive elements at p (aligned to VEC * sizeof(T) bytes when
// VEC > 1) as floats; the train loads bypass L1 (read once).
template <typename T, int VEC>
struct Load {
  static __device__ __forceinline__ void stream(const T* p, float* w) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) w[e] = to_f32(__ldg(p + e));
  }
  static __device__ __forceinline__ void cached(const T* p, float* w) {
    stream(p, w);
  }
};

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void stream(const float* p, float* w) {
    asm volatile(
        "ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
        : "=f"(w[0]), "=f"(w[1]), "=f"(w[2]), "=f"(w[3]) : "l"(p));
  }
  static __device__ __forceinline__ void cached(const float* p, float* w) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  }
};

__device__ __forceinline__ void unpack8(const uint32_t (&u)[4], float* w) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[e]));
    w[2 * e] = f.x;
    w[2 * e + 1] = f.y;
  }
}

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void stream(const __nv_bfloat16* p,
                                                float* w) {
    uint32_t u[4];
    asm volatile(
        "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3]) : "l"(p));
    unpack8(u, w);
  }
  static __device__ __forceinline__ void cached(const __nv_bfloat16* p,
                                                float* w) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
    unpack8(u, w);
  }
};

// NB: test rows held (a template bound >= n_test, so the registers are
// indexed statically).
template <typename T, int VEC, int NB>
__global__ void __launch_bounds__(kGemvWarps * 32)
knn_gemv(const T* __restrict__ train, const T* __restrict__ test,
         float* __restrict__ scores, int n_train, int n_test, int v_len) {
  constexpr int R = kGemvRows;
  constexpr int CH = kGemvChunks;
  constexpr int VC = 32 * VEC * CH;       // V chunk a warp covers at once
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kGemvWarps;
  for (int n0 = (blockIdx.x * kGemvWarps + (threadIdx.x >> 5)) * R;
       n0 < n_train; n0 += warps * R) {
    float acc[R][NB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[r][j] = 0.f;
    for (int v0 = 0; v0 < v_len; v0 += VC) {
      // every train load of the chunk first, then the test slice
      float w[R][CH][VEC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int v = v0 + (c * 32 + lane) * VEC;
          if (n0 + r < n_train && v < v_len) {
            Load<T, VEC>::stream(train + (size_t)(n0 + r) * v_len + v,
                                 w[r][c]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) w[r][c][e] = 0.f;
          }
        }
      float x[NB][CH][VEC];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int v = v0 + (c * 32 + lane) * VEC;
          if (j < n_test && v < v_len) {
            Load<T, VEC>::cached(test + (size_t)j * v_len + v, x[j][c]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) x[j][c][e] = 0.f;
          }
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][j] = fmaf(w[r][c][e], x[j][c][e], acc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (n0 + r < n_train && j < n_test)
            scores[(size_t)j * n_train + n0 + r] = acc[r][j];
    }
  }
}

template <typename T, int VEC, int NB>
int launch_gemv(const void* train, const void* test, float* scores,
                int n_train, int n_test, int v_len, cudaStream_t stream) {
  static int resident = 0;   // blocks an SM holds, once per process
  if (!resident &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, knn_gemv<T, VEC, NB>, kGemvWarps * 32, 0) != cudaSuccess)
    return (int)cudaGetLastError();
  const int sms = sm_count();
  if (!sms || !resident) return (int)cudaErrorInvalidConfiguration;
  // whole waves: as many per SM as the rows need, at most what is resident
  const long long need =
      ((long long)n_train + kGemvWarps * kGemvRows - 1) /
      (kGemvWarps * kGemvRows);
  const long long per_sm =
      std::min<long long>(resident, (need + sms - 1) / sms);
  knn_gemv<T, VEC, NB><<<(unsigned)(per_sm * sms), kGemvWarps * 32, 0,
                         stream>>>(static_cast<const T*>(train),
                                   static_cast<const T*>(test), scores,
                                   n_train, n_test, v_len);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dispatch_gemv(const void* train, const void* test, float* scores,
                  int n_train, int n_test, int v_len, cudaStream_t s) {
  if (n_test <= 1)
    return launch_gemv<T, VEC, 1>(train, test, scores, n_train, n_test, v_len,
                                  s);
  if (n_test <= 2)
    return launch_gemv<T, VEC, 2>(train, test, scores, n_train, n_test, v_len,
                                  s);
  if (n_test <= 4)
    return launch_gemv<T, VEC, 4>(train, test, scores, n_train, n_test, v_len,
                                  s);
  return launch_gemv<T, VEC, 8>(train, test, scores, n_train, n_test, v_len,
                                s);
}

// ---------------------------------------------------------------------------
// B > 8: the tensor-core product
// ---------------------------------------------------------------------------

constexpr int kWM = 2;            // warps along train rows, 16 rows each
constexpr int kWN = 4;            // warps along test rows
constexpr int kTM = 16 * kWM;     // train rows per block
constexpr int kTB = 64;           // test rows per block
constexpr int kNT = kTB / kWN / 8;  // 8-row test tiles a warp (even)
constexpr int kKC = 256;          // V chunk staged at once
constexpr int kKG = 64;           // columns of a chunk copied as one group
static_assert(kKC / kKG <= 4, "cp_async_wait_upto waits for at most 3");
constexpr int kTiledThreads = 32 * kWM * kWN;

// Shared-memory row stride in elements: padded so that the eight rows an
// ldmatrix (bfloat16) or the eight row groups of a fragment load (float32)
// touch fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int tiled_stride() {
  return sizeof(T) == 2 ? kKC + 8 : kKC + 4;
}
template <typename T>
__host__ __device__ constexpr int tiled_smem_bytes() {
  return (kTM + kTB) * tiled_stride<T>() * (int)sizeof(T);
}

// rows [r0, r0 + rows) x columns [v0, v0 + cols) of a (n_rows, v_len)
// matrix into shared memory (stride S), zeros past either end.  VEC: the
// row length and the base allow 16-byte copies (cp.async); else element
// by element.
template <typename T, bool VEC, int S>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0, int rows,
                                      int n_rows, int v0, int cols,
                                      int v_len) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (VEC) {
    const int per_row = cols / E;
    for (int i = threadIdx.x; i < rows * per_row; i += kTiledThreads) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * E;
      const bool in = r0 + r < n_rows && v0 + c < v_len;
      const T* p = in ? src + (size_t)(r0 + r) * v_len + v0 + c : src;
      cp_async16(dst + r * S + c, p, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kTiledThreads) {
      const int r = i / cols;
      const int c = i - r * cols;
      const bool in = r0 + r < n_rows && v0 + c < v_len;
      dst[r * S + c] = in ? src[(size_t)(r0 + r) * v_len + v0 + c] : T(0.f);
    }
  }
}

// Wait until at most n (0..3) committed copy groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// One k-step of a warp's 16 train rows x 8 kNT test rows.
template <typename T, int S>
struct TiledStep;

template <int S>
struct TiledStep<float, S> {
  static constexpr int kK = 8;
  static __device__ __forceinline__ void run(float (&acc)[kNT][4],
                                             const float* a, const float* b,
                                             int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    uint32_t ah[4], al[4];
    const float av[4] = {a[g * S + k0 + t], a[(g + 8) * S + k0 + t],
                         a[g * S + k0 + t + 4], a[(g + 8) * S + k0 + t + 4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* br = b + (8 * j + g) * S + k0;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(br[t], bh0, bl0);
      split_tf32(br[t + 4], bh1, bl1);
      mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
};

template <int S>
struct TiledStep<__nv_bfloat16, S> {
  static constexpr int kK = 16;
  static __device__ __forceinline__ void run(float (&acc)[kNT][4],
                                             const __nv_bfloat16* a,
                                             const __nv_bfloat16* b, int k0,
                                             int lane) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * S + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p) {
      // matrices: (test rows 16p.., k0), (16p.., k0 + 8), (16p + 8.., k0),
      // (16p + 8.., k0 + 8): the B fragments of n-tiles 2p and 2p + 1
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (16 * p + (lane >> 4) * 8 + (lane & 7)) * S + k0 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * p], af, bf[0], bf[1]);
      mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kTiledThreads)
knn_tiled(const T* __restrict__ train, const T* __restrict__ test,
          float* __restrict__ scores, int n_train, int n_test, int v_len) {
  constexpr int S = tiled_stride<T>();
  constexpr int KS = TiledStep<T, S>::kK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);        // [kTM][S] train
  T* bs = as + kTM * S;                          // [kTB][S] test
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % kWM, wn = warp / kWM;    // 16 train x 8 kNT test
  const int n0 = blockIdx.x * kTM;
  const int b0 = blockIdx.y * kTB;

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int v0 = 0; v0 < v_len; v0 += kKC) {
    // the chunk's columns, rounded up to whole k-steps (zeros past V), in
    // groups of kKG copied one after the other: the products of a group
    // start as soon as it has landed, while the later ones are in flight
    const int cols = min(kKC, (v_len - v0 + KS - 1) / KS * KS);
    const int groups = (cols + kKG - 1) / kKG;
    for (int gi = 0; gi < groups; ++gi) {
      const int c0 = gi * kKG, gc = min(kKG, cols - c0);
      stage<T, VEC, S>(as + c0, train, n0, kTM, n_train, v0 + c0, gc, v_len);
      stage<T, VEC, S>(bs + c0, test, b0, kTB, n_test, v0 + c0, gc, v_len);
      if constexpr (VEC) cp_async_commit();
    }
    for (int gi = 0; gi < groups; ++gi) {
      if constexpr (VEC) cp_async_wait_upto(groups - 1 - gi);
      __syncthreads();
      const int c0 = gi * kKG, gc = min(kKG, cols - c0);
      for (int k0 = c0; k0 < c0 + gc; k0 += KS)
        TiledStep<T, S>::run(acc, as + 16 * wm * S, bs + 8 * kNT * wn * S,
                             k0, lane);
    }
    __syncthreads();                             // before the next chunk
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int b = b0 + 8 * kNT * wn + 8 * j + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + 16 * wm + g + 8 * (i >> 1);
      const int bb = b + (i & 1);
      if (n < n_train && bb < n_test)
        scores[(size_t)bb * n_train + n] = acc[j][i];
    }
  }
}

template <typename T, bool VEC>
int launch_tiled(const void* train, const void* test, float* scores,
                 int n_train, int n_test, int v_len, cudaStream_t stream) {
  static int setup = -1;     // once per process (one device)
  if (setup < 0)
    setup = (int)cudaFuncSetAttribute(
        knn_tiled<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tiled_smem_bytes<T>());
  if (setup) return setup;
  dim3 grid((unsigned)((n_train + kTM - 1) / kTM),
            (unsigned)((n_test + kTB - 1) / kTB));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  knn_tiled<T, VEC><<<grid, kTiledThreads, tiled_smem_bytes<T>(), stream>>>(
      static_cast<const T*>(train), static_cast<const T*>(test), scores,
      n_train, n_test, v_len);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Kernels behind knn_scores_launch's `kind`
constexpr int kKindGemv = 0;   // knn_gemv: n_test <= 8
constexpr int kKindTiled = 1;  // knn_tiled: any n_test

template <typename T>
int dispatch(const void* train, const void* test, float* out, int n_train,
             int n_test, int v_len, int kind, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = aligned16(train) && aligned16(test) && v_len % E == 0;
  if (kind == kKindGemv) {
    if (vec) return dispatch_gemv<T, E>(train, test, out, n_train, n_test,
                                        v_len, s);
    return dispatch_gemv<T, 1>(train, test, out, n_train, n_test, v_len, s);
  }
  if (vec) return launch_tiled<T, true>(train, test, out, n_train, n_test,
                                        v_len, s);
  return launch_tiled<T, false>(train, test, out, n_train, n_test, v_len, s);
}

}  // namespace

// train: (n_train, v_len), test: (n_test, v_len), both row-major and of
// one dtype (float32 when is_bf16 == 0, else bfloat16); scores: (n_test,
// n_train) float32.  kind: 0 the matrix-vector kernel (n_test <= 8), 1 the
// tensor-core product.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int knn_scores_launch(const void* train, const void* test,
                                 void* scores, int n_train, int n_test,
                                 int v_len, int is_bf16, int kind,
                                 void* stream) {
  if (n_train < 0 || n_test < 0 || v_len < 0 ||
      (kind != kKindGemv && kind != kKindTiled) ||
      (kind == kKindGemv && n_test > kMaxGemvB))
    return (int)cudaErrorInvalidValue;
  if (n_train == 0 || n_test == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(scores);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(train, test, out, n_train, n_test, v_len,
                                   kind, s);
  return dispatch<float>(train, test, out, n_train, n_test, v_len, kind, s);
}
