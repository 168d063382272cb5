// Multi-level orthonormal Haar DWT along each row of an (N, T) array.
//
// Replaces the TPU kernel src/repro/kernels/haar.py:haar_pallas (body
// _haar_kernel).  Output layout is the reference's [a_L, d_L, ..., d_1]:
// band d_l starts at offset T >> l and holds T >> l coefficients, a_L sits
// at offset 0 with T >> L of them.
//
// What bounds it on the card: memory.  Each element is read once and
// written once (2 * N * T * itemsize bytes); the arithmetic is 4 flops per
// input element, far below the rate at which bytes arrive.
//
// Design.  The TPU kernel keeps a whole (rows, T) block in on-chip memory;
// a long row does not fit a Hopper block's shared memory, so this kernel
// does not carry that tiling over.  A segment of 2^L consecutive samples
// is independent of every other segment: segment s of a row yields a_L[s],
// d_L[s], d_{L-1}[2s:2s+2], ..., d_1[2^(L-1) s : 2^(L-1) (s+1)].  One block
// stages a tile of whole segments of one row in shared memory with
// coalesced loads, runs every level there (ping-pong buffers, one barrier
// per level), and writes each level's details straight to their band as a
// contiguous run.  Any T works; shared memory per block is 6 bytes per
// staged sample (at most 24 KiB unless one segment alone is larger).
//
// Arithmetic follows the reference order, (e - o) then * (1/sqrt 2), with
// the _rn intrinsics so nvcc cannot contract into fused multiply-adds.  In
// bf16 every add/sub and every multiply is rounded to bf16, and 1/sqrt 2 is
// itself the bf16 constant, as the reference kernel does in the input
// dtype.  So the result is bitwise the plain PyTorch version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;        // samples of one row staged per block
constexpr int kMaxLevels = 15;     // one 2^15 segment: 192 KiB of staging

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
haar_rows(const T* __restrict__ x, T* __restrict__ out, int t_len,
          int levels, int tile, float inv) {
  extern __shared__ float smem[];
  const int seg = 1 << levels;
  const int nseg = t_len >> levels;
  const int segs_per_tile = tile >> levels;
  const int seg0 = blockIdx.y * segs_per_tile;
  const int nsegs = min(segs_per_tile, nseg - seg0);
  if (nsegs <= 0) return;
  const int n = nsegs << levels;
  const size_t row = blockIdx.x;
  const T* xr = x + row * t_len + (size_t)seg0 * seg;
  T* orow = out + row * t_len;

  float* cur = smem;              // tile samples
  float* nxt = smem + tile;       // tile / 2 samples
  for (int i = threadIdx.x; i < n; i += blockDim.x) cur[i] = Io<T>::load(xr + i);
  __syncthreads();

  int m = n;
  for (int l = 1; l <= levels; ++l) {
    const int h = m >> 1;
    T* dst = orow + (t_len >> l) + (size_t)seg0 * (seg >> l);
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const float e = cur[2 * i];
      const float o = cur[2 * i + 1];
      const float d = Io<T>::round(__fmul_rn(Io<T>::round(__fsub_rn(e, o)), inv));
      const float a = Io<T>::round(__fmul_rn(Io<T>::round(__fadd_rn(e, o)), inv));
      Io<T>::store(dst + i, d);
      nxt[i] = a;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    m = h;
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    Io<T>::store(orow + seg0 + i, cur[i]);
  }
}

template <typename T>
int launch(const void* x, void* out, long long n_rows, int t_len, int levels,
           float inv, cudaStream_t stream) {
  const int seg = 1 << levels;
  const int nseg = t_len >> levels;
  int segs_per_tile = kTile / seg;
  if (segs_per_tile < 1) segs_per_tile = 1;
  if (segs_per_tile > nseg) segs_per_tile = nseg;
  const int tile = segs_per_tile * seg;
  const size_t smem = (size_t)tile * sizeof(float) * 3 / 2;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        haar_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned tiles = (unsigned)((nseg + segs_per_tile - 1) / segs_per_tile);
  if (tiles > 65535u) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)n_rows, tiles);
  haar_rows<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), t_len, levels, tile, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (n_rows, t_len) row-major, float32 (is_bf16 == 0) or bfloat16.
// t_len % 2^levels == 0.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int haar_launch(const void* x, void* out, long long n_rows,
                           int t_len, int levels, int is_bf16, void* stream) {
  if (levels < 0 || levels > kMaxLevels || t_len <= 0 ||
      (t_len & ((1 << levels) - 1)) != 0 || n_rows < 0 ||
      n_rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const float inv_f32 = 0.70710678118654752f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const float inv = __bfloat162float(__float2bfloat16_rn(inv_f32));
    return launch<__nv_bfloat16>(x, out, n_rows, t_len, levels, inv, s);
  }
  return launch<float>(x, out, n_rows, t_len, levels, inv_f32, s);
}
