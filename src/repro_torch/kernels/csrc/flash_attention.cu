// Forward flash attention over (BH, S, d) with KV already expanded to the
// query heads: o = softmax(q·kᵀ / sqrt(d), causal mask qpos >= kpos) · v.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (body _fa_kernel).  Same function: the scale
// multiplies the float32 scores, the mask value is -1e30, the running max,
// denominator and accumulator are float32, P is rounded to v's dtype before
// P·V, tiles wholly above the diagonal are skipped, and the output is
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the card: on the dense prefill path (BH 16, S up to
// 2048, d 128, bfloat16) attention does 4·BH·d·S(S+1)/2 operations on
// 4·BH·S·d·2 bytes, far above the ridge point: it is bound by operations.
// The bound is the bfloat16 tensor-core rate; this first kernel runs on the
// CUDA cores in float32, so it sits well above that bound (PERF.md).
// Tensor cores (mma.sync / wgmma) are later work (ROADMAP queue 2).
//
// Design.  One block per (q-tile of 64 rows, bh); four threads per query
// row, each owning d/4 of the row's columns, interleaved in float4 chunks
// so that the four threads of a row read neighbouring 16-byte words of a
// shared-memory K/V row (no bank conflicts; other rows of the warp read the
// same words as broadcasts).  Each K/V tile (32 keys, 16 at d > 128) is
// staged in shared memory as float32.  A row's score for key j is the sum
// of its four partial dots (two shuffles); the scores of a tile stay in
// registers, and the online softmax updates max, denominator and
// accumulator once per tile, as the TPU kernel does per kv block.  The
// ragged edges of q and k are masked inside the kernel, so any S >= 1
// works (the TPU kernel needs S divisible by its block).  The head width is
// a template bound (64, 128 or 256); columns past d are zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kThreads = 4 * kBQ; // four threads per query row
constexpr float kNegInf = -1e30f; // the TPU kernel's masked value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// p rounded to T, as the TPU kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float p);
template <>
__device__ __forceinline__ float round_to<float>(float p) { return p; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// D: padded head width (multiple of 16, >= d); BK: keys per tile.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int d, float scale, int causal) {
  constexpr int C4 = D / 16;      // float4 chunks of a row per thread
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int quad = threadIdx.x & 3;
  const int qi = q0 + (threadIdx.x >> 2);
  const bool row_ok = qi < sq;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  // this thread's columns: 4 * (quad + 4 * c) + e, c < C4, e < 4
  float qr[4 * C4];
  float acc[4 * C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * (quad + 4 * c) + e;
      qr[4 * c + e] = (row_ok && col < d) ? to_f32(qb[(size_t)qi * d + col])
                                          : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  // causal: key tiles that start past the block's last row are skipped
  const int kend = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                       // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int kr = k0 + r;
      const bool in = kr < sk && c < d;
      ks[i] = in ? to_f32(kb[(size_t)kr * d + c]) : 0.f;
      vs[i] = in ? to_f32(vb[(size_t)kr * d + c]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr4 = reinterpret_cast<const float4*>(ks + j * D);
      // four independent partial sums, so the FMAs do not wait on each
      // other's latency
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 kv = kr4[quad + 4 * c];
        p0 = fmaf(qr[4 * c + 0], kv.x, p0);
        p1 = fmaf(qr[4 * c + 1], kv.y, p1);
        p2 = fmaf(qr[4 * c + 2], kv.z, p2);
        p3 = fmaf(qr[4 * c + 3], kv.w, p3);
      }
      float part = (p0 + p1) + (p2 + p3);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool masked = kj >= sk || (causal && kj > qi);
      s[j] = masked ? kNegInf : part * scale;
      mt = fmaxf(mt, s[j]);
    }

    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < 4 * C4; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float pv = round_to<T>(p);
      const float4* vr4 = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 vv = vr4[quad + 4 * c];
        acc[4 * c + 0] = fmaf(pv, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(pv, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pv, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pv, vv.w, acc[4 * c + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)bh * sq + qi) * d;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (quad + 4 * c) + e;
        if (col < d) store(orow + col, acc[4 * c + e] / denom);
      }
    }
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int d, float scale, int causal,
           cudaStream_t stream) {
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)bh);
  flash_fwd_kernel<T, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int sk, int d, float scale, int causal,
             cudaStream_t s) {
  if (d <= 64) return launch<T, 64, 32>(q, k, v, o, bh, sq, sk, d, scale,
                                        causal, s);
  if (d <= 128) return launch<T, 128, 32>(q, k, v, o, bh, sq, sk, d, scale,
                                          causal, s);
  return launch<T, 256, 16>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), all row-major and of
// one dtype (float32 when is_bf16 == 0, else bfloat16); 1 <= d <= 256,
// bh <= 65535.  scale multiplies the float32 scores.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int sq,
                                      int sk, int d, float scale, int causal,
                                      int is_bf16, void* stream) {
  if (bh < 0 || sq < 0 || sk < 0 || d < 1 || d > 256 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, causal,
                                   s);
  return dispatch<float>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
}
