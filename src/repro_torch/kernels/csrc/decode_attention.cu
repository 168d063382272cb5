// Decode attention over a grouped-query (GQA) cache: one new query row a
// slot against the cache rows up to the slot's position,
//   out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] / sqrt(hd), s <= pos[b])
//               . v[b, s, h / G],       G = H / KV,
// with the cache (B, Smax, KV, hd) read in place through its strides.
//
// Replaces no Pallas kernel: the JAX package decodes in plain jnp (repeat
// the KV heads to the query heads, two einsums, a masked softmax).  On the
// card that plain form repeats the whole cache G times and copies it again
// before each product, every layer of every step; this kernel reads each
// cache row once.
//
// What bounds it on the card: the bytes of K and V up to each slot's
// position.  The work is 2 G operations a cache element (G <= 16), far
// below the card's ~295 operations a byte, so the CUDA cores serve it and
// the design serves the bytes:
//
// decode_split (one block per slot, KV head and chunk of kChunk key rows):
//   the block loads the G query heads of its KV head once (float32, scaled
//   by log2(e) / sqrt(hd)), then reads each K and V row of its chunk once
//   for all G heads.  A block whose chunk starts past its slot's position
//   exits at once, and the last chunk stops at the position (read on the
//   device: no host sync), so only rows <= pos are read.  Masked rows would
//   weigh exp(-inf) = 0, so skipping them is exact.  Tiles of kTileRows
//   rows (16-byte cp.async, neighbouring threads on neighbouring addresses,
//   rows padded to an odd number of 16-byte words so that a warp reading a
//   column of rows hits every bank) stream through a ring of kStages, K's
//   tiles then V's: first every score of the chunk into shared memory,
//   then the chunk's max and sum, then the weighted sum of V.  Scores, the
//   softmax and the output sums are float32.  Each block writes its
//   chunk's (max, sum, unnormalised output) to a float32 workspace.
// decode_combine (one block per slot and query head): merges the chunks up
//   to the position (the log-sum-exp rule) and writes the output in q's
//   type.  Two launches a call.
//
// Any head width that is a multiple of 8 up to 128, G = H / KV up to 16,
// float32 or bfloat16 (q, k, v and the output of one type), positions as
// int32 or int64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;      // key rows a block
constexpr int kStages = 4;       // tiles in flight
constexpr int kMaxG = 16;
constexpr int kMaxHd = 128;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;          // elements a 16-byte load
  static constexpr int kTileRows = 16;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kTileRows = 32;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16(v);
  }
};

// A cache row's pitch in shared memory, in 16-byte words: odd, so that
// eight threads reading one column of eight rows hit all 32 banks.
__host__ __device__ __forceinline__ int pitch16(int hd, int elem_bytes) {
  return (hd * elem_bytes / 16) | 1;
}

struct Layout {        // byte offsets into the block's dynamic shared memory
  int q, s, red, ring, total;
};

// q (G x hd floats), the chunk's scores (G x kChunk), the row groups'
// partial outputs (at most kThreads x kVec or G x hd floats) and the ring.
__host__ __device__ inline Layout layout(int G, int hd, int elem_bytes,
                                         int vec, int tile_rows) {
  Layout l;
  const int pairs = G * (hd / vec);
  const int span = pairs < kThreads ? pairs : kThreads;
  const int groups = kThreads / span;
  l.q = 0;
  l.s = l.q + G * hd * 4;
  l.red = l.s + G * kChunk * 4;
  l.ring = l.red + ((groups * pairs * vec * 4 + 15) / 16) * 16;
  l.total = l.ring + kStages * tile_rows * pitch16(hd, elem_bytes) * 16;
  return l;
}

template <typename P>
__device__ __forceinline__ int rows_to(const P* pos, int b, int S) {
  const long long n = static_cast<long long>(pos[b]) + 1;
  return n < 0 ? 0 : (n > S ? S : static_cast<int>(n));
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const P* __restrict__ pos,
             float* __restrict__ ws_o, float* __restrict__ ws_ml, int S,
             int H, int KV, int hd, long long ksb, long long kss,
             long long ksh, long long vsb, long long vss, long long vsh,
             float qscale) {
  using E = Elem<T>;
  constexpr int VEC = E::kVec;
  constexpr int TR = E::kTileRows;
  constexpr int MP = kMaxG * (kMaxHd / VEC) / kThreads;   // pairs a thread
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n = rows_to(pos, b, S);
  const int r0 = c * kChunk;
  if (r0 >= n) return;                   // the whole chunk is past pos
  const int rows = min(kChunk, n - r0);
  const int G = H / KV, nvec = hd / VEC;
  const int pitch = pitch16(hd, sizeof(T)) * 16;        // bytes
  const Layout L = layout(G, hd, sizeof(T), VEC, TR);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* red = reinterpret_cast<float*>(smem + L.red);
  unsigned char* ring = smem + L.ring;
  __shared__ float m_s[kMaxG], l_s[kMaxG];

  const int ntiles = (rows + TR - 1) / TR;
  const int total = 2 * ntiles;          // K's tiles, then V's
  const T* kb = k + b * ksb + kvh * ksh + static_cast<long long>(r0) * kss;
  const T* vb = v + b * vsb + kvh * vsh + static_cast<long long>(r0) * vss;

  auto fetch = [&](int t) {              // tile t into stage t % kStages
    if (t < total) {
      const bool is_v = t >= ntiles;
      const int tile = is_v ? t - ntiles : t;
      const T* src = is_v ? vb : kb;
      const long long rs = is_v ? vss : kss;
      const int base = tile * TR;
      const int valid = min(TR, rows - base);
      unsigned char* dst = ring + (t % kStages) * TR * pitch;
      for (int i = tid; i < valid * nvec; i += kThreads) {
        const int r = i / nvec, j = i - r * nvec;
        cp_async16(dst + r * pitch + j * 16,
                   src + (base + r) * rs + j * VEC, 16);
      }
    }
    cp_async_commit();                   // one group a tile, even empty
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  // the G query heads of this KV head, scaled to the log2 domain
  const T* qb = q + (static_cast<long long>(b) * H + kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads)
    qs[i] = E::to_f32(qb[i]) * qscale;

  // the weighted sum of V: thread -> (head, 16-byte column) pairs, and the
  // rows of a tile split between `groups` groups of threads
  const int pairs = G * nvec;
  const int span = min(pairs, kThreads);
  const int groups = kThreads / span;
  const int grp = tid / span, lane_pair = tid - grp * span;
  float acc[MP][VEC];
#pragma unroll
  for (int p = 0; p < MP; ++p)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[p][e] = 0.f;

  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                     // tile t in; tile t - 1 consumed
    fetch(t + kStages - 1);
    const unsigned char* tile = ring + (t % kStages) * TR * pitch;
    if (t < ntiles) {
      // scores of this K tile: thread -> (head, row), rows on the lanes
      const int base = t * TR, valid = min(TR, rows - base);
      for (int i = tid; i < G * TR; i += kThreads) {
        const int g = i / TR, r = i - g * TR;
        if (r >= valid) continue;
        const uint4* kr = reinterpret_cast<const uint4*>(tile + r * pitch);
        const float4* qg = reinterpret_cast<const float4*>(qs + g * hd);
        float s0 = 0.f, s1 = 0.f;
        for (int j = 0; j < nvec; ++j) {
          float kf[VEC];
          E::unpack(kr[j], kf);
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qv = qg[(j * VEC + e) / 4];
            s0 = fmaf(qv.x, kf[e], s0);
            s1 = fmaf(qv.y, kf[e + 1], s1);
            s0 = fmaf(qv.z, kf[e + 2], s0);
            s1 = fmaf(qv.w, kf[e + 3], s1);
          }
        }
        ss[g * kChunk + base + r] = s0 + s1;
      }
      continue;
    }
    if (t == ntiles) {
      // every score is in: the chunk's max and sum for each head, one warp
      // a head, and the scores become weights exp2(s - max)
      const int warp = tid / 32, lane = tid % 32;
      for (int g = warp; g < G; g += kThreads / 32) {
        float* sg = ss + g * kChunk;
        float m = -INFINITY;
        for (int r = lane; r < rows; r += 32) m = fmaxf(m, sg[r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float l = 0.f;
        for (int r = lane; r < rows; r += 32) {
          const float p = exp2f(sg[r] - m);
          sg[r] = p;
          l += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o);
        if (lane == 0) {
          m_s[g] = m;
          l_s[g] = l;
        }
      }
      __syncthreads();
    }
    // this V tile's rows into the sums
    if (grp < groups) {
      const int base = (t - ntiles) * TR, valid = min(TR, rows - base);
      for (int r = grp; r < valid; r += groups) {
        const uint4* vr = reinterpret_cast<const uint4*>(tile + r * pitch);
#pragma unroll
        for (int p = 0; p < MP; ++p) {
          const int pair = lane_pair + p * span;
          if (pair >= pairs) break;
          const int g = pair / nvec, j = pair - g * nvec;
          const float w = ss[g * kChunk + base + r];
          float vf[VEC];
          E::unpack(vr[j], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[p][e] = fmaf(w, vf[e], acc[p][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the row groups' sums, then this chunk's partials to the workspace
  if (grp < groups) {
#pragma unroll
    for (int p = 0; p < MP; ++p) {
      const int pair = lane_pair + p * span;
      if (pair >= pairs) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[(grp * pairs + pair) * VEC + e] = acc[p][e];
    }
  }
  __syncthreads();
  const int nchunk = gridDim.x;
  for (int i = tid; i < G * hd; i += kThreads) {
    float o = 0.f;
    for (int gr = 0; gr < groups; ++gr) o += red[gr * pairs * VEC + i];
    const int g = i / hd, d = i - g * hd;
    const long long row = (static_cast<long long>(b) * H + kvh * G + g) *
                              nchunk + c;
    ws_o[row * hd + d] = o;
  }
  if (tid < G) {
    const long long row = (static_cast<long long>(b) * H + kvh * G + tid) *
                              nchunk + c;
    ws_ml[2 * row] = m_s[tid];
    ws_ml[2 * row + 1] = l_s[tid];
  }
}

// out[b, h] from the chunks up to pos[b]: sum_c 2^(m_c - M) o_c over
// sum_c 2^(m_c - M) l_c, M the largest m_c.
template <typename T, typename P>
__global__ void __launch_bounds__(kMaxHd)
decode_combine(const float* __restrict__ ws_o,
               const float* __restrict__ ws_ml, const P* __restrict__ pos,
               T* __restrict__ out, int S, int H, int hd, int nchunk) {
  using E = Elem<T>;
  const int bh = blockIdx.x, b = bh / H, d = threadIdx.x;
  const int n = rows_to(pos, b, S);
  const int used = (n + kChunk - 1) / kChunk;
  const float* ml = ws_ml + static_cast<long long>(bh) * nchunk * 2;
  float m = -INFINITY;
  for (int c = 0; c < used; ++c) m = fmaxf(m, ml[2 * c]);
  if (d >= hd) return;
  const float* o = ws_o + static_cast<long long>(bh) * nchunk * hd + d;
  float num = 0.f, den = 0.f;
  for (int c = 0; c < used; ++c) {
    const float w = exp2f(ml[2 * c] - m);
    num = fmaf(w, o[c * hd], num);
    den = fmaf(w, ml[2 * c + 1], den);
  }
  out[static_cast<long long>(bh) * hd + d] = E::from_f32(num / den);
}

template <typename T, typename P>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, float* ws, int B, int S, int H, int KV, int hd,
           const long long (&ks)[3], const long long (&vs)[3],
           cudaStream_t st) {
  using E = Elem<T>;
  constexpr int VEC = E::kVec;
  for (int i = 0; i < 3; ++i)
    if (ks[i] % VEC || vs[i] % VEC) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int G = H / KV;
  const int nchunk = (S + kChunk - 1) / kChunk;
  const Layout L = layout(G, hd, sizeof(T), VEC, E::kTileRows);
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.total);
    if (e != cudaSuccess) return (int)e;
  }
  float* ws_o = ws;
  float* ws_ml = ws + static_cast<long long>(B) * H * nchunk * hd;
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(hd));
  decode_split<T, P><<<dim3(nchunk, KV, B), kThreads, L.total, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const P*>(pos), ws_o, ws_ml, S,
      H, KV, hd, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], qscale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<T, P><<<B * H, kMaxHd, 0, st>>>(
      ws_o, ws_ml, static_cast<const P*>(pos), static_cast<T*>(out), S, H,
      hd, nchunk);
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 workspace a call needs: B x H x ceil(S / kChunk) x (hd + 2).
extern "C" long long decode_attention_workspace(int B, int S, int H,
                                                int hd) {
  return static_cast<long long>(B) * H * ((S + kChunk - 1) / kChunk) *
         (hd + 2);
}

// q (B, H, hd) and out (B, H, hd) contiguous; k and v (B, S, KV, hd) with
// element strides (batch, row, head) and a contiguous last dimension; pos
// (B,) int32 or int64 (pos_is64); ws the float32 workspace
// (decode_attention_workspace).  Returns a cudaError_t.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* ws, int B, int S, int H, int KV, int hd, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int is_bf16, int pos_is64, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || H / KV > kMaxG || hd <= 0 ||
      hd % 8 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const long long ks[3] = {k_sb, k_ss, k_sh}, vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    return pos_is64
        ? launch<__nv_bfloat16, long long>(q, k, v, pos, out, w, B, S, H, KV,
                                           hd, ks, vs, st)
        : launch<__nv_bfloat16, int>(q, k, v, pos, out, w, B, S, H, KV, hd,
                                     ks, vs, st);
  return pos_is64 ? launch<float, long long>(q, k, v, pos, out, w, B, S, H,
                                             KV, hd, ks, vs, st)
                  : launch<float, int>(q, k, v, pos, out, w, B, S, H, KV, hd,
                                       ks, vs, st);
}
