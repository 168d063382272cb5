// Forward flash attention, o = softmax(q·kᵀ / sqrt(d), causal mask
// qpos >= kpos) · v, with grouped-query heads read in place: q is
// (B, Sq, H, d), k (B, Sk, KV, d), v (B, Sk, KV, dv) and o (B, Sq, H, dv),
// H % KV == 0, and query head h reads KV head h / (H / KV), as the
// reference's jnp.repeat over heads.  dv == d but on the bfloat16
// tensor-core kernel at d 192, which also takes MLA's dv 128.  Every
// tensor is addressed through its own element strides of batch, sequence
// and head; the last dimension is contiguous.  The (BH, S, d) form is the
// same layout with H = KV = 1.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (body _fa_kernel).  Same function: the scale
// multiplies the float32 scores, the mask value is -1e30, the running max,
// denominator and accumulator are float32, P is rounded to v's dtype before
// P·V, tiles wholly above the diagonal are skipped, and the output is
// acc / max(l, 1e-30) in q's dtype.  The ragged ends of q and k are masked
// here, so any S >= 1 works (the TPU kernel needs S divisible by its block).
//
// What bounds it on the card: on the dense prefill path (16 heads, S up to
// 2048, d 128) attention does 4·H·d·S(S+1)/2 operations on 4·H·S·d bytes
// of each of q, k, v and o, far above the ridge point: it is bound by the
// tensor-core rate of its dtype (bfloat16; float32 as 3xTF32, three TF32
// products at 495 TFLOP/s).
//
// Four variants, chosen by the caller (kernels/flash_attention.py) by dtype
// and head width:
//
// flash_fwd_wgmma: bfloat16 at q/k width d 64, 112, 128 and 192 (v as wide,
//   or 128 at 192), on the tensor cores.  A unit of work is 128 query rows
//   of one head: two consumer warpgroups of 64 rows and one producer
//   warpgroup.  The producer's first thread keeps K and V tiles of 128 keys
//   (64 at q/k 192) in flight into a ring in shared memory (as many stages
//   as fit beside Q in 227 KB: TcSmem) with TMA (cp.async.bulk.tensor over
//   a 4-D tensor map of (B, S, heads, width); rows and columns outside the
//   tensor arrive as zeros, so d 112 lands in the d 128 layout with columns
//   112-127 zero), synchronised by mbarriers: "full" when a stage's bytes
//   have landed, "empty" when all eight consumer warps are done with it.
//   TMA rather than cp.async: one thread issues a whole tile, and the
//   128-byte swizzle that wgmma reads without bank conflicts comes from the
//   copy itself.  The tensor-map encoder (cuTensorMapEncodeTiled) lives in
//   libcuda; it is looked up once with dlsym, so the library links against
//   nothing new.  Each consumer warpgroup computes S = Q·Kᵀ with
//   wgmma.m64nBKk16 over the d/16 k-steps of real columns (7 at d 112, 12
//   at 192; Q and K from shared memory, float32 sums in registers), the
//   online softmax in registers (the four threads of a row meet by two
//   shuffles), rounds P to bfloat16 in registers and feeds it as the
//   register A operand of a second wgmma, O += P·V (m64nNk16, N v's width
//   in whole 64-column tiles), with V read transposed from shared memory.
//   The accumulator layout of the first product is the A-operand layout of
//   the second, so P never touches shared memory.  Registers move from the
//   producer (24 a thread) to the consumers (240) with setmaxnreg.  Only
//   tiles that cross the diagonal or the ragged end of k take the element
//   mask; tiles wholly above a warpgroup's diagonal are skipped.
//
//   The main loop, from a clock64 trace of its phases (tools/flash_trace.py:
//   at grok-1's group of 6 a key tile took 4,628 cycles where its products
//   need 2,048 at the tensor cores' rate, and one warpgroup's softmax alone
//   took 1,985-2,520):
//   - Ping-pong (FlashAttention-3's schedule, arXiv:2407.08608 §3.1): the
//     two consumer warpgroups take turns to issue their products, ordered
//     by named barriers 1 and 2 (bar.sync on its own, bar.arrive on the
//     other's, 256 threads each): warpgroup 0 issues S(j+1) and P·V(j),
//     then warpgroup 1, and so on, so that one's softmax, rescale and pack
//     run on the CUDA cores while the other's products hold the tensor
//     cores.  Inside a warpgroup S(j+1) and P·V(j) are still issued
//     together and S waited for first, so its softmax also runs under its
//     own P·V, and the accumulator's rescale runs between the two issues.
//     Where one warpgroup reads a key tile fewer (64-key tiles on the
//     diagonal) it takes its last turn empty; a unit where only one
//     warpgroup reads keys (a ragged q-tile of 64 rows or fewer, a chunk of
//     the split past warpgroup 0's diagonal) takes no turns, so the
//     barriers' arrivals always match.
//   - The online softmax costs one FFMA and one MUFU.EX2 a score: the max
//     is taken over the raw scores and the scale folded into the
//     exponent's argument (s·scale_log2 - m), and ex2.approx.ftz replaces
//     exp2f, which guarded every MUFU.EX2 for subnormal results; .ftz
//     flushes a probability below 2^-126 of its row's running max to zero.
//     One tile of 128 keys: 820 SASS instructions before, 455 after (12.8
//     and 7.1 a score, the mask's branch included; tools/flash_trace.py's
//     softmax_probe).  The mask compares each score's key offset with one
//     limit a row.
//   - The grid is persistent (the trace put the fill and the epilogue at
//     13% of grok's heaviest blocks): one block an SM walks the (q-tile,
//     head) units round by round in the order of a grid of one block a
//     unit, odd rounds backwards (tc_unit), and each warpgroup's
//     Q rows have their own "full" and "empty" barriers, so the producer
//     loads the next unit's Q as soon as a warpgroup's last S has read the
//     old rows, and its first K/V tile before that: both land while the
//     warpgroup finishes the unit.  The epilogue multiplies by one
//     reciprocal a row and stores 16 bytes a thread (a row's pairs of
//     columns transposed among its four threads by shuffles).
//   What bounds it now: the tensor cores run about 58% of a key tile's
//   cycles at d 128; a warpgroup's chain of S wait, softmax, rescale and
//   pack is longer than the other's products at d 64, where the MUFU's
//   exponentials and the products take about as long each.
//   A grid of fewer units than the card's SMs (a rank's few heads, a short
//   prompt) would take as long as its longest q-tile, under the causal mask
//   16 key tiles at 2048 rows where the mean is 8.5, with SMs idle; the
//   caller's plan then splits each q-tile's key tiles into chunks, one
//   block each on the grid's z axis (this launch is not persistent).  A
//   q-tile of several chunks writes each chunk's unnormalised accumulator,
//   running max and sum in float32 to a workspace, and flash_fwd_combine
//   rescales, sums and divides them into o (launched as a programmatic
//   dependent, so its launch overlaps the first pass's last blocks).
//
// flash_fwd_wgmma_tf32: float32 at d 64 and 128, on the tensor cores in
//   3xTF32: TF32 keeps 10 mantissa bits and fails the float32 tolerance,
//   so every operand is split into hi + lo (split_tf32, hopper.cuh) and each
//   product is hi·hi + hi·lo + lo·hi into one float32 accumulator, three
//   wgmma.m64nNk8.tf32 per k-step.  tf32 wgmma reads both operands K-major
//   only, which fixes the layout: S = Q·Kᵀ reads Q and K as stored (d
//   contiguous); O += P·V takes P from registers and needs Vᵀ (keys
//   contiguous), which TMA cannot make from float32, so threads transpose
//   V.  A block takes 64 query rows and 256 threads in two roles.  The
//   consumer warpgroup keeps Q's hi in registers as the A fragments of S
//   and Q's lo in shared memory; per tile of 64 keys it runs S (3·D/8
//   wgmmas of N 64), the online softmax in registers (P stays float32, v's
//   dtype), splits P into hi/lo A fragments and runs P·V (24 wgmmas).  The
//   transform warpgroup, whose first thread issues the TMA copies into raw
//   tiles, copies each K into hi and lo tiles and writes each V transposed
//   into Vᵀ hi and lo tiles, its keys in the accumulator's order (key_at,
//   hopper.cuh): the S accumulator gives a thread keys (2t, 2t + 1) of each
//   group of 8 where tf32's A fragment wants K positions (t, t + 4), so P
//   never moves between threads.  Shared memory binds the design (float32
//   hi + lo take four times bfloat16's bytes: 224 KB at d 128): K and Vᵀ
//   have one buffer each but mbarriers of their own, so the next K is
//   written while P·V runs and the next Vᵀ while the next S runs, and the
//   raw tiles let TMA bring the next tile while the current one computes.
//   Tiles of 64 keys because with 32 the kernel was bound by the count of
//   S's wgmmas (an m64n32k8 costs nearly an m64n64k8 on the H100), not by
//   its bytes.  One block per SM; heaviest causal q-tiles first; element
//   masks only on diagonal and ragged tiles.
//
// flash_fwd_mma: float32 and bfloat16 at every other width that is a
//   multiple of 8 up to 256 (the smoke configs' 32, zamba2's 112 and MLA's
//   192 in float32), on the warp-level tensor cores (mma.sync): bfloat16
//   m16n8k16 with float32 sums, float32 as 3xTF32 m16n8k8 (hi·hi + hi·lo +
//   lo·hi, split_tf32), so the float32 tolerance holds.  One warp owns 16
//   query rows; d is padded with zeros in shared memory to a multiple of
//   16, which sizes the registers and loops at compile time (one
//   instantiation per width, so
//   no product sits under a branch and ptxas can schedule the loads of a
//   step ahead of its products).  K and V tiles (64 keys in bfloat16 up to
//   d 128, else 32) are staged by cp.async into a double buffer (rows past
//   S arrive as zeros).  S stays in registers, the online softmax reduces
//   over the four threads of a quad by shuffles, and P feeds P·V from the S
//   accumulator: in bfloat16 its pairs are m16n8k16's A fragment
//   (fragments loaded by ldmatrix, V's transposed), in float32 V's rows are
//   read in key_at's order.  The grid is sized from the work: a block has 4
//   warps (64 rows), halved while B·H·(row tiles) would not cover the SMs,
//   so the dense smoke config's 61-token prefill (4 heads) runs on 16 SMs,
//   not 4; up to d 128 the launch bounds ask for three blocks an SM.
//   What bounds it: the H100 issues one mma.sync an SM every 1.5 cycles
//   (tools/mma_rate.py), two thirds of wgmma's rate, and float32 takes
//   three of them a product.

// flash_fwd_simt: float32 and bfloat16 at any d up to 256, on the CUDA
//   cores in float32: the widths no tensor-core variant takes (not a
//   multiple of 8), and the "before" of the others when forced.
//   One block per (q-tile of 64 rows, head); four threads per query row,
//   each owning d/4 of the row's columns, interleaved in float4 chunks so
//   that the four threads of a row read neighbouring 16-byte words of a
//   shared-memory K/V row.  Each K/V tile (32 keys, 16 at d > 128) is staged
//   in shared memory as float32; scores of a tile stay in registers and the
//   online softmax updates once per tile.  The head width is a template
//   bound (64, 128 or 256); columns past d are zero.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masked value

// Shapes and element strides of one call.
struct Geom {
  int B, Sq, Sk, H, KV, d, dv;      // dv: v's and o's width
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
};

// ---------------------------------------------------------------------------
// CUDA-core variant
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;           // query rows per block
constexpr int kThreads = 4 * kBQ; // four threads per query row

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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, Geom g,
               float scale, int causal) {
  constexpr int C4 = D / 16;      // float4 chunks of a row per thread
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const int b = blockIdx.y / g.H;
  const int h = blockIdx.y - b * g.H;
  const int kvh = h / (g.H / g.KV);
  const int sq = g.Sq, sk = g.Sk, d = g.d;
  const int q0 = blockIdx.x * kBQ;
  const int quad = threadIdx.x & 3;
  const int qi = q0 + (threadIdx.x >> 2);
  const bool row_ok = qi < sq;
  const T* qb = q + b * g.qsb + h * g.qsh;
  const T* kb = k + b * g.ksb + kvh * g.ksh;
  const T* vb = v + b * g.vsb + kvh * g.vsh;

  // this thread's columns: 4 * (quad + 4 * c) + e, c < C4, e < 4
  float qr[4 * C4];
  float acc[4 * C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * (quad + 4 * c) + e;
      qr[4 * c + e] = (row_ok && col < d) ? to_f32(qb[qi * g.qss + col])
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
      ks[i] = in ? to_f32(kb[kr * g.kss + c]) : 0.f;
      vs[i] = in ? to_f32(vb[kr * g.vss + c]) : 0.f;
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
    T* orow = o + b * g.osb + h * g.osh + qi * g.oss;
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
int launch_simt(const void* q, const void* k, const void* v, void* o,
                const Geom& g, float scale, int causal, cudaStream_t stream) {
  dim3 grid((unsigned)((g.Sq + kBQ - 1) / kBQ), (unsigned)(g.B * g.H));
  flash_fwd_simt<T, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), g, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  const Geom& g, float scale, int causal, cudaStream_t s) {
  if (g.d <= 64) return launch_simt<T, 64, 32>(q, k, v, o, g, scale, causal, s);
  if (g.d <= 128)
    return launch_simt<T, 128, 32>(q, k, v, o, g, scale, causal, s);
  return launch_simt<T, 256, 16>(q, k, v, o, g, scale, causal, s);
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core variant (mma.sync): the other head widths
// ---------------------------------------------------------------------------

constexpr int kMmaMaxWarps = 4;   // 16 query rows a warp

// keys per K/V tile: 64 for bfloat16 up to DP 128, else 32 (registers and
// shared memory at DP 256 and in float32)
template <typename T, int DP>
__host__ __device__ constexpr int mma_bk() {
  return sizeof(T) == 2 && DP <= 128 ? 64 : 32;
}
// Row stride of a tile in elements: DP plus 16 bytes, so that the eight
// rows an ldmatrix (bfloat16) or a fragment load (float32) touches fall in
// distinct banks.
template <typename T, int DP>
__host__ __device__ constexpr int mma_stride() {
  return DP + 16 / (int)sizeof(T);
}
// Blocks an SM that the launch bounds ask for: three up to d 128 (their
// tiles fit three an SM, and 168 registers a thread hold them); past d 128
// one, so the accumulator of a row keeps its registers (with three, ptxas
// spilled from d 160 in float32 and at 256 in bfloat16).
template <int DP>
__host__ __device__ constexpr int mma_min_blocks() {
  return DP <= 128 ? 3 : 1;
}
// Q (16 rows a warp) and two buffers each of K and V
template <typename T, int DP>
__host__ __device__ constexpr int mma_smem_bytes(int warps) {
  return (16 * warps + 4 * mma_bk<T, DP>()) * mma_stride<T, DP>() *
         (int)sizeof(T);
}

// S (16 rows x BK keys) = Q·Kᵀ of one warp: qs the warp's 16 Q rows, kt
// the K tile, both [row][S].  The fragments of k-step ks + 1 are loaded
// before the products of ks are issued.
template <int DP, int BK>
__device__ __forceinline__ void mma_scores(float (&sc)[BK / 8][4],
                                           const __nv_bfloat16* qs,
                                           const __nv_bfloat16* kt,
                                           int lane) {
  constexpr int S = mma_stride<__nv_bfloat16, DP>();
  uint32_t qf[2][4], kf[2][BK / 16][4];
  const __nv_bfloat16* qa = qs + (lane & 15) * S + (lane >> 4) * 8;
  // (keys 16p.., d 16ks), (16p.., 16ks + 8), (16p + 8.., 16ks),
  // (16p + 8.., 16ks + 8): the B fragments of key tiles 2p and 2p + 1
  const __nv_bfloat16* ka =
      kt + ((lane >> 4) * 8 + (lane & 7)) * S + ((lane >> 3) & 1) * 8;
  auto load = [&](int ks, int buf) {
    ldmatrix_x4(qf[buf], qa + 16 * ks);
#pragma unroll
    for (int p = 0; p < BK / 16; ++p)
      ldmatrix_x4(kf[buf][p], ka + 16 * p * S + 16 * ks);
  };
  load(0, 0);
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    if (ks + 1 < DP / 16) load(ks + 1, (ks + 1) & 1);
#pragma unroll
    for (int p = 0; p < BK / 16; ++p) {
      mma_bf16(sc[2 * p], qf[ks & 1], kf[ks & 1][p][0], kf[ks & 1][p][1]);
      mma_bf16(sc[2 * p + 1], qf[ks & 1], kf[ks & 1][p][2],
               kf[ks & 1][p][3]);
    }
  }
}

template <int DP, int BK>
__device__ __forceinline__ void mma_scores(float (&sc)[BK / 8][4],
                                           const float* qs, const float* kt,
                                           int lane) {
  constexpr int S = mma_stride<float, DP>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    const float* qa = qs + g * S + 8 * ks + t;
    const float av[4] = {qa[0], qa[8 * S], qa[4], qa[8 * S + 4]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float* kb = kt + (8 * j + g) * S + 8 * ks + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(kb[0], bh0, bl0);
      split_tf32(kb[4], bh1, bl1);
      mma_3xtf32(sc[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// acc (16 rows x DP) += P·V, P from the S accumulator (already
// exponentiated), rounded to bfloat16 as the A fragments of m16n8k16: the
// accumulator pairs of key tiles 2kk and 2kk + 1 are that fragment.  V's
// fragments for the next pair of column tiles are loaded before the
// products of this pair.
template <int DP, int BK>
__device__ __forceinline__ void mma_pv(float (&acc)[DP / 8][4],
                                       const float (&sc)[BK / 8][4],
                                       const __nv_bfloat16* vt, int lane) {
  constexpr int S = mma_stride<__nv_bfloat16, DP>();
  constexpr int NP = DP / 16;
  // transposed: (keys 16kk.., d 16np), (16kk + 8.., 16np), (16kk..,
  // 16np + 8), (16kk + 8.., 16np + 8): the B fragments of column tiles 2np
  // and 2np + 1
  const __nv_bfloat16* va =
      vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                           pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                           pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                           pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
    uint32_t vf[2][4];
    ldmatrix_x4_trans(vf[0], va + 16 * kk * S);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      if (np + 1 < NP)
        ldmatrix_x4_trans(vf[(np + 1) & 1], va + 16 * kk * S + 16 * (np + 1));
      mma_bf16(acc[2 * np], a, vf[np & 1][0], vf[np & 1][1]);
      mma_bf16(acc[2 * np + 1], a, vf[np & 1][2], vf[np & 1][3]);
    }
  }
}

// float32: P stays float32 (v's dtype) and is split for 3xTF32.  The
// accumulator gives a thread keys (2t, 2t + 1) of each key tile where the
// A fragment wants K positions (t, t + 4): the K positions take key_at's
// order (hopper.cuh), so the B fragment reads V's rows 2t and 2t + 1 and
// no value of P moves between threads.
template <int DP, int BK>
__device__ __forceinline__ void mma_pv(float (&acc)[DP / 8][4],
                                       const float (&sc)[BK / 8][4],
                                       const float* vt, int lane) {
  constexpr int S = mma_stride<float, DP>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float pv[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(pv[i], ph[i], pl[i]);
    const float* vr = vt + (8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(vr[8 * n], bh0, bl0);
      split_tf32(vr[S + 8 * n], bh1, bl1);
      mma_3xtf32(acc[n], ph, pl, bh0, bh1, bl0, bl1);
    }
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a,
                                       float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

// DP: the head width d (a multiple of 8) rounded up to 16, which sizes the
// registers and loops; columns d..DP-1 are zeros in shared memory and are
// not stored.  One block: blockDim.x / 32 warps of 16 query rows.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kMmaMaxWarps, mma_min_blocks<DP>())
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Geom g,
              float scale_log2, int causal) {
  constexpr int BK = mma_bk<T, DP>();
  constexpr int S = mma_stride<T, DP>();
  constexpr int E = 16 / sizeof(T);       // elements a 16-byte copy moves
  constexpr int NT = BK / 8;              // key tiles of the S accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x;
  const int bq = nthreads / 2;            // 16 rows a warp
  T* qs = reinterpret_cast<T*>(smem_raw); // [bq][S]
  T* ks = qs + bq * S;                    // [2][BK][S]
  T* vs = ks + 2 * BK * S;                // [2][BK][S]

  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x - b * g.H;
  const int kvh = h / (g.H / g.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = g.d, sq = g.Sq, sk = g.Sk;
  const int chunks = d / E;               // 16-byte copies a row
  const T* qb = q + b * g.qsb + h * g.qsh;
  const T* kb = k + b * g.ksb + kvh * g.ksh;
  const T* vb = v + b * g.vsb + kvh * g.vsh;

  // columns d..DP-1 of every row are zeros (no copy writes them): the
  // bfloat16 k-steps of 16 read them when d is not a multiple of 16
  const int pad = DP - d;
  for (int i = threadIdx.x; i < (bq + 4 * BK) * pad; i += nthreads) {
    const int r = i / pad;
    qs[r * S + d + (i - r * pad)] = T(0.f);
  }
  for (int i = threadIdx.x; i < bq * chunks; i += nthreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * E;
    const bool in = q0 + r < sq;
    cp_async16(qs + r * S + c, in ? qb + (q0 + r) * g.qss + c : qb,
               in ? 16 : 0);
  }
  // keys past Sk arrive as zeros: P is 0 there, and V must not be NaN
  auto load_kv = [&](int tile, int buf) {
    T* kd = ks + buf * BK * S;
    T* vd = vs + buf * BK * S;
    for (int i = threadIdx.x; i < BK * chunks; i += nthreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * E;
      const int key = tile * BK + r;
      const bool in = key < sk;
      cp_async16(kd + r * S + c, in ? kb + key * g.kss + c : kb, in ? 16 : 0);
      cp_async16(vd + r * S + c, in ? vb + key * g.vss + c : vb, in ? 16 : 0);
    }
  };
  // causal: key tiles that start past the block's last row are skipped
  const int kend = causal ? min(sk, q0 + bq) : sk;
  const int ntiles = (kend + BK - 1) / BK;
  load_kv(0, 0);
  cp_async_commit();

  const int qw = q0 + 16 * warp;          // the warp's first row
  const int gr = lane >> 2, t = lane & 3;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};        // rows qw + gr and qw + gr + 8
  float l[2] = {0.f, 0.f};                // this thread's part of the sum

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      load_kv(tile + 1, (tile + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * BK;
    // rows past Sq, and tiles wholly above this warp's diagonal, are idle
    if (qw < sq && !(causal && k0 > qw + 15)) {
      const T* kt = ks + (tile & 1) * BK * S;
      const T* vt = vs + (tile & 1) * BK * S;
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
      mma_scores<DP, BK>(sc, qs + 16 * warp * S, kt, lane);

      // online softmax over this tile, in the log2 domain
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = sc[j][i] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            const int row = qw + gr + 8 * (i >> 1);
            if (key >= sk || (causal && key > row)) x = kNegInf;
          }
          sc[j][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[j][i] = exp2f(sc[j][i] - m[i >> 1]);
          psum[i >> 1] += sc[j][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      mma_pv<DP, BK>(acc, sc, vt, lane);
    }
    __syncthreads();                      // before the buffer is refilled
  }

  T* ob = o + b * g.osb + h * g.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = qw + gr + 8 * r;
    if (row < sq) {
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (8 * n < d)
          store2(ob + row * g.oss + 8 * n + 2 * t, acc[n][2 * r] / den,
                 acc[n][2 * r + 1] / den);
    }
  }
}

// Warps a block at this shape: 4 (64 rows), halved while the blocks would
// not cover the SMs, so a short prompt is spread over many SMs.
inline int mma_warps(const Geom& g) {
  const int sms = sm_count();
  int warps = kMmaMaxWarps;
  while (warps > 1 && (long long)g.B * g.H *
                              ((g.Sq + 16 * warps - 1) / (16 * warps)) <
                          sms)
    warps >>= 1;
  return warps;
}

template <typename T, int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const Geom& g, float scale, int causal, cudaStream_t stream) {
  static int setup = -1;     // once per process (one device)
  if (setup < 0)
    setup = (int)cudaFuncSetAttribute(
        flash_fwd_mma<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mma_smem_bytes<T, DP>(kMmaMaxWarps));
  if (setup) return setup;
  const int warps = mma_warps(g);
  dim3 grid((unsigned)(g.B * g.H),
            (unsigned)((g.Sq + 16 * warps - 1) / (16 * warps)));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_mma<T, DP><<<grid, 32 * warps, mma_smem_bytes<T, DP>(warps),
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), g,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// The head width rounded up to 16: the kernel's registers and loops are
// sized by it at compile time, so no step of a product is under a branch.
template <typename T>
int dispatch_mma(const void* q, const void* k, const void* v, void* o,
                 const Geom& g, float scale, int causal, cudaStream_t s) {
  switch ((g.d + 15) / 16) {
#define FLASH_MMA_CASE(n) \
  case n:                 \
    return launch_mma<T, 16 * n>(q, k, v, o, g, scale, causal, s);
    FLASH_MMA_CASE(1) FLASH_MMA_CASE(2) FLASH_MMA_CASE(3) FLASH_MMA_CASE(4)
    FLASH_MMA_CASE(5) FLASH_MMA_CASE(6) FLASH_MMA_CASE(7) FLASH_MMA_CASE(8)
    FLASH_MMA_CASE(9) FLASH_MMA_CASE(10) FLASH_MMA_CASE(11)
    FLASH_MMA_CASE(12) FLASH_MMA_CASE(13) FLASH_MMA_CASE(14)
    FLASH_MMA_CASE(15) FLASH_MMA_CASE(16)
#undef FLASH_MMA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variant: bfloat16 wgmma (the other helpers: hopper.cuh)
// ---------------------------------------------------------------------------

// D (64 x 128, float32) += A (64 x 16, shared memory) * B (16 x 128, shared
// memory, K-major); scale_d == 0 starts D from zero.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, shared memory) * B (16 x 64, shared
// memory, K-major); scale_d == 0 starts D from zero.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, bfloat16 pairs in registers) *
// B (16 x 64, shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// D (64 x 128, float32) += A (64 x 16, bfloat16 pairs in registers) *
// B (16 x 128, shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}


// D (64 x 192, float32) += A (64 x 16, bfloat16 pairs in registers) *
// B (16 x 192, shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, da, db, scale_d);
  } else {
    static_assert(N == 64, "S tiles of 64 or 128 keys");
    wgmma_ss_n64(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (N == 192) {
    wgmma_rs_n192(d, a0, a1, a2, a3, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a0, a1, a2, a3, db);
  } else {
    static_assert(N == 64, "O tiles of 64, 128 or 192 columns");
    wgmma_rs_n64(d, a0, a1, a2, a3, db);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variant: the kernel
// ---------------------------------------------------------------------------

constexpr int kWG = 2;                  // consumer warpgroups, 64 rows each
constexpr int kTcBQ = 64 * kWG;         // query rows per block
constexpr int kTcThreads = 128 * (kWG + 1);
constexpr int kProducerRegs = 24;       // setmaxnreg targets
constexpr int kConsumerRegs = 240;
constexpr int kTile = 64 * 128;         // bytes of a [64 rows][64 cols] tile
constexpr int kSmemLimit = 232448;      // shared memory a block may use

// Shared memory at q/k width D and v width DV, from a 1024-byte aligned base
// (the swizzle's period).  Every tile is [rows][64 columns] of bfloat16,
// 128-byte rows in TMA's 128-byte swizzle; a width is as many such tiles
// side by side as cover it (112 takes two: TMA fills columns 112-127 with
// zeros).  Keys come in tiles of kBK: 128, or 64 where the K and V tiles
// together are wider than 256 columns (q/k 192), so that a stage stays small
// enough for a ring of several.  The ring holds as many K/V stages as fit
// beside Q in 227 KB, at most 4: 3 at d 128 and 112, 4 at 64 and at 192/128,
// 3 at 192/192.  Then the mbarriers: "full" and "empty" of each stage, and
// of each consumer warpgroup's Q rows.  kernels/flash_attention.py mirrors
// this (tc_smem_bytes).
template <int D, int DV>
struct TcSmem {
  static constexpr int kQC = (D + 63) / 64;   // 64-column tiles of Q and K
  static constexpr int kVC = (DV + 63) / 64;  // of V and of the accumulator
  static constexpr int kBK = (kQC + kVC) * 64 > 256 ? 64 : 128;
  static constexpr int kQBytes = kTcBQ * kQC * 128;    // [wg][c][64][64]
  static constexpr int kKBytes = kBK * kQC * 128;      // [c][kBK][64]
  static constexpr int kVBytes = kBK * kVC * 128;
  static constexpr int kFit = (kSmemLimit - 1024 - kQBytes - 8 * 2 * kWG) /
                              (kKBytes + kVBytes + 16);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kVBytes;
  static constexpr int kBytes = kBarOff + 8 * (2 * kStages + 2 * kWG);
  static constexpr int kAlloc = kBytes + 1024;         // room to align
  static_assert(kStages >= 2, "no room for a ring of two K/V stages");
  static_assert(kAlloc <= kSmemLimit, "more than a block's shared memory");
};

// S = Q·Kᵀ for one K tile of BK keys: D/16 steps of wgmma.m64nBKk16 (d 112:
// 7, the zero columns 112-127 skipped), Q and K from shared memory (each
// step 16 columns of d: tile kk / 4, 32 bytes into its 128-byte rows).
// Issued and committed as one group, not waited for.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_s,
                                         uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss<BK>(sc, sw128_desc(q_s + (kk >> 2) * kTile + col, 16, 1024),
                 sw128_desc(k_s + (kk >> 2) * BK * 128 + col, 16, 1024),
                 kk > 0);
  }
  wg_commit();
}

// O += P·V for one V tile: BK/16 steps, P from registers (the accumulator
// pairs of 16 keys of S are the A fragment of one step), V read transposed
// from shared memory (16 keys a step, 2048 bytes; the 64-column tiles of V
// BK·128 bytes apart).  N is V's width in whole tiles.  Issued and
// committed as one group.
template <int N, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[N / 2],
                                         const uint32_t (&p)[BK / 4],
                                         uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<N>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                sw128_desc(v_s + kk * 2048, BK * 128, 1024));
  wg_commit();
}

// 2^x by MUFU.EX2 alone.  exp2f (the build has no fast-math flag) wraps
// each MUFU.EX2 in a guard for subnormal results (an FSETP and two
// predicated FMULs); .ftz flushes them to zero instead, which changes a
// probability only where it is below 2^-126 of its row's running max.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile, in place in its registers: masks the
// keys past Sk and, causal, past each row (only where the tile crosses the
// diagonal or the ragged end: one compare and select a score against the
// row's limit), takes each row's max of the raw scores, and replaces each
// score s by 2^(s·scale_log2 - m), m the running max in log2 units (the
// scale is 1/sqrt(d)·log2 e, so exp is exp2): one FFMA and one MUFU.EX2 a
// score.  scale_log2 > 0 and rounding is monotone, so the scaled max is
// the max of the scaled scores.  Updates the running max and this
// thread's part of the denominator, and returns the factors by which the
// two rows' accumulators must be rescaled.  The four threads of a row
// meet by two shuffles.
struct RowState {
  float m_a, m_b, l_a, l_b;
};

template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             RowState& st, float& al_a,
                                             float& al_b, int k0, int q0w,
                                             int row_a, int c2, int sk,
                                             float scale_log2, int causal) {
  if ((causal && k0 + BK - 1 > q0w) || k0 + BK > sk) {
    // score i holds key k0 + c2 + 8 (i / 4) + i % 2: masked from the row's
    // limit on, min(Sk, row + 1) under the causal mask, else Sk
    const int lim_a = (causal ? min(sk, row_a + 1) : sk) - k0 - c2;
    const int lim_b = (causal ? min(sk, row_a + 9) : sk) - k0 - c2;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (8 * (i >> 2) + (i & 1) >= ((i & 2) ? lim_b : lim_a))
        sc[i] = kNegInf;
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i & 2) mx_b = fmaxf(mx_b, sc[i]);
    else mx_a = fmaxf(mx_a, sc[i]);
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(st.m_a, mx_a * scale_log2);
  const float mn_b = fmaxf(st.m_b, mx_b * scale_log2);
  al_a = ex2(st.m_a - mn_a);
  al_b = ex2(st.m_b - mn_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -mn_b : -mn_a));
    if (i & 2) ps_b += sc[i];
    else ps_a += sc[i];
  }
  st.l_a = st.l_a * al_a + ps_a;
  st.l_b = st.l_b * al_b + ps_b;
}

// P rounded to bfloat16: the accumulator pairs of 16 keys of S are the A
// fragment of one k-step of P·V.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&p)[BK / 4]) {
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

// Key tiles of BK that the q-tile starting at row q0 reads: causal, those
// that start at or before its last row.
__host__ __device__ __forceinline__ int tc_row_tiles(int q0, int sq, int sk,
                                                     int bk, int causal) {
  const int k_tiles = (sk + bk - 1) / bk;
  const int last_row = (q0 + kTcBQ < sq ? q0 + kTcBQ : sq) - 1;
  const int seen = last_row / bk + 1;
  return causal && seen < k_tiles ? seen : k_tiles;
}

// The split over keys (kSplit instantiations; the others run the persistent
// grid and carry none of its code): a block takes key tiles [z·tpc,
// (z+1)·tpc) of its q-tile (z = blockIdx.z).  Where the q-tile has more than
// one chunk, each chunk writes its unnormalised accumulator and its rows'
// running max (log2 units) and sum in float32 to the workspace, and
// flash_fwd_combine writes o.  Workspace: acc [chunks][B·H][Sq][dv], then
// max and sum [chunks][B·H][Sq].
struct Split {
  int tpc;        // key tiles a chunk
  float* ws;      // null when the grid has one chunk
};

// One unit of a block's work: the 128 query rows from q0 of head h of batch
// b against key tiles [t0, t0 + n_tiles) of the q-tile's own; chunks is
// the q-tile's count of chunks (1 but in a split launch).
struct TcUnit {
  int b, h, q0, t0, n_tiles, chunks;
};

// The unit a block takes in round r, or false where it has none.  A split
// launch takes one, its own: (head, q-tile, chunk) = blockIdx.  Else the
// grid is persistent (one block an SM, G = gridDim.x) and walks the units
// in the order of the old grid of one block a unit, heads the fast axis
// (a KV head's group of query heads stays together in L2) and, causal,
// the heaviest q-tiles first: round r takes units r·G .. r·G + G - 1, block
// i the i-th of them in even rounds and the (G - 1 - i)-th in odd ones, so
// that no block takes the heaviest unit of every causal round.
template <bool kSplit>
__device__ __forceinline__ bool tc_unit(int r, const Geom& g, int causal,
                                        int bk, int tpc, TcUnit& un) {
  const int q_tiles = (g.Sq + kTcBQ - 1) / kTcBQ;
  int x, y, z = 0;
  if constexpr (kSplit) {
    if (r > 0) return false;
    x = (int)blockIdx.x;
    y = (int)blockIdx.y;
    z = (int)blockIdx.z;
  } else {
    const int G = (int)gridDim.x;
    const int i = (r & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x;
    const long long u = (long long)r * G + i;
    if (u >= (long long)g.B * g.H * q_tiles) return false;
    y = (int)(u / (g.B * g.H));
    x = (int)(u - (long long)y * g.B * g.H);
  }
  un.b = x / g.H;
  un.h = x - un.b * g.H;
  un.q0 = (causal ? q_tiles - 1 - y : y) * kTcBQ;
  const int row_tiles = tc_row_tiles(un.q0, g.Sq, g.Sk, bk, causal);
  un.chunks = kSplit ? (row_tiles + tpc - 1) / tpc : 1;
  if (z >= un.chunks) return false;          // past this q-tile's keys
  un.t0 = kSplit ? z * tpc : 0;
  un.n_tiles = kSplit ? min(row_tiles, un.t0 + tpc) - un.t0 : row_tiles;
  return true;
}

// Key tiles of the unit that consumer warpgroup w reads: none past Sq, and
// causal a prefix, those that start at or before its last row.
__device__ __forceinline__ int tc_live_tiles(const TcUnit& un, int w,
                                             const Geom& g, int causal,
                                             int bk) {
  if (un.q0 + 64 * w >= g.Sq) return 0;
  const int last = min(un.q0 + 64 * w + 63, g.Sq - 1);
  return causal ? max(0, min(un.t0 + un.n_tiles, last / bk + 1) - un.t0)
                : un.n_tiles;
}

// One row's output for 4 column groups (i0 .. i0 + 3 of the accumulator
// layout; row a at r 0, row b at r 2), scaled by inv and rounded to
// bfloat16, transposed among the 4 threads of the row (lane & 3 = t): in,
// thread t holds columns 8 i + 2 t, + 1 of each group i; out, all 8 columns
// of group i0 + t, in order.  Two butterfly steps over lanes t ^ 2 and
// t ^ 1, two shuffles each.
template <int N>
__device__ __forceinline__ void store_quad(uint4& out, const float (&acc)[N],
                                           int i0, int r, float inv,
                                           int lane) {
  uint32_t x0 = pack_bf16(acc[4 * i0 + r] * inv, acc[4 * i0 + r + 1] * inv);
  uint32_t x1 = pack_bf16(acc[4 * i0 + 4 + r] * inv,
                          acc[4 * i0 + 5 + r] * inv);
  uint32_t x2 = pack_bf16(acc[4 * i0 + 8 + r] * inv,
                          acc[4 * i0 + 9 + r] * inv);
  uint32_t x3 = pack_bf16(acc[4 * i0 + 12 + r] * inv,
                          acc[4 * i0 + 13 + r] * inv);
  const bool h2 = lane & 2, h1 = lane & 1;
  uint32_t s0 = __shfl_xor_sync(0xffffffffu, h2 ? x0 : x2, 2);
  uint32_t s1 = __shfl_xor_sync(0xffffffffu, h2 ? x1 : x3, 2);
  if (h2) {
    x0 = s0;
    x1 = s1;
  } else {
    x2 = s0;
    x3 = s1;
  }
  s0 = __shfl_xor_sync(0xffffffffu, h1 ? x0 : x1, 1);
  s1 = __shfl_xor_sync(0xffffffffu, h1 ? x2 : x3, 1);
  if (h1) {
    x0 = s0;
    x2 = s1;
  } else {
    x1 = s0;
    x3 = s1;
  }
  out = make_uint4(x0, x1, x2, x3);
}

// The ping-pong schedule's named barriers (barrier 0 is __syncthreads):
// consumer warpgroup w waits on kTurnBar + w (bar.sync) for its turn to
// issue its products and passes the turn by arriving on the other's
// (bar.arrive); each counts 256 threads, 128 waiting and 128 arriving.
// Predicated on `on` (the same in all of a warpgroup's threads), so that no
// branch sits among the wgmma instructions.
constexpr int kTurnBar = 1;

__device__ __forceinline__ void turn_wait(int wg, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
               "@p bar.sync %0, 256;\n}\n"
               :: "r"(kTurnBar + wg), "r"((int)on) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
               "@p bar.arrive %0, 256;\n}\n"
               :: "r"(kTurnBar + 1 - wg), "r"((int)on) : "memory");
}

template <int D, int DV, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, Geom g, float scale_log2,
                int causal, Split split) {
  using L = TcSmem<D, DV>;
  constexpr int kStages = L::kStages;
  constexpr int kBK = L::kBK;
  constexpr int kN = L::kVC * 64;        // accumulator columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;     // a warpgroup's Q rows: one each
  uint64_t* qempty = qfull + kWG;

  if constexpr (kSplit) {
    // the combine pass may be scheduled once every block has started (it
    // waits for this grid's completion before it reads)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    TcUnit un;
    if (!tc_unit<true>(0, g, causal, kBK, split.tpc, un)) return;
  }
  const int rounds =
      kSplit ? 1
             : (int)(((long long)g.B * g.H * ((g.Sq + kTcBQ - 1) / kTcBQ) +
                      gridDim.x - 1) / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);     // one arrival per consumer warp
    }
    for (int w = 0; w < kWG; ++w) {
      mbar_init(&qfull[w], 1);
      mbar_init(&qempty[w], 4);          // one arrival per warp of w
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {
    // producer warpgroup: one thread issues every copy, the units' K/V
    // tiles in one ring (it: tiles issued so far); a unit's Q after its
    // first K/V tile, each warpgroup's 64 rows once that warpgroup's last
    // product of the last unit has read its old ones, so that both land
    // while it finishes the last unit (a warpgroup without rows gets an
    // arrival, to keep its barrier's phases in step)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kWG * 128) {
      int it = 0, n = 0;
      TcUnit un;
      for (int r = 0; r < rounds; ++r) {
        if (!tc_unit<kSplit>(r, g, causal, kBK, split.tpc, un)) continue;
        const int kvh = un.h / (g.H / g.KV);
        const int live_wgs = min(kWG, (g.Sq - un.q0 + 63) / 64);
        for (int j = 0; j < un.n_tiles; ++j, ++it) {
          const int s = it % kStages;
          const int key = (un.t0 + j) * kBK;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::kKBytes + L::kVBytes);
          for (int c = 0; c < L::kQC; ++c)
            tma_load(smem + L::kKOff + s * L::kKBytes + c * kBK * 128, &kmap,
                     &full[s], c * 64, kvh, key, un.b);
          for (int c = 0; c < L::kVC; ++c)
            tma_load(smem + L::kVOff + s * L::kVBytes + c * kBK * 128, &vmap,
                     &full[s], c * 64, kvh, key, un.b);
          for (int w = 0; w < kWG && j == 0; ++w) {
            mbar_wait(&qempty[w], (n & 1) ^ 1);
            if (w < live_wgs) {
              mbar_expect_tx(&qfull[w], 64 * L::kQC * 128);
              for (int c = 0; c < L::kQC; ++c)
                tma_load(smem + (w * L::kQC + c) * kTile, &qmap, &qfull[w],
                         c * 64, un.h, un.q0 + 64 * w, un.b);
            } else {
              mbar_arrive(&qfull[w]);
            }
          }
        }
        ++n;
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63 of
    // each unit
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const uint32_t q_s = smem_u32(smem + wg * L::kQC * kTile);
    const auto k_smem = [&](int j) {
      return smem_u32(smem + L::kKOff + (j % kStages) * L::kKBytes);
    };
    const auto v_smem = [&](int j) {
      return smem_u32(smem + L::kVOff + (j % kStages) * L::kVBytes);
    };
    const auto arrive = [&](uint64_t* bar) {   // this warp is done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    const auto wait_full = [&](int j) {
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
    };
    // Ping-pong: the two warpgroups take turns to issue their products
    // (S of one tile, P·V of the last), warpgroup 0 first, so that one's
    // softmax, rescale and pack run on the CUDA cores while the other's
    // products hold the tensor cores.  A unit where both warpgroups read
    // keys takes max(their live tiles) + 1 turns of each; the one with a
    // tile fewer (64-key tiles on the diagonal) takes its last turn empty,
    // so that the arrivals match.  The turns run on across the block's
    // units: warpgroup 0 waits for every turn but the block's first, and
    // warpgroup 1 passes every turn but the block's last.  A unit with one
    // live warpgroup takes no turns.
    bool first_turn = true;
    int it = 0, n = 0;
    TcUnit un;
    for (int r = 0; r < rounds; ++r) {
      if (!tc_unit<kSplit>(r, g, causal, kBK, split.tpc, un)) continue;
      const int q0w = un.q0 + 64 * wg;
      // accumulator layout of wgmma m64nN: this thread holds rows row_a and
      // row_a + 8, columns 8 i + c2 and 8 i + c2 + 1 of every 8-column group
      const int row_a = q0w + warp * 16 + (lane >> 2);
      const int row_b = row_a + 8;
      const int c2 = 2 * (lane & 3);
      const int n_live = tc_live_tiles(un, wg, g, causal, kBK);
      const int n_other = tc_live_tiles(un, wg ^ 1, g, causal, kBK);
      const int turns = n_live > 0 && n_other > 0
                            ? max(n_live, n_other) + 1 : 0;
      bool later = false;      // a later unit of this block takes turns
      if (wg == 1) {
        TcUnit next;
        for (int r2 = r + 1; r2 < rounds && !later; ++r2)
          later = tc_unit<kSplit>(r2, g, causal, kBK, split.tpc, next) &&
                  tc_live_tiles(next, 0, g, causal, kBK) > 0 &&
                  tc_live_tiles(next, 1, g, causal, kBK) > 0;
      }
      const auto turn_begin = [&]() {
        turn_wait(wg, turns && (wg == 1 || !first_turn));
        first_turn = first_turn && !turns;
      };
      const auto turn_end = [&](int t) {
        turn_pass(wg, turns && (wg == 0 || t + 1 < turns || later));
      };

      float acc[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
      // running max (in log2 units) and this thread's part of the
      // denominator
      RowState st{kNegInf, kNegInf, 0.f, 0.f};
      uint32_t p[kBK / 4];
      float al_a, al_b;
      mbar_wait(&qfull[wg], n & 1);
      if (n_live > 0) {
        wait_full(it);
        float sc[kBK / 2];
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
        fence_regs(sc);
        turn_begin();
        wg_fence();
        issue_qk<D, kBK>(sc, q_s, k_smem(it));
        turn_end(0);
        wg_wait<0>();
        fence_regs(sc);
        if (n_live == 1) arrive(&qempty[wg]);
        softmax_tile<kBK>(sc, st, al_a, al_b, un.t0 * kBK, q0w, row_a, c2,
                          g.Sk, scale_log2, causal);
        pack_p<kBK>(sc, p);
      }
      // Inside a warpgroup too, tile j's P·V runs on the tensor cores while
      // the softmax of tile j+1 runs on the CUDA cores: S(j+1) and P·V(j)
      // are issued together and S is waited for first, and the
      // accumulator's rescale for tile j runs between the two issues,
      // under S(j+1).  P(j)'s registers stay fenced until P·V(j) is
      // retired, so the compiler gives none of them to the softmax
      // meanwhile (ptxas would serialize the wgmmas, C7513); P(j+1) is
      // packed after.
      for (int j = 0; j + 1 < n_live; ++j) {
        wait_full(it + j + 1);
        float sc[kBK / 2];
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(p);
        turn_begin();
        wg_fence();
        issue_qk<D, kBK>(sc, q_s, k_smem(it + j + 1));
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[i] *= (i & 2) ? al_b : al_a;
        wg_fence();
        issue_pv<kN, kBK>(acc, p, v_smem(it + j));
        turn_end(j + 1);
        wg_wait<1>();
        fence_regs(sc);
        softmax_tile<kBK>(sc, st, al_a, al_b, (un.t0 + j + 1) * kBK, q0w,
                          row_a, c2, g.Sk, scale_log2, causal);
        wg_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        arrive(&empty[(it + j) % kStages]);
        if (j + 2 == n_live) arrive(&qempty[wg]);
        pack_p<kBK>(sc, p);
      }
      if (n_live > 0) {
        fence_regs(acc);
        fence_regs(p);
        turn_begin();
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[i] *= (i & 2) ? al_b : al_a;
        wg_fence();
        issue_pv<kN, kBK>(acc, p, v_smem(it + n_live - 1));
        turn_end(n_live);
        wg_wait<0>();
        fence_regs(acc);
        arrive(&empty[(it + n_live - 1) % kStages]);
      }
      for (int t = n_live + 1; t < turns; ++t) {   // the empty turn
        turn_begin();
        turn_end(t);
      }
      if (n_live == 0) arrive(&qempty[wg]);
      // tiles past the warpgroup's diagonal: keep the ring's phases in step
      for (int j = n_live; j < un.n_tiles; ++j) {
        wait_full(it + j);
        arrive(&empty[(it + j) % kStages]);
      }
      // every warpgroup with rows writes: a chunk past its diagonal (no
      // live tile) its empty part, for the combine to weigh by zero
      if (q0w < g.Sq) {
        float l_a = st.l_a, l_b = st.l_b;
        l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
        l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
        if (kSplit && un.chunks > 1) {
          // this chunk's part: rows of (chunk, b·H + h) in the workspace
          const size_t rows = (size_t)gridDim.x * g.Sq;
          const size_t base = ((size_t)blockIdx.z * gridDim.x + blockIdx.x) *
                              g.Sq;
          float* ws_o = split.ws;
          float* ws_m = split.ws + rows * gridDim.z * DV;
          float* ws_l = ws_m + rows * gridDim.z;
#pragma unroll
          for (int i = 0; i < DV / 8; ++i) {
            const int col = 8 * i + c2;
            if (row_a < g.Sq)
              *reinterpret_cast<float2*>(ws_o + (base + row_a) * DV + col) =
                  make_float2(acc[4 * i], acc[4 * i + 1]);
            if (row_b < g.Sq)
              *reinterpret_cast<float2*>(ws_o + (base + row_b) * DV + col) =
                  make_float2(acc[4 * i + 2], acc[4 * i + 3]);
          }
          if ((lane & 3) == 0) {
            if (row_a < g.Sq) {
              ws_m[base + row_a] = st.m_a;
              ws_l[base + row_a] = l_a;
            }
            if (row_b < g.Sq) {
              ws_m[base + row_b] = st.m_b;
              ws_l[base + row_b] = l_b;
            }
          }
        } else {
          // o = acc / max(l, 1e-30): a reciprocal a row, a multiply an
          // element; each row's pairs of 4 column groups transposed among
          // the row's 4 threads, so that a thread stores 16 bytes (one
          // group of 8 columns) where it held 4 (a pair of each)
          const float inv_a = __frcp_rn(fmaxf(l_a, 1e-30f));
          const float inv_b = __frcp_rn(fmaxf(l_b, 1e-30f));
          __nv_bfloat16* ob = o + un.b * g.osb + un.h * g.osh;
#pragma unroll
          for (int m = 0; m < kN / 32; ++m) {
            uint4 ra, rb;
            store_quad(ra, acc, 4 * m, 0, inv_a, lane);
            store_quad(rb, acc, 4 * m, 2, inv_b, lane);
            const int col = 8 * (4 * m + (lane & 3));
            if (col < DV) {
              if (row_a < g.Sq)
                *reinterpret_cast<uint4*>(ob + row_a * g.oss + col) = ra;
              if (row_b < g.Sq)
                *reinterpret_cast<uint4*>(ob + row_b * g.oss + col) = rb;
            }
          }
        }
      }
      it += un.n_tiles;
      ++n;
    }
  }
}

// The split's second pass, over the rows r0 .. Sq - 1 of every head (the
// q-tiles with more than one chunk: under the causal mask the last ones):
// one thread a row's eight columns.  The chunks' parts are rescaled to the
// largest running max, summed and divided, as the online softmax does from
// tile to tile; o in bfloat16.  The loops run to kMaxChunks with the loads
// predicated, so that a thread issues all its loads before the first use.
// Launched as a programmatic dependent of flash_fwd_wgmma: its blocks may
// start while the last ones of the first pass run, and wait here for that
// grid's completion and its writes.
constexpr int kMaxChunks = 16;

__global__ void __launch_bounds__(256)
flash_fwd_combine(const float* __restrict__ ws,
                  __nv_bfloat16* __restrict__ o, Geom g, int tpc, int bk,
                  int n_chunks, int causal, int r0) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int groups = g.dv / 8;
  const long long span = (long long)(g.Sq - r0) * groups;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= span * g.B * g.H) return;
  const int bh = (int)(idx / span);
  const long long rest = idx - bh * span;
  const int row = r0 + (int)(rest / groups);
  const int col = (int)(rest - (long long)(row - r0) * groups) * 8;
  const int q0 = row / kTcBQ * kTcBQ;
  const int chunks = (tc_row_tiles(q0, g.Sq, g.Sk, bk, causal) + tpc - 1) /
                     tpc;
  const size_t rows = (size_t)g.B * g.H * g.Sq;
  const size_t r = (size_t)bh * g.Sq + row;
  const float* ws_m = ws + rows * n_chunks * g.dv;
  const float* ws_l = ws_m + rows * n_chunks;
  float m[kMaxChunks], l[kMaxChunks];
  float mx = kNegInf;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    m[c] = c < chunks ? ws_m[c * rows + r] : kNegInf;
    l[c] = c < chunks ? ws_l[c * rows + r] : 0.f;
    mx = fmaxf(mx, m[c]);
  }
  float den = 0.f;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < chunks) {
      const float w = exp2f(m[c] - mx);
      const float4* part =
          reinterpret_cast<const float4*>(ws + (c * rows + r) * g.dv + col);
      const float4 lo = part[0], hi = part[1];
      den += w * l[c];
      sum[0] += w * lo.x;
      sum[1] += w * lo.y;
      sum[2] += w * lo.z;
      sum[3] += w * lo.w;
      sum[4] += w * hi.x;
      sum[5] += w * hi.y;
      sum[6] += w * hi.z;
      sum[7] += w * hi.w;
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  *reinterpret_cast<uint4*>(o + b * g.osb + h * g.osh + row * g.oss + col) =
      make_uint4(pack_bf16(sum[0] * inv, sum[1] * inv),
                 pack_bf16(sum[2] * inv, sum[3] * inv),
                 pack_bf16(sum[4] * inv, sum[5] * inv),
                 pack_bf16(sum[6] * inv, sum[7] * inv));
}

// ---------------------------------------------------------------------------
// Tensor-core variant in float32: 3xTF32 wgmma (flash_fwd_wgmma_tf32)
// ---------------------------------------------------------------------------

// D (64 x 64, float32) += A (64 x 8, tf32 in shared memory) * B (8 x 64,
// tf32 in shared memory); both K-major with the 128-byte swizzle.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// Roles of the block's 256 threads: warps 0-3 the consumer warpgroup (64
// query rows: the products and the softmax), warps 4-7 the transform
// warpgroup (copies K into hi and lo tiles, transposes V into Vᵀ hi and
// lo), whose first thread also issues the TMA copies.  One block per SM
// (its shared memory), so every thread may keep up to 255 registers.
constexpr int kF32Threads = 256;
constexpr int kF32Rows = 64;
constexpr int kF32BK = 64;                 // keys per tile

// Shared memory of flash_fwd_wgmma_tf32 at head width D (64 or 128), from
// a 1024-byte aligned base.  Every tile is made of [rows][32 floats] atoms
// of 128-byte rows in the 128-byte swizzle.  In order: Q's lo (its hi lives
// in the consumers' registers); K of one tile as hi and lo; Vᵀ of one tile
// as hi and lo (rows = columns of d, K positions = keys in key_at order;
// Q lands in Vᵀ's hi tiles, free until the first V); K and V of the next
// tile as TMA lands them; eight mbarriers.  K and Vᵀ have one buffer each
// but barriers of their own: the next K is written while P·V runs, the next
// Vᵀ while the next S runs.  230,464 bytes at d 128, 115,776 at d 64.
template <int D>
struct F32Smem {
  static constexpr int kQAtom = kF32Rows * 128;    // a [64][32] atom of Q
  static constexpr int kQBytes = kF32Rows * D * 4;  // Q, or its lo
  static constexpr int kTBytes = kF32BK * D * 4;    // one tile of K or V
  static constexpr int kK = kQBytes;                // K hi, then K lo
  static constexpr int kVt = kK + 2 * kTBytes;      // Vᵀ hi, then Vᵀ lo
  static constexpr int kKRaw = kVt + 2 * kTBytes;
  static constexpr int kVRaw = kKRaw + kTBytes;
  static constexpr int kBarOff = kVRaw + kTBytes;
  static constexpr int kBytes = kBarOff + 8 * 8;
  static constexpr int kAlloc = kBytes + 1024;      // room to align
  static_assert(kQBytes <= kTBytes, "Q does not fit in Vᵀ's hi tiles");
  static_assert(kAlloc <= 232448, "more than a block's shared memory");
};

// The kernel's dynamic shared memory, addressed by offsets from this symbol
// (so loads and stores compile to LDS and STS, not generic accesses).
extern __shared__ __align__(16) uint8_t f32_smem[];

template <typename T>
__device__ __forceinline__ T& fsm(uint32_t off) {
  return *reinterpret_cast<T*>(f32_smem + off);
}

// The 16-byte chunks [first, end) (step `step`) of a raw tile at `src`,
// split: hi to `hi` (left in place when hi == src), lo to `lo`, at the
// same offsets (the swizzle moves whole chunks, so a chunk's layout is the
// same in every tile).
__device__ __forceinline__ void split_copy(uint32_t src, uint32_t hi,
                                           uint32_t lo, int first, int end,
                                           int step) {
  for (int u = first; u < end; u += step) {
    const uint4 v = fsm<uint4>(src + 16 * u);
    uint4 h, l;
    split_tf32(__uint_as_float(v.x), h.x, l.x);
    split_tf32(__uint_as_float(v.y), h.y, l.y);
    split_tf32(__uint_as_float(v.z), h.z, l.z);
    split_tf32(__uint_as_float(v.w), h.w, l.w);
    if (hi != src) fsm<uint4>(hi + 16 * u) = h;
    fsm<uint4>(lo + 16 * u) = l;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_wgmma_tf32(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     float* __restrict__ o, Geom g, float scale_log2,
                     int causal) {
  using L = F32Smem<D>;
  constexpr int BK = kF32BK;
  const uint32_t base = smem_u32(f32_smem);
  const uint32_t pad = (1024 - (base & 1023)) & 1023;
  const uint32_t qraw = pad + L::kVt;       // Q as TMA lands it
  const uint32_t qbar = pad + L::kBarOff;   // Q has landed
  const uint32_t qfree = qbar + 8;    // the consumers are done with it
  const uint32_t kraw = qfree + 8;    // the next K has landed
  const uint32_t vraw = kraw + 8;     // the next V has landed
  const uint32_t kfull = vraw + 8;    // K's hi and lo tiles are written
  const uint32_t vfull = kfull + 8;   // Vᵀ's hi and lo tiles are written
  const uint32_t kempty = vfull + 8;  // S no longer reads K
  const uint32_t vempty = kempty + 8; // P·V no longer reads Vᵀ
  const auto bar = [&](uint32_t off) { return &fsm<uint64_t>(off); };

  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x - b * g.H;
  const int kvh = h / (g.H / g.KV);
  // causal: the heaviest q-tiles (the last ones) are launched first
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * kF32Rows;
  const int last_row = min(q0 + kF32Rows, g.Sq) - 1;
  const int k_tiles = (g.Sk + BK - 1) / BK;
  const int n_tiles = causal ? min(k_tiles, last_row / BK + 1) : k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar(qbar), 1);
    mbar_init(bar(kraw), 1);
    mbar_init(bar(vraw), 1);
    mbar_init(bar(qfree), 4);    // the consumer warps
    mbar_init(bar(kempty), 4);
    mbar_init(bar(vempty), 4);
    mbar_init(bar(kfull), 4);    // the transform warps
    mbar_init(bar(vfull), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 4) {
    // transform warpgroup.  Its first thread issues every TMA copy: Q, the
    // first K and V at once, each next K (V) as soon as the current one
    // has left its raw tile.
    const int ptid = threadIdx.x - 128;
    const auto load = [&](const CUtensorMap* map, uint32_t dst,
                          uint32_t rb, int t) {
      mbar_expect_tx(bar(rb), L::kTBytes);
      for (int a = 0; a < D / 32; ++a)
        tma_load(&fsm<uint8_t>(dst + a * BK * 128), map, bar(rb), 32 * a,
                 kvh, t * BK, b);
    };
    const auto done = [&](uint32_t fullb) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(fullb));
      asm volatile("bar.sync 2, 128;\n" ::: "memory");  // the raw tile is read
    };
    if (ptid == 0) {
      mbar_expect_tx(bar(qbar), L::kQBytes);
      for (int a = 0; a < D / 32; ++a)
        tma_load(&fsm<uint8_t>(qraw + a * L::kQAtom), &qmap, bar(qbar),
                 32 * a, h, q0, b);
      load(&kmap, pad + L::kKRaw, kraw, 0);
      load(&vmap, pad + L::kVRaw, vraw, 0);
    }
    // V's transpose, 16 elements at a time: 4 keys (K positions 4j .. 4j +
    // 3, keys key_at(4j + i)) by 4 columns, read as four 16-byte chunks of
    // V's rows and written as four of Vᵀ's.  Lane l of a quarter warp takes
    // j = l and column chunk 2 (l / 2) + x % 2 + 2 (x / 2 % 4) (mod 8), so
    // that the reads and the writes of a quarter warp each fall on eight
    // distinct 16-byte bank groups.
    const int l = ptid & 7;
    for (int t = 0; t < n_tiles; ++t) {
      const int ph = t & 1;
      mbar_wait(bar(kraw), ph);
      mbar_wait(bar(kempty), ph ^ 1);          // S(t - 1) is done
      split_copy(pad + L::kKRaw, pad + L::kK, pad + L::kK + L::kTBytes,
                 ptid, L::kTBytes / 16, 128);
      done(kfull);
      if (ptid == 0 && t + 1 < n_tiles)
        load(&kmap, pad + L::kKRaw, kraw, t + 1);

      mbar_wait(bar(vraw), ph);
      if (t == 0) mbar_wait(bar(qfree), 0);    // Q lies in Vᵀ's hi tiles
      mbar_wait(bar(vempty), ph ^ 1);          // P·V(t - 1) is done
#pragma unroll
      for (int it = 0; it < BK * D / 2048; ++it) {
        const int x = (ptid >> 3) + 16 * it;
        const int cch = (2 * (l >> 1) + (x & 1) + 2 * ((x >> 1) & 3)) & 7;
        const int catom = (x >> 3) % (D / 32);
        const int katom = (x >> 3) / (D / 32);
        const uint32_t vr = pad + L::kVRaw + catom * (BK * 128);
        float4 r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 32 * katom + 8 * (l >> 1) + 2 * i + (l & 1);
          r[i] = fsm<float4>(vr + key * 128 + (((cch ^ key) & 7) << 4));
        }
        const float col[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x},
                                 {r[0].y, r[1].y, r[2].y, r[3].y},
                                 {r[0].z, r[1].z, r[2].z, r[3].z},
                                 {r[0].w, r[1].w, r[2].w, r[3].w}};
        const uint32_t vt = pad + L::kVt + katom * (D * 128);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 32 * catom + 4 * cch + e;
          uint4 hi, lo;
          split_tf32(col[e][0], hi.x, lo.x);
          split_tf32(col[e][1], hi.y, lo.y);
          split_tf32(col[e][2], hi.z, lo.z);
          split_tf32(col[e][3], hi.w, lo.w);
          const uint32_t off = vt + c * 128 + (((l ^ c) & 7) << 4);
          fsm<uint4>(off) = hi;
          fsm<uint4>(off + L::kTBytes) = lo;
        }
      }
      done(vfull);
      if (ptid == 0 && t + 1 < n_tiles)
        load(&vmap, pad + L::kVRaw, vraw, t + 1);
    }
  } else {
    // consumer warpgroup: query rows q0 .. q0 + 63
    const int tid = threadIdx.x;
    // accumulator layout of wgmma m64nN: this thread holds rows row_a and
    // row_a + 8, columns 8 i + c2 and 8 i + c2 + 1 of every 8-column group
    const int r0 = warp * 16 + (lane >> 2);
    const int row_a = q0 + r0;
    const int row_b = row_a + 8;
    const int t4 = lane & 3;
    const int c2 = 2 * t4;
    const uint32_t q_lo = base + pad;
    const uint32_t k_hi = base + pad + L::kK;
    const uint32_t vt_hi = base + pad + L::kVt;

    // Q's hi as the A fragments of S's D/8 k-steps (rows r0 and r0 + 8,
    // columns 8 kk + t4 and + 4), its lo into the lo tiles
    mbar_wait(bar(qbar), 0);
    uint32_t qh[D / 2];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t at = qraw + (kk >> 2) * L::kQAtom;
      const int col = 8 * (kk & 3) + t4;
      qh[4 * kk] = fsm<uint32_t>(at + sw_off(r0, col)) & 0xffffe000u;
      qh[4 * kk + 1] = fsm<uint32_t>(at + sw_off(r0 + 8, col)) & 0xffffe000u;
      qh[4 * kk + 2] = fsm<uint32_t>(at + sw_off(r0, col + 4)) & 0xffffe000u;
      qh[4 * kk + 3] =
          fsm<uint32_t>(at + sw_off(r0 + 8, col + 4)) & 0xffffe000u;
    }
    split_copy(qraw, qraw, pad, tid, L::kQBytes / 16, 128);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(qfree));
    asm volatile("bar.sync 1, 128;\n" ::: "memory");   // Q's lo is written

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // running max (in log2 units) and this thread's part of the denominator
    RowState st{kNegInf, kNegInf, 0.f, 0.f};
    const auto release = [&](uint32_t emptyb) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(emptyb));
    };
    for (int t = 0; t < n_tiles; ++t) {
      // S = Q·Kᵀ: D/8 k-steps, three products each (Q hi from registers,
      // Q lo from shared memory), one group
      mbar_wait(bar(kfull), t & 1);
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      fence_regs(qh);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qo = (kk >> 2) * L::kQAtom + (kk & 3) * 32;
        const uint32_t ko = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
        const uint64_t dql = sw128_desc(q_lo + qo, 16, 1024);
        const uint64_t dkh = sw128_desc(k_hi + ko, 16, 1024);
        const uint64_t dkl = sw128_desc(k_hi + L::kTBytes + ko, 16, 1024);
        wgmma_tf32_n64(sc, qh + 4 * kk, dkh);
        wgmma_tf32_n64(sc, qh + 4 * kk, dkl);
        wgmma_tf32_ss_n64(sc, dql, dkh);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(qh);
      release(kempty);
      float al_a, al_b;
      softmax_tile<BK>(sc, st, al_a, al_b, t * BK, q0, row_a, c2, g.Sk,
                       scale_log2, causal);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al_b : al_a;
      // O += P·V: P in float32 (v's dtype) from the accumulator, split into
      // hi and lo A fragments: K positions (t, t + 4) of each k-step hold
      // the keys (2t, 2t + 1) that the accumulator gives this thread
      uint32_t ph[BK / 2], pl[BK / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        split_tf32(sc[4 * kk], ph[4 * kk], pl[4 * kk]);              // (a, t)
        split_tf32(sc[4 * kk + 2], ph[4 * kk + 1], pl[4 * kk + 1]);  // (b, t)
        split_tf32(sc[4 * kk + 1], ph[4 * kk + 2], pl[4 * kk + 2]);  // (a, t+4)
        split_tf32(sc[4 * kk + 3], ph[4 * kk + 3], pl[4 * kk + 3]);  // (b, t+4)
      }
      mbar_wait(bar(vfull), t & 1);
      mma_batch<D, BK / 8>(acc, ph, pl, vt_hi, vt_hi + L::kTBytes, D * 128,
                           0);
      release(vempty);
    }

    float l_a = st.l_a, l_b = st.l_b;
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f);
    const float den_b = fmaxf(l_b, 1e-30f);
    float* ob = o + b * g.osb + h * g.osh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + c2;
      if (row_a < g.Sq)
        *reinterpret_cast<float2*>(ob + row_a * g.oss + col) =
            make_float2(acc[4 * i] / den_a, acc[4 * i + 1] / den_a);
      if (row_b < g.Sq)
        *reinterpret_cast<float2*>(ob + row_b * g.oss + col) =
            make_float2(acc[4 * i + 2] / den_b, acc[4 * i + 3] / den_b);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variants: host side
// ---------------------------------------------------------------------------

// Return code past the CUDA runtime's own and hopper.cuh's
constexpr int kErrRegs = 10003;        // too few registers for setmaxnreg

// A 4-D map over (batch, rows, heads, d) in bfloat16 or float32 with the
// given element strides; boxes of [box_rows][128 bytes of columns] (64
// bfloat16, 32 float32), 128-byte swizzle, rows outside the tensor read as
// zeros.
int make_map(CUtensorMap* map, const void* base, bool f32, int batch,
             int rows, int heads, int d, long long sb, long long ss,
             long long sh, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return kErrNoEncoder;
  const int esize = f32 ? 4 : 2;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)(sh * esize), (cuuint64_t)(ss * esize),
                           (cuuint64_t)(sb * esize)};
  cuuint32_t box[4] = {(cuuint32_t)(128 / esize), 1, (cuuint32_t)box_rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = enc(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// Once per process (one device) and instantiation: the registers that
// setmaxnreg needs, and the dynamic shared memory.
template <int D, int DV, bool kSplit>
int tc_setup() {
  static int setup = -1;
  if (setup < 0) {
    cudaFuncAttributes attr;
    setup = (int)cudaFuncGetAttributes(&attr, flash_fwd_wgmma<D, DV, kSplit>);
    // setmaxnreg moves registers inside the block's allocation: the block
    // must start with enough for the consumers' 240 and the producer's 24
    if (!setup && attr.numRegs * kTcThreads <
                      kConsumerRegs * 128 * kWG + kProducerRegs * 128)
      setup = kErrRegs;
    if (!setup)
      setup = (int)cudaFuncSetAttribute(
          flash_fwd_wgmma<D, DV, kSplit>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem<D, DV>::kAlloc);
  }
  return setup;
}

// chunks > 1 splits each q-tile's key tiles into chunks of tpc (the plan of
// kernels/flash_attention.py: split_plan) over the grid's z axis, with the
// float32 workspace ws of (dv + 2)·chunks·B·H·Sq elements, and combines
// them with flash_fwd_combine; chunks == 1 launches the persistent grid,
// one block an SM (no more than the units), which walks the (head, q-tile)
// units (tc_unit).
template <int D, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Geom& g, float scale, int causal, int chunks, int tpc,
                 float* ws, cudaStream_t stream) {
  using L = TcSmem<D, DV>;
  const int q_tiles = (g.Sq + kTcBQ - 1) / kTcBQ;
  if (chunks > 1) {
    // the last q-tile reads the most key tiles: every one in a chunk
    const int most =
        tc_row_tiles((q_tiles - 1) * kTcBQ, g.Sq, g.Sk, L::kBK, causal);
    if (!ws || tpc < 1 || chunks > kMaxChunks ||
        (long long)chunks * tpc < most)
      return (int)cudaErrorInvalidValue;
  } else if (chunks != 1) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = chunks > 1 ? tc_setup<D, DV, true>() : tc_setup<D, DV, false>();
  if (rc) return rc;
  CUtensorMap qm, km, vm;
  rc = make_map(&qm, q, false, g.B, g.Sq, g.H, D, g.qsb, g.qss, g.qsh, 64);
  if (!rc)
    rc = make_map(&km, k, false, g.B, g.Sk, g.KV, D, g.ksb, g.kss, g.ksh,
                  L::kBK);
  if (!rc)
    rc = make_map(&vm, v, false, g.B, g.Sk, g.KV, DV, g.vsb, g.vss, g.vsh,
                  L::kBK);
  if (rc) return rc;
  const float scale_log2 = scale * 1.4426950408889634f;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  if (chunks == 1) {
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    const long long units = (long long)g.B * g.H * q_tiles;
    const dim3 grid((unsigned)(units < sms ? units : sms));
    flash_fwd_wgmma<D, DV, false><<<grid, kTcThreads, L::kAlloc, stream>>>(
        qm, km, vm, out, g, scale_log2, causal, Split{0, nullptr});
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)(g.B * g.H), (unsigned)q_tiles, (unsigned)chunks);
  flash_fwd_wgmma<D, DV, true><<<grid, kTcThreads, L::kAlloc, stream>>>(
      qm, km, vm, out, g, scale_log2, causal, Split{tpc, ws});
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // the first row whose q-tile has more than one chunk
  int first = 0;
  while (first < q_tiles - 1 &&
         tc_row_tiles(first * kTcBQ, g.Sq, g.Sk, L::kBK, causal) <= tpc)
    ++first;
  const int r0 = first * kTcBQ;
  const long long threads = (long long)g.B * g.H * (g.Sq - r0) * (DV / 8);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((threads + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_fwd_combine, (const float*)ws,
                                 out, g, tpc, L::kBK, chunks, causal, r0);
}

template <int D>
int launch_wgmma_tf32(const void* q, const void* k, const void* v, void* o,
                      const Geom& g, float scale, int causal,
                      cudaStream_t stream) {
  using L = F32Smem<D>;
  static int setup = -1;     // once per process (one device)
  if (setup < 0)
    setup = (int)cudaFuncSetAttribute(
        flash_fwd_wgmma_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kAlloc);
  if (setup) return setup;
  CUtensorMap qm, km, vm;
  int rc = make_map(&qm, q, true, g.B, g.Sq, g.H, D, g.qsb, g.qss, g.qsh,
                    kF32Rows);
  if (!rc)
    rc = make_map(&km, k, true, g.B, g.Sk, g.KV, D, g.ksb, g.kss, g.ksh,
                  kF32BK);
  if (!rc)
    rc = make_map(&vm, v, true, g.B, g.Sk, g.KV, D, g.vsb, g.vss, g.vsh,
                  kF32BK);
  if (rc) return rc;
  dim3 grid((unsigned)(g.B * g.H),
            (unsigned)((g.Sq + kF32Rows - 1) / kF32Rows));
  flash_fwd_wgmma_tf32<D><<<grid, kF32Threads, L::kAlloc, stream>>>(
      qm, km, vm, static_cast<float*>(o), g, scale * 1.4426950408889634f,
      causal);
  return (int)cudaGetLastError();
}

// Registers a thread, shared memory a block and blocks per SM of a kernel
// launched with `threads` threads and `dyn` bytes of dynamic shared memory.
template <typename K>
int kernel_info(K kernel, int threads, int dyn, int* regs, int* smem,
                int* blocks) {
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, kernel);
  if (!rc)
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (rc) return rc;
  *regs = attr.numRegs;
  *smem = (int)attr.sharedSizeBytes + dyn;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, dyn);
}

}  // namespace

// What a block of a tensor-core kernel at q/k width d and v width dv
// takes: flash_fwd_wgmma (tf32 == 0: d 64, 112, 128 or 192, dv == d or
// d 192 / dv 128) or flash_fwd_wgmma_tf32 (tf32 == 1: d 64 or 128, dv ==
// d).  Registers a thread at launch (before any setmaxnreg), shared memory
// a block (static and dynamic), and how many blocks fit on one SM of this
// device.
extern "C" int flash_attention_tc_info(int d, int dv, int tf32, int* regs,
                                       int* smem, int* blocks) {
  if (tf32) {
    if (dv != d) return (int)cudaErrorInvalidValue;
    if (d == 64)
      return kernel_info(flash_fwd_wgmma_tf32<64>, kF32Threads,
                         F32Smem<64>::kAlloc, regs, smem, blocks);
    if (d == 128)
      return kernel_info(flash_fwd_wgmma_tf32<128>, kF32Threads,
                         F32Smem<128>::kAlloc, regs, smem, blocks);
    return (int)cudaErrorInvalidValue;
  }
#define TC_INFO(D, DV)                                                     \
  if (d == D && dv == DV)                                                  \
    return kernel_info(flash_fwd_wgmma<D, DV, false>, kTcThreads,          \
                       TcSmem<D, DV>::kAlloc, regs, smem, blocks);
  TC_INFO(64, 64)
  TC_INFO(112, 112)
  TC_INFO(128, 128)
  TC_INFO(192, 192)
  TC_INFO(192, 128)
#undef TC_INFO
  return (int)cudaErrorInvalidValue;
}

// Kernels behind flash_attention_launch's `kind`
constexpr int kKindSimt = 0;   // flash_fwd_simt: float32 or bfloat16, d <= 256
constexpr int kKindTc = 1;     // flash_fwd_wgmma: bfloat16, d 64/112/128/192
constexpr int kKindTf32 = 2;   // flash_fwd_wgmma_tf32: float32, d 64 or 128
constexpr int kKindMma = 3;    // flash_fwd_mma: either dtype, d % 8 == 0

// q: (B, Sq, H, d); k: (B, Sk, KV, d); v: (B, Sk, KV, dv); o: (B, Sq, H, dv);
// element strides of batch, sequence and head for each (the last dimension
// is contiguous); one dtype (float32 when is_bf16 == 0, else bfloat16).
// 1 <= d <= 256, Sk >= 1, H % KV == 0, B·H <= 65535.  kind selects the
// kernel (the constants above); dv == d but at d 192 on "tc", which also
// takes dv 128.  The three tensor-core kernels need strides that are
// multiples of 8 elements and 16-byte aligned pointers.  scale multiplies
// the float32 scores.  chunks, tpc and ws are the split over keys of the
// "tc" kernel (launch_wgmma); every other kind takes chunks == 1.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch (0 on success), or one of the codes above.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KV, int d, int dv, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, float scale, int causal, int is_bf16,
    int kind, int chunks, int tpc, void* ws, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || d < 1 || d > 256 || H < 1 || KV < 1 ||
      H % KV != 0 || (long long)B * H > 65535 || dv < 1 || dv > d)
    return (int)cudaErrorInvalidValue;
  if (kind != kKindTc && (dv != d || chunks != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const Geom g{B,   Sq,  Sk,  H,   KV,  d,   dv,  qsb, qss, qsh,
               ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (kind == kKindTc) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
#define TC_LAUNCH(D, DV)                                                   \
    if (d == D && dv == DV)                                                \
      return launch_wgmma<D, DV>(q, k, v, o, g, scale, causal, chunks, tpc, \
                                 w, s);
    TC_LAUNCH(64, 64)
    TC_LAUNCH(112, 112)
    TC_LAUNCH(128, 128)
    TC_LAUNCH(192, 192)
    TC_LAUNCH(192, 128)
#undef TC_LAUNCH
    return (int)cudaErrorInvalidValue;
  }
  if (kind == kKindTf32) {
    if (is_bf16) return (int)cudaErrorInvalidValue;
    if (d == 64) return launch_wgmma_tf32<64>(q, k, v, o, g, scale, causal, s);
    if (d == 128)
      return launch_wgmma_tf32<128>(q, k, v, o, g, scale, causal, s);
    return (int)cudaErrorInvalidValue;
  }
  if (kind == kKindMma) {
    if (d % 8) return (int)cudaErrorInvalidValue;
    if (is_bf16)
      return dispatch_mma<__nv_bfloat16>(q, k, v, o, g, scale, causal, s);
    return dispatch_mma<float>(q, k, v, o, g, scale, causal, s);
  }
  if (kind != kKindSimt) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch_simt<__nv_bfloat16>(q, k, v, o, g, scale, causal, s);
  return dispatch_simt<float>(q, k, v, o, g, scale, causal, s);
}
