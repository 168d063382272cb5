// Mamba2 SSD within one chunk, batched over chunks, in float32:
//   cs      = cumsum(da) over the chunk (per head)
//   y[i]    = sum_{j <= i} (C_i · B_j) · exp(cs_i - cs_j) · x_j
//   states  = sum_k B_k ⊗ exp(cs_end - cs_k) · x_k        (n, p) per head
//   decay   = exp(cs_end)
// with x already multiplied by dt, and B, C shared by the heads of a group
// (group = head // (h / g)).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_intra_pallas
// (body _ssd_kernel).  As there, the decay matrix is masked BEFORE the exp:
// an entry above the diagonal is set to 0 (its exponent to -inf) and never
// exponentiated from a finite difference, so a large positive cs_i - cs_j
// cannot make inf · 0 = NaN.
//
// What bounds it on the card: at the SSM prefill path's shape (16 chunks of
// Q 128, h 32, p 64, g 1, n 128) the function reads x, da, B, C and writes
// y, the states and the decay once: 52.7 MB, 15.7 µs at 3.35 TB/s.  It does
// 1.66 G operations (C·Bᵀ on and under the diagonal once per group, the
// masked decay and M·x per head, the decayed Bᵀ·x per head): 24.7 µs at the
// float32 CUDA-core rate (67 TFLOP/s), 10 µs at a third of the TF32
// tensor-core rate.  On the tensor cores it is bound by its bytes.
//
// Two kernels, chosen by the caller (kernels/ssd_scan.py: variant) by shape
// alone:
//
// ssd_intra_wgmma: Q 128, p and n multiples of 8 up to 64 and 128 (the
//   repo's SSM configs: mamba2 p 64 n 128, zamba2 p 64 n 64), any g.  On the
//   tensor cores in 3xTF32: TF32 keeps 10 mantissa bits, and one pass fails
//   the float32 tolerance (2e-4 of the output against float64) by 1.5-4.6x,
//   as does any single product left at one pass; so every operand v is
//   split into hi (v with its 13 low mantissa bits cleared) and lo = v - hi
//   (split_tf32), and each product is hi·hi + hi·lo + lo·hi into one float32
//   accumulator, three wgmma.m64nNk8.tf32 per k-step.  tf32 wgmma reads both
//   operands K-major only (the transpose bits are for 16-bit types), which
//   fixes the layout:
//     G   = C·Bᵀ        A = C, read from shared memory into registers and
//                       split there; B-operand = B (keys x n), K-major as
//                       stored, split into hi and lo tiles in shared memory
//                       (128 KB at n 128, resident for the whole block);
//     y_h = (G∘L_h)·x_h A = G's accumulator times L_h = exp(cs_i - cs_j)
//                       (masked before the exp), in registers; B-operand =
//                       x_hᵀ (p x keys), written transposed into hi and lo
//                       tiles by the threads (TMA cannot transpose float32,
//                       and the threads split the values anyway);
//     st_h = (Bᵀ∘w_h)·x_h  A = B read column-wise from its tiles (hi + lo),
//                       times w_h = exp(cs_end - cs_k), split again; the
//                       B-operand is the same x_hᵀ tile.
//   The accumulator gives a thread keys (2t, 2t + 1) of each group of 8
//   where tf32's A fragment wants K positions (t, t + 4); a sum over K does
//   not depend on its order, so x_hᵀ stores its keys in the accumulator's
//   order (key_at) and no value moves between threads.  All tiles use the
//   128-byte swizzle.  One block per (chunk, group, hb heads): G is formed
//   once and kept in registers while the block walks its heads (hb 4 at the
//   path's shape: 128 blocks, one wave; C·Bᵀ 8 times per chunk instead of
//   32).  256 threads, two warpgroups of 64 rows; by causality rows 0-63
//   see keys 0-63 only, so the first warpgroup's G and M·x have N = K = 64.
//   The states' n rows are split between the warpgroups.  TMA brings every
//   input tile ([128 rows][32 columns] boxes, 128-byte swizzle, columns
//   past n or p as zeros), one thread issuing: at the block's start B into
//   its hi tiles (the threads then split it in place into hi and lo), C
//   into the xᵀ tiles' space (free until the first head) and the first
//   head's x into a staging buffer; then each next head's x as soon as the
//   current one is in its tiles, so that it lands while the current head
//   computes.  The threads split and transpose x (TMA cannot transpose
//   float32).  Shared memory: B hi/lo 128 KB + x_hᵀ hi/lo 64 KB + the
//   staging 32 KB = 226 KB at n 128; B's tiles cover whole halves of 64
//   columns, so a warpgroup's 64 rows of the states read only B (zero past
//   n).  No wgmma is issued under a condition: ptxas serializes all of a
//   kernel's wgmmas if one is (C7520), so every batch is a whole tile of 32
//   columns of K.  Every shared-memory access goes through an offset from
//   one extern symbol (sm<T>), so the compiler emits LDS/STS and not
//   generic loads.
//
// ssd_intra_kernel: every other shape (ragged Q, p, n), on the CUDA cores
//   in float32.  One block per (head, chunk), 256 threads.  Warp 0 takes
//   the cumulative sum of da with shuffles.  The block stages x (Q, p) and
//   Bᵀ (n, Q) in dynamic shared memory (133 KB at Q 128, p 64, n 128, above
//   the 48 KB default, so the launcher raises the limit), then walks the
//   chunk in tiles of 32 output rows: it stages that tile's Cᵀ, forms the
//   masked M = (C·Bᵀ)∘L tile (each thread four rows of one column), and
//   multiplies it into x (each thread eight rows of one column of y).
//   Finally each thread sums four state rows of one column over the chunk.
//   Transposed tiles are padded by one column so the transposing stores and
//   the column reads do not collide on shared-memory banks; reads shared by
//   a warp are broadcasts.  It recomputes C·Bᵀ for every head of a group.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTI = 32;           // output rows per tile

// Floats of dynamic shared memory for a chunk of q rows.
__host__ __device__ inline size_t smem_floats(int q, int p, int n) {
  const int n4 = (n + 3) & ~3;
  return (size_t)2 * q + (size_t)q * p + (size_t)n4 * (q + 1) +
         (size_t)n4 * (kTI + 1) + (size_t)q * (kTI + 1);
}

__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ da,
                 const float* __restrict__ B, const float* __restrict__ C,
                 float* __restrict__ y, float* __restrict__ st,
                 float* __restrict__ cd, int Q, int h, int p, int g, int n) {
  extern __shared__ __align__(16) float sm[];
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = hh / (h / g);
  const int n4 = (n + 3) & ~3;
  const int QP = Q + 1;           // padded row of Bᵀ
  const int TP = kTI + 1;         // padded row of Cᵀ and of the M tile
  float* cs = sm;                 // (Q)   cumulative sum of da
  float* wk = cs + Q;             // (Q)   exp(cs_end - cs_k)
  float* xs = wk + Q;             // (Q, p)
  float* Bt = xs + (size_t)Q * p; // (n4, QP)
  float* Ct = Bt + (size_t)n4 * QP;  // (n4, TP): this tile's C, transposed
  float* Mt = Ct + (size_t)n4 * TP;  // (Q, TP):  M tile, key-major
  const int tid = threadIdx.x;

  if (tid < 32) {                 // inclusive scan of da, 32 rows at a time
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int qq = base + tid;
      float val = qq < Q ? da[((size_t)b * Q + qq) * h + hh] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, val, off);
        if (tid >= off) val += t;
      }
      val += carry;
      if (qq < Q) cs[qq] = val;
      carry = __shfl_sync(0xffffffffu, val, 31);
    }
  }
  for (int i = tid; i < Q * p; i += kThreads) {
    const int qq = i / p;
    const int c = i - qq * p;
    xs[i] = x[(((size_t)b * Q + qq) * h + hh) * p + c];
  }
  for (int i = tid; i < Q * n4; i += kThreads) {
    const int qq = i / n4;
    const int nn = i - qq * n4;
    Bt[(size_t)nn * QP + qq] =
        nn < n ? B[(((size_t)b * Q + qq) * g + grp) * n + nn] : 0.f;
  }
  __syncthreads();
  const float cs_end = cs[Q - 1];
  for (int i = tid; i < Q; i += kThreads) wk[i] = expf(cs_end - cs[i]);

  for (int i0 = 0; i0 < Q; i0 += kTI) {
    const int ti = min(kTI, Q - i0);
    const int jmax = i0 + ti;     // keys a row of this tile can see
    for (int i = tid; i < kTI * n4; i += kThreads) {
      const int r = i / n4;
      const int nn = i - r * n4;
      Ct[(size_t)nn * TP + r] =
          (r < ti && nn < n) ? C[(((size_t)b * Q + i0 + r) * g + grp) * n + nn]
                             : 0.f;
    }
    __syncthreads();

    // M tile: Mt[j][r] = (C_i · B_j) · exp(cs_i - cs_j) for j <= i, else 0
    for (int w = tid; w < (kTI / 4) * jmax; w += kThreads) {
      const int j = w % jmax;
      const int r0 = (w / jmax) * 4;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (j <= i0 + r0 + 3) {     // some row of the four sees key j
        for (int nn = 0; nn < n; ++nn) {
          const float bj = Bt[(size_t)nn * QP + j];
          const float* cr = Ct + (size_t)nn * TP + r0;
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = fmaf(cr[e], bj, a[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + e;
        const int i = i0 + r;
        Mt[(size_t)j * TP + r] =
            (r < ti && j <= i) ? a[e] * expf(cs[i] - cs[j]) : 0.f;
      }
    }
    __syncthreads();

    // y tile = M tile · x
    for (int w = tid; w < (kTI / 8) * p; w += kThreads) {
      const int c = w % p;
      const int r0 = (w / p) * 8;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      const int jend = min(jmax, i0 + r0 + 8);
      for (int j = 0; j < jend; ++j) {
        const float xv = xs[(size_t)j * p + c];
        const float* mr = Mt + (size_t)j * TP + r0;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(mr[e], xv, acc[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = r0 + e;
        if (r < ti) y[(((size_t)b * Q + i0 + r) * h + hh) * p + c] = acc[e];
      }
    }
    __syncthreads();              // Ct and Mt are rewritten by the next tile
  }

  // end-of-chunk states: st[nn][c] = sum_k B[k][nn] · wk[k] · x[k][c]
  for (int w = tid; w < (n4 / 4) * p; w += kThreads) {
    const int c = w % p;
    const int n0 = (w / p) * 4;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < Q; ++kk) {
      const float xv = xs[(size_t)kk * p + c] * wk[kk];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = fmaf(Bt[(size_t)(n0 + e) * QP + kk], xv, a[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nn = n0 + e;
      if (nn < n) st[(((size_t)b * h + hh) * n + nn) * p + c] = a[e];
    }
  }
  if (tid == 0) cd[(size_t)b * h + hh] = expf(cs_end);
}

// ---------------------------------------------------------------------------
// Tensor-core variant (ssd_intra_wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcQ = 128;          // chunk rows: the only Q it takes
constexpr int kTcThreads = 256;    // two warpgroups
constexpr int kKB = 4;             // k-steps of 8 per batch of wgmmas
constexpr int kBTile = kTcQ * 128;  // bytes of a [128 keys][32] tile of B
constexpr int kXTile = 64 * 128;    // bytes of a [64 cols][32] tile of xᵀ
constexpr int kStage = 2 * kTcQ * 128;  // x of one head as TMA lands it

// Tiles of 32 columns that B's hi and lo halves each take at state width
// n: whole halves of 64 columns, zero past n, so that a warpgroup's 64
// rows of the states product read only B.
__host__ __device__ inline int b_tiles(int n) { return n <= 64 ? 2 : 4; }

// Bytes of dynamic shared memory at state width n, 1024 for alignment
// included: B's hi and lo halves, xᵀ's hi and lo halves (4 tiles each),
// the staging buffer of the next head's x, the cumulative sum, the
// end-of-chunk weights and three mbarriers.
__host__ __device__ inline int tc_smem_bytes(int n) {
  return 2 * b_tiles(n) * kBTile + 2 * 4 * kXTile + kStage + 2 * kTcQ * 4 +
         32 + 1024;
}

// 2^x in one instruction (MUFU.EX2; results below 2^-126 flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// Barrier of the block's 256 threads.  Named and counted, so the two
// warpgroups may reach it from their own code paths.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The tensor-core kernel's dynamic shared memory, addressed by byte offsets
// from this symbol and never through pointers kept in a struct: so the
// compiler knows every access is to shared memory (LDS and STS with 32-bit
// addresses, not generic loads with 64-bit ones that take registers).
extern __shared__ __align__(16) uint8_t tc_smem[];

template <typename T>
__device__ __forceinline__ T& sm(uint32_t off) {
  return *reinterpret_cast<T*>(tc_smem + off);
}

// What the block shares: its chunk, group and heads, and the offsets of its
// shared-memory regions.
struct TcBlock {
  const CUtensorMap* xmap;
  const float* da;
  float* y;
  float* st;
  float* cd;
  int h, p, g, n;
  int c, grp, h0, nh;      // chunk, group, first head, heads of the block
  uint32_t b_hi, b_lo, x_hi, x_lo;   // shared addresses of the tiles
  // offsets in tc_smem: B's and xᵀ's hi and lo tiles; the staging buffer
  // of the next head's x (as TMA lands it) and its mbarrier (one phase a
  // head); cs = cumsum(da) and wk = exp(cs_end - cs_k) of this head (128);
  // the mbarriers of B's and C's loads
  uint32_t o_bhi, o_blo, o_xhi, o_xlo, o_stage, o_bar, o_cs, o_wk;
  uint32_t o_bbar, o_cbar;
};

// One thread: ask TMA for x of head hh, (128 keys) x (64 columns) in two
// boxes of 32 columns with the 128-byte swizzle; columns past p land as
// zeros.
__device__ __forceinline__ void issue_x(const TcBlock& k, int hh) {
  uint64_t* bar = &sm<uint64_t>(k.o_bar);
  mbar_expect_tx(bar, kStage);
  tma_load(&sm<uint8_t>(k.o_stage), k.xmap, bar, 0, hh, 0, k.c);
  tma_load(&sm<uint8_t>(k.o_stage + kStage / 2), k.xmap, bar, 32, hh, 0,
           k.c);
}

// Once the staged x of the i-th head has landed, write this thread's share
// into xᵀ's hi and lo tiles: the key at K position kpos = tid % 128,
// columns 8 cg .. 8 cg + 7 for cg = tid / 128 + 2 m, m < 4; row of the
// tile = column of x.  A warp writes 32 consecutive K positions of one row
// (32 banks) and reads 32 keys' 16-byte chunks, spread by the swizzle.
__device__ __forceinline__ void store_x(const TcBlock& k, int i) {
  const int tid = threadIdx.x;
  const int kpos = tid & 127;
  const int key = key_at(kpos);
  const uint32_t tile = (kpos >> 5) * kXTile;
  mbar_wait(&sm<uint64_t>(k.o_bar), i & 1);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c0 = 8 * ((tid >> 7) + 2 * m);
    const uint32_t row = k.o_stage + (c0 >> 5) * (kStage / 2) + key * 128;
    const int ch = (c0 & 31) >> 2;
    const float4 a = sm<float4>(row + (((ch ^ key) & 7) << 4));
    const float4 b = sm<float4>(row + ((((ch + 1) ^ key) & 7) << 4));
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      uint32_t hi, lo;
      split_tf32(v[e], hi, lo);
      const uint32_t off = tile + sw_off(c0 + e, kpos & 31);
      sm<uint32_t>(k.o_xhi + off) = hi;
      sm<uint32_t>(k.o_xlo + off) = lo;
    }
  }
}

// Warp 0: da of head hh over the chunk, four keys a lane (loaded a head
// ahead, so that its latency hides behind the head before).
__device__ __forceinline__ void load_da(const TcBlock& k, int hh,
                                        float (&d)[4]) {
  const int lane = threadIdx.x & 31;
  const float* src = k.da + (size_t)k.c * kTcQ * k.h + hh;
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = src[(size_t)(4 * lane + e) * k.h];
}

// Warp 0: cs = cumsum(da) of head hh over the chunk, wk = exp(cs_end -
// cs), and the chunk decay exp(cs_end).
__device__ __forceinline__ void chunk_cumsum(const TcBlock& k, int hh,
                                             const float (&d)[4]) {
  const int lane = threadIdx.x & 31;
  float v[4];
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s += d[e];
    v[e] = s;
  }
  float incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] += excl;
  const float cs_end = __shfl_sync(0xffffffffu, v[3], 31);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sm<float>(k.o_cs + 4 * (4 * lane + e)) = v[e];
    sm<float>(k.o_wk + 4 * (4 * lane + e)) = expf(cs_end - v[e]);
  }
  if (lane == 0) k.cd[(size_t)k.c * k.h + hh] = expf(cs_end);
}

// One warpgroup's work.  KW is the number of keys its 64 rows can see: 64
// for rows 0-63, 128 for rows 64-127 (causality).  G = C·Bᵀ for its rows
// stays in registers (the accumulator) while the block walks its heads;
// per head, y = (G∘L)·x over its rows, and the states of its 64 of the n
// rows of Bᵀ: (Bᵀ∘w)·x.
template <int KW>
__device__ __forceinline__ void tc_warpgroup(const TcBlock& k) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t = lane & 3;
  // accumulator and A-fragment rows of this thread: r0 and r0 + 8
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int r1 = r0 + 8;
  uint32_t ah[4 * kKB], al[4 * kKB];

  // G = C·Bᵀ: A = C as TMA landed it in the xᵀ tiles' space ([128 rows]
  // [32 columns] tiles, zero past n), read at rows r0, r1 and K positions
  // t, t + 4 of each k-step and split in registers; B-operand the B tiles.
  // Whole tiles of 32 columns, four k-steps each.
  float gacc[KW / 2];
#pragma unroll
  for (int i = 0; i < KW / 2; ++i) gacc[i] = 0.f;
  mbar_wait(&sm<uint64_t>(k.o_cbar), 0);
  const int nt = (k.n + 31) >> 5;
  for (int kt = 0; kt < nt; ++kt) {
    const uint32_t tile = k.o_xhi + kt * kBTile;
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
      const int col = 8 * j + t;
      split_tf32(sm<float>(tile + sw_off(r0, col)), ah[4 * j], al[4 * j]);
      split_tf32(sm<float>(tile + sw_off(r1, col)), ah[4 * j + 1],
                 al[4 * j + 1]);
      split_tf32(sm<float>(tile + sw_off(r0, col + 4)), ah[4 * j + 2],
                 al[4 * j + 2]);
      split_tf32(sm<float>(tile + sw_off(r1, col + 4)), ah[4 * j + 3],
                 al[4 * j + 3]);
    }
    mma_batch<KW, kKB>(gacc, ah, al, k.b_hi, k.b_lo, kBTile, kt);
  }
  block_sync();              // C's space becomes the xᵀ tiles

  float dn[4];                       // warp 0: da of the next head
  if (tid < 32) load_da(k, k.h0, dn);
  for (int i = 0; i < k.nh; ++i) {
    const int hh = k.h0 + i;
    store_x(k, i);
    if (tid < 32) chunk_cumsum(k, hh, dn);
    fence_proxy_async();
    block_sync();
    // the stage is free: the next head's x lands while this one computes
    if (tid == 0 && i + 1 < k.nh) issue_x(k, hh + 1);
    if (tid < 32 && i + 1 < k.nh) load_da(k, hh + 1, dn);

    // y = (G∘L)·x: A from G's accumulator, which holds keys 8 kk + 2t and
    // + 1 for rows r0 (gacc[4 kk], [4 kk + 1]) and r1 ([4 kk + 2],
    // [4 kk + 3]); L = exp(cs_i - cs_j) = 2^((cs_i - cs_j) log2 e),
    // masked to -inf before the exp.
    {
      const float cs0 = sm<float>(k.o_cs + 4 * r0);
      const float cs1 = sm<float>(k.o_cs + 4 * r1);
      float yacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) yacc[e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < KW / 8; kb += kKB) {
#pragma unroll
        for (int j = 0; j < kKB; ++j) {
          const int kk = kb + j;
          const int j0 = 8 * kk + 2 * t;
          const float2 cj = sm<float2>(k.o_cs + 4 * j0);
          const float ninf = __int_as_float(0xff800000);
          const float l2e = 1.4426950408889634f;
          const float m00 =
              gacc[4 * kk] * ex2((j0 <= r0 ? cs0 - cj.x : ninf) * l2e);
          const float m01 =
              gacc[4 * kk + 1] * ex2((j0 + 1 <= r0 ? cs0 - cj.y : ninf) * l2e);
          const float m10 =
              gacc[4 * kk + 2] * ex2((j0 <= r1 ? cs1 - cj.x : ninf) * l2e);
          const float m11 =
              gacc[4 * kk + 3] * ex2((j0 + 1 <= r1 ? cs1 - cj.y : ninf) * l2e);
          split_tf32(m00, ah[4 * j], al[4 * j]);          // (r0, t)
          split_tf32(m10, ah[4 * j + 1], al[4 * j + 1]);  // (r1, t)
          split_tf32(m01, ah[4 * j + 2], al[4 * j + 2]);  // (r0, t + 4)
          split_tf32(m11, ah[4 * j + 3], al[4 * j + 3]);  // (r1, t + 4)
        }
        mma_batch<64, kKB>(yacc, ah, al, k.x_hi, k.x_lo, kXTile, kb / kKB);
      }
      float* y0 = k.y + (((size_t)k.c * kTcQ + r0) * k.h + hh) * k.p;
      float* y1 = k.y + (((size_t)k.c * kTcQ + r1) * k.h + hh) * k.p;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int col = 8 * ii + 2 * t;
        if (col < k.p) {
          *reinterpret_cast<float2*>(y0 + col) =
              make_float2(yacc[4 * ii], yacc[4 * ii + 1]);
          *reinterpret_cast<float2*>(y1 + col) =
              make_float2(yacc[4 * ii + 2], yacc[4 * ii + 3]);
        }
      }
    }
    // states (n, p) = (Bᵀ∘w)·x: rows nn of Bᵀ, this warpgroup's 64 of them;
    // A read column-wise from the B tile (hi + lo), scaled by w and split
    // again, at the K positions of the xᵀ tile (keys 2t and 2t + 1).
    if (64 * wg < k.n) {
      const int nn0 = r0;                    // 64 wg + 16 warp + lane / 4
      const int nn1 = r1;
      // B[key][nn] for this thread's rows nn0, nn1 and keys 8 kk + 2t and
      // + 1: key % 8 is 2t or 2t + 1 at every kk, so the swizzled offsets
      // are four bases plus 1024 kk (rows past n read B's zero padding)
      const auto base = [&](int nn, int odd) -> uint32_t {
        return k.o_bhi + (nn >> 5) * kBTile + 128 * (2 * t + odd) +
               (((((nn & 31) >> 2) ^ (2 * t + odd)) & 7) << 4) +
               ((nn & 3) << 2);
      };
      const uint32_t b00 = base(nn0, 0), b01 = base(nn0, 1);
      const uint32_t b10 = base(nn1, 0), b11 = base(nn1, 1);
      const uint32_t lo = k.o_blo - k.o_bhi;
      const auto bval = [&](uint32_t off) {
        return sm<float>(off) + sm<float>(off + lo);
      };
      float sacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < kTcQ / 8; kb += kKB) {
#pragma unroll
        for (int j = 0; j < kKB; ++j) {
          const int kk = kb + j;
          const float2 w = sm<float2>(k.o_wk + 4 * (8 * kk + 2 * t));
          split_tf32(bval(b00 + 1024 * kk) * w.x, ah[4 * j], al[4 * j]);
          split_tf32(bval(b10 + 1024 * kk) * w.x, ah[4 * j + 1],
                     al[4 * j + 1]);
          split_tf32(bval(b01 + 1024 * kk) * w.y, ah[4 * j + 2],
                     al[4 * j + 2]);
          split_tf32(bval(b11 + 1024 * kk) * w.y, ah[4 * j + 3],
                     al[4 * j + 3]);
        }
        mma_batch<64, kKB>(sacc, ah, al, k.x_hi, k.x_lo, kXTile, kb / kKB);
      }
      float* s0 = k.st + (((size_t)k.c * k.h + hh) * k.n + nn0) * k.p;
      float* s1 = k.st + (((size_t)k.c * k.h + hh) * k.n + nn1) * k.p;
      const bool in0 = nn0 < k.n, in1 = nn1 < k.n;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int col = 8 * ii + 2 * t;
        if (col < k.p) {
          if (in0)
            *reinterpret_cast<float2*>(s0 + col) =
                make_float2(sacc[4 * ii], sacc[4 * ii + 1]);
          if (in1)
            *reinterpret_cast<float2*>(s1 + col) =
                make_float2(sacc[4 * ii + 2], sacc[4 * ii + 3]);
        }
      }
    }
    block_sync();              // xᵀ, cs and wk are rewritten for the next head
  }
}

// One block per (chunk, group, block of hb heads of the group).
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_intra_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap,
                const float* __restrict__ da,
                float* __restrict__ y, float* __restrict__ st,
                float* __restrict__ cd, int h, int p, int g, int n, int hb) {
  const int nt = b_tiles(n);
  const int hg = h / g;
  const int nhb = (hg + hb - 1) / hb;
  const int hbi = blockIdx.x % nhb;
  TcBlock k;
  k.xmap = &xmap;
  k.da = da; k.y = y; k.st = st; k.cd = cd;
  k.h = h; k.p = p; k.g = g; k.n = n;
  k.grp = (blockIdx.x / nhb) % g;
  k.c = blockIdx.x / (nhb * g);
  k.h0 = k.grp * hg + hbi * hb;
  k.nh = min(hb, hg - hbi * hb);
  // regions from a 1024-byte aligned start (the swizzle's period)
  const uint32_t base = smem_u32(tc_smem);
  k.o_bhi = (1024 - (base & 1023)) & 1023;
  k.o_blo = k.o_bhi + nt * kBTile;
  k.o_xhi = k.o_blo + nt * kBTile;
  k.o_xlo = k.o_xhi + 4 * kXTile;
  k.o_stage = k.o_xlo + 4 * kXTile;
  k.o_cs = k.o_stage + kStage;
  k.o_wk = k.o_cs + 4 * kTcQ;
  k.o_bar = k.o_wk + 4 * kTcQ;
  k.o_bbar = k.o_bar + 8;
  k.o_cbar = k.o_bar + 16;
  k.b_hi = base + k.o_bhi;
  k.b_lo = base + k.o_blo;
  k.x_hi = base + k.o_xhi;
  k.x_lo = base + k.o_xlo;

  // One thread asks TMA for B (into B's hi tiles), C (into the xᵀ tiles'
  // space, free until the first head) and the first head's x (into the
  // staging buffer): [128 rows][32 columns] boxes, 128-byte swizzle,
  // columns past n or p as zeros.
  const int ntc = (n + 31) >> 5;
  if (threadIdx.x == 0) {
    mbar_init(&sm<uint64_t>(k.o_bar), 1);
    mbar_init(&sm<uint64_t>(k.o_bbar), 1);
    mbar_init(&sm<uint64_t>(k.o_cbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  block_sync();              // no thread waits on a barrier before its init
  if (threadIdx.x == 0) {
    uint64_t* bbar = &sm<uint64_t>(k.o_bbar);
    uint64_t* cbar = &sm<uint64_t>(k.o_cbar);
    mbar_expect_tx(bbar, nt * kBTile);
    for (int kt = 0; kt < nt; ++kt)
      tma_load(&sm<uint8_t>(k.o_bhi + kt * kBTile), &bmap, bbar, 32 * kt,
               k.grp, 0, k.c);
    mbar_expect_tx(cbar, ntc * kBTile);
    for (int kt = 0; kt < ntc; ++kt)
      tma_load(&sm<uint8_t>(k.o_xhi + kt * kBTile), &cmap, cbar, 32 * kt,
               k.grp, 0, k.c);
    issue_x(k, k.h0);
  }
  // B split in place: each thread takes 16-byte chunks of the hi tiles,
  // keeps hi there and writes lo at the same place of the lo tiles (the
  // swizzle moves whole chunks, so a chunk's layout is the same in both)
  mbar_wait(&sm<uint64_t>(k.o_bbar), 0);
  for (int u = threadIdx.x; u < nt * kBTile / 16; u += kTcThreads) {
    uint4& raw = sm<uint4>(k.o_bhi + 16 * u);
    const uint4 v = raw;
    uint4 hi, lo;
    split_tf32(__uint_as_float(v.x), hi.x, lo.x);
    split_tf32(__uint_as_float(v.y), hi.y, lo.y);
    split_tf32(__uint_as_float(v.z), hi.z, lo.z);
    split_tf32(__uint_as_float(v.w), hi.w, lo.w);
    raw = hi;
    sm<uint4>(k.o_blo + 16 * u) = lo;
  }
  fence_proxy_async();
  block_sync();

  if (threadIdx.x < 128) {
    tc_warpgroup<64>(k);
  } else {
    tc_warpgroup<128>(k);
  }
}

// Heads a block takes: the largest power of two (at most the group's
// heads) that still leaves 7/8 of the card's SMs a block, else 1.  Each
// block computes C·Bᵀ once for all its heads.
int heads_per_block(int b, int g, int hg, int sms) {
  int hb = 1;
  while (2 * hb <= hg &&
         (long long)b * g * ((hg + 2 * hb - 1) / (2 * hb)) >= sms - sms / 8)
    hb *= 2;
  return hb;
}

int launch_tc(const void* x, const void* da, const void* B, const void* C,
              void* y, void* st, void* cd, int b, int h, int p, int g, int n,
              cudaStream_t stream) {
  static int setup = -1;     // once per process (one device)
  static int sms = 0;
  if (setup < 0) {
    int dev = 0;
    setup = (int)cudaGetDevice(&dev);
    if (!setup)
      setup = (int)cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev);
    if (!setup)
      setup = (int)cudaFuncSetAttribute(
          ssd_intra_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
          tc_smem_bytes(128));
  }
  if (setup) return setup;
  const int hg = h / g;
  const int hb = heads_per_block(b, g, hg, sms);
  const long long blocks = (long long)b * g * ((hg + hb - 1) / hb);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  // x (b, 128, h, p) and B, C (b, 128, g, n) as 4-D maps (columns, heads
  // or groups, 128 rows, chunks); boxes of [128 rows][32 columns]
  EncodeTiled enc = encoder();
  if (!enc) return kErrNoEncoder;
  CUtensorMap maps[3];
  const void* bases[3] = {x, B, C};
  const int cols[3] = {p, n, n}, heads[3] = {h, g, g};
  for (int m = 0; m < 3; ++m) {
    const cuuint64_t dims[4] = {(cuuint64_t)cols[m], (cuuint64_t)heads[m],
                                (cuuint64_t)kTcQ, (cuuint64_t)b};
    const cuuint64_t strides[3] = {
        (cuuint64_t)cols[m] * 4, (cuuint64_t)heads[m] * cols[m] * 4,
        (cuuint64_t)kTcQ * heads[m] * cols[m] * 4};
    const cuuint32_t box[4] = {32, 1, (cuuint32_t)kTcQ, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (enc(&maps[m], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<void*>(bases[m]), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrEncode;
  }
  ssd_intra_wgmma<<<(unsigned)blocks, kTcThreads, tc_smem_bytes(n),
                    stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(da),
      static_cast<float*>(y), static_cast<float*>(st),
      static_cast<float*>(cd), h, p, g, n, hb);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, q, h, p), da: (b, q, h), B and C: (b, q, g, n), y: (b, q, h, p),
// st: (b, h, n, p), cd: (b, h); all float32 and row-major; h % g == 0.
// tensor_cores selects ssd_intra_wgmma, which takes q 128, p and n
// multiples of 8 with p <= 64 and n <= 128, and x, B and C 16-byte aligned;
// otherwise ssd_intra_kernel (h <= 65535, b <= 65535: its grid).  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int ssd_intra_launch(const void* x, const void* da, const void* B,
                                const void* C, void* y, void* st, void* cd,
                                int b, int q, int h, int p, int g, int n,
                                int tensor_cores, void* stream) {
  if (b < 0 || q < 1 || h < 1 || p < 1 || g < 1 || n < 1 || h % g != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (q != kTcQ || p % 8 || p > 64 || n % 8 || n > 128 ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(B) % 16 ||
        reinterpret_cast<uintptr_t>(C) % 16)
      return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    return launch_tc(x, da, B, C, y, st, cd, b, h, p, g, n, s);
  }
  if (b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const size_t bytes = smem_floats(q, p, n) * sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)h, (unsigned)b);
  ssd_intra_kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(da),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(st),
      static_cast<float*>(cd), q, h, p, g, n);
  return (int)cudaGetLastError();
}
