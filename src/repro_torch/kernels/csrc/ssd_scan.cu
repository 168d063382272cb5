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
// an entry above the diagonal is set to 0 and never exponentiated, so a
// large positive cs_i - cs_j cannot make inf · 0 = NaN.
//
// What bounds it on the card: at the SSM prefill path's shape (chunks of
// Q 128, h 32, p 64, g 1, n 128) the function does three small products per
// chunk — C·Bᵀ once per group (Q·Q·n), M·x per head (Q·Q·p, causal half)
// and Bᵀ·x per head (Q·n·p) — about 105 M operations on 3.2 MB: some 33
// operations per byte, above the float32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so it is bound by operations.  This first kernel
// recomputes C·Bᵀ for every head of a group (32 times at g = 1) and runs
// on the CUDA cores from shared memory.  Computing G once per group and the
// tensor cores are later work (ROADMAP queue 2).
//
// Design.  One block per (head, chunk), 256 threads.  Warp 0 takes the
// cumulative sum of da with shuffles.  The block stages x (Q, p) and Bᵀ
// (n, Q) in dynamic shared memory (133 KB at the path's shape, above the
// 48 KB default, so the launcher raises the limit), then walks the chunk in
// tiles of 32 output rows: it stages that tile's Cᵀ, forms the masked
// M = (C·Bᵀ)∘L tile (each thread four rows of one column), and multiplies
// it into x (each thread eight rows of one column of y).  Finally each
// thread sums four state rows of one column over the chunk.  Transposed
// tiles are padded by one column so the transposing stores and the column
// reads do not collide on shared-memory banks; reads shared by a warp are
// broadcasts.
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// x: (b, q, h, p), da: (b, q, h), B and C: (b, q, g, n), y: (b, q, h, p),
// st: (b, h, n, p), cd: (b, h); all float32 and row-major; h % g == 0,
// h <= 65535 (grid x), b <= 65535 (grid y).  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ssd_intra_launch(const void* x, const void* da, const void* B,
                                const void* C, void* y, void* st, void* cd,
                                int b, int q, int h, int p, int g, int n,
                                void* stream) {
  if (b < 0 || q < 1 || h < 1 || p < 1 || g < 1 || n < 1 || h % g != 0 ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
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
  ssd_intra_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(
                                                stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(da),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(st),
      static_cast<float*>(cd), q, h, p, g, n);
  return (int)cudaGetLastError();
}
