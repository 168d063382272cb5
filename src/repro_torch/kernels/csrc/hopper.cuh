// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// this directory: shared-memory addresses, mbarriers, TMA tile loads, the
// wgmma shared-memory descriptor with the 128-byte swizzle, wgmma's fence /
// commit / wait, the register fence that keeps the compiler from touching
// an in-flight wgmma's registers, the proxy fence that makes the threads'
// own shared-memory stores visible to wgmma, the 3xTF32 pieces (the hi/lo
// split, the tf32 wgmma wrappers and their three-product batch, the
// swizzled offset and the key order of a transposed operand), and the
// warp-level pieces (mma.sync in bfloat16 and tf32, ldmatrix, cp.async).
// Each .cu that includes it builds into its own library, so everything here
// is internal to that library (an unnamed namespace).  On the host side:
// the SM count, and the tensor-map encoder, looked up once in libcuda with
// dlsym, so a library links against nothing new.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// One TMA copy of a box of the 4-D tensor map into shared memory; the
// barrier counts its bytes.  Coordinates are (column, head, row, batch).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warp are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma: every register is "changed" here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Shared-memory stores by the threads (the generic proxy) become visible
// to wgmma and TMA (the async proxy) after this fence and a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32 on wgmma: float32-accurate products on the tensor cores
// ---------------------------------------------------------------------------

// Byte offset of element (row, k), 0 <= k < 32, in a tile of 128-byte rows
// under the 128-byte swizzle (16-byte chunk k/4 XOR row % 8), from a
// 1024-byte aligned tile: the layout wgmma reads a K-major operand in.
__device__ __forceinline__ uint32_t sw_off(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + ((k & 3) << 2);
}

// v = hi + lo for 3xTF32: hi is v with the 13 low mantissa bits cleared
// (a tf32 value), lo = v - hi, exact in float32, of which the tensor cores
// read the top 10 mantissa bits.  hi·hi + hi·lo + lo·hi then misses v's
// product by about 2^-20 of it (lo·lo and lo's dropped bits), far inside
// the float32 tolerance.  Two instructions: this split is the kernel's
// most frequent operation, and sm_90 emulates cvt.rna.tf32.f32 in several.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// D (64 x 64, float32) += A (64 x 8, tf32 in registers) * B (8 x 64,
// tf32 in shared memory, K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 128, float32) += A (64 x 8, tf32 in registers) * B (8 x 128,
// tf32 in shared memory, K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t* a, uint64_t db) {
  if constexpr (N == 128) {
    wgmma_tf32_n128(d, a, db);
  } else {
    wgmma_tf32_n64(d, a, db);
  }
}

// One batch of KB k-steps of 8 (KB / 4 tiles of 32 columns of K), issued
// as one wgmma group and waited for: for k-step j the three products
// hi·hi, hi·lo, lo·hi of A (registers ah/al[4 j .. 4 j + 3]) with the
// operand at byte offset (kt + j / 4) * tile + (j % 4) * 32 of `hi` and
// `lo` (tiles of 32 columns, `tile` bytes apart).  No wgmma is issued under
// a condition: ptxas serializes every wgmma of a kernel that has one
// (C7520).
template <int N, int KB>
__device__ __forceinline__ void mma_batch(float (&d)[N / 2],
                                          uint32_t (&ah)[4 * KB],
                                          uint32_t (&al)[4 * KB],
                                          uint32_t hi, uint32_t lo,
                                          int tile, int kt) {
  fence_regs(d);
  fence_regs(ah);
  fence_regs(al);
  wg_fence();
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const uint32_t off = (kt + (j >> 2)) * tile + (j & 3) * 32;
    const uint64_t dh = sw128_desc(hi + off, 16, 1024);
    const uint64_t dl = sw128_desc(lo + off, 16, 1024);
    wgmma_tf32<N>(d, ah + 4 * j, dh);
    wgmma_tf32<N>(d, ah + 4 * j, dl);
    wgmma_tf32<N>(d, al + 4 * j, dh);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(d);
  fence_regs(ah);
  fence_regs(al);
}

// The key that K position kpos of a transposed B-operand tile holds (xᵀ in
// SSD, Vᵀ in flash attention).  Within each group of eight, positions 0-3
// hold the even keys and 4-7 the odd ones: an accumulator (C·Bᵀ, Q·Kᵀ)
// gives a thread the key pair (2t, 2t + 1) of each group where tf32's A
// fragment wants K positions (t, t + 4), and a sum over K does not depend
// on its order, so the tile takes the accumulator's order and no value
// moves between threads.
__device__ __forceinline__ int key_at(int kpos) {
  const int e = kpos & 7;
  return (kpos & ~7) | (e < 4 ? 2 * e : 2 * (e - 4) + 1);
}

// ---------------------------------------------------------------------------
// Warp-level tensor cores (mma.sync), ldmatrix and cp.async: for kernels
// whose tiles are too small or too odd in width for wgmma's 64 rows
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0..16) are filled with zeros, so a row past the tensor's end
// costs no read.  dst and src are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit values from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned) and
// receives, in r[i], elements (l / 4, 2 (l % 4) .. + 1) of matrix i; with
// .trans, elements (2 (l % 4) .. + 1, l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D (16 x 8, float32) += A (16 x 16, bfloat16) * B (16 x 8, bfloat16).
// With g = lane / 4 and t = lane % 4: a = {(g, 2t), (g + 8, 2t),
// (g, 2t + 8), (g + 8, 2t + 8)} as bfloat16 pairs along k; b = {(2t, g),
// (2t + 8, g)} as pairs along k; d = {(g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16 x 8, float32) += A (16 x 8, tf32) * B (8 x 8, tf32): a = {(g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)}, b = {(t, g), (t + 4, g)}, d as
// in mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The float32 product of 3xTF32 on mma_tf32: the two small terms first,
// then hi·hi, into one accumulator.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t* ah,
                                           const uint32_t* al, uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Return codes of the launchers past the CUDA runtime's own
constexpr int kErrNoEncoder = 10001;   // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10002;      // libcuda refused a tensor map

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Streaming multiprocessors of the current device, asked once per process
// (one device); 0 if the runtime refuses.
int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

}  // namespace
