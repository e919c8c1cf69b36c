// PTX wrappers for Hopper (sm_90a) used by the kernels in this directory:
// cp.async with zero fill, the async-proxy fence, warpgroup matrix multiply
// (wgmma) with its shared-memory matrix descriptors, and the swizzled tile
// layout the flash kernels keep their operands in.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; when !pred the 16 bytes are zero-filled and
// nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
// 4-byte global -> shared copy (an f32 row statistic), zero-filled when !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy, through which wgmma reads its shared-memory operands.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// waits until at most N committed groups are pending (groups retire in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each) and the swizzle mode
// (1: 128-byte, 2: 64-byte, 3: 32-byte; base offset 0, so every swizzle
// atom must be aligned to its own size).
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint64_t swizzle) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (swizzle << 62);
}

// d (64 x N f32, the warpgroup's accumulator fragments) = a * b (+ d when
// scale_d): m64nNk16, bf16 operands. _ss: a and b from shared memory, both
// K-major. _rs_tb: a from registers (the m16n8k16 A fragment of each warp's
// 16 rows), b from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_m64n32_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N) += a (registers) * b (shared memory, MN-major); N 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb_n(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "N");
  if constexpr (N == 128) wgmma_rs_m64n128_tb(d, a, db);
  else if constexpr (N == 64) wgmma_rs_m64n64_tb(d, a, db);
  else wgmma_rs_m64n32_tb(d, a, db);
}

// A (ROWS, D) bf16 tile as the wgmma descriptors read it. D >= 64: 128-byte
// swizzle, the row split into 64-column blocks of ROWS rows x 128 bytes;
// D = 32: 64-byte swizzle on 64-byte rows. The tile base is 1024-byte
// aligned and ROWS a multiple of 8, so every swizzle atom (8 rows) is
// aligned to its size.
template <int D, int ROWS>
struct SwTile {
  static_assert(ROWS % 8 == 0 && (D == 32 || D == 64 || D == 128), "tile shape");
  static constexpr int kCols = D >= 64 ? 64 : 32;           // elements per stored row
  static constexpr int kRowBytes = kCols * 2;
  static constexpr uint64_t kSwizzle = D >= 64 ? 1 : 2;     // 128-byte : 64-byte
  static constexpr int kElems = ROWS * D;
  __device__ static __forceinline__ int off(int row, int chunk) {   // 16-byte chunk, in elements
    if constexpr (D >= 64)
      return (chunk >> 3) * (ROWS * 64) + row * 64 + (((chunk & 7) ^ (row & 7)) << 3);
    else
      return row * 32 + ((chunk ^ ((row >> 1) & 3)) << 3);
  }
  // K-major operand (the head dim is the product's depth): columns 16 ks ..
  // 16 ks + 15. Leading offset unused; stride offset: the next 8 rows.
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int ks) {
    return smem_desc(base + (ks * 16 / kCols) * (ROWS * kRowBytes) + (ks * 16 % kCols) * 2,
                     16, 8 * kRowBytes, kSwizzle);
  }
  // MN-major operand (the rows are the product's depth): rows 16 kk .. 16 kk
  // + 15. Leading offset: the next 64-column block; stride offset: the next
  // 8 rows.
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return smem_desc(base + kk * 16 * kRowBytes, ROWS * kRowBytes, 8 * kRowBytes, kSwizzle);
  }
};

// cp.async of ROWS rows of DR bf16 into a SwTile<D, ROWS> (D >= DR) by
// THREADS threads: global rows row0 + r (row stride `ss` elements from
// `src`); rows at or past `limit`, and the columns DR .. D - 1 of every row,
// are zero-filled. Each thread walks one 16-byte column with a running
// pointer, so the unrolled loop keeps one address live, not one per row.
template <int D, int DR, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t ss, int row0, int limit, int tid) {
  constexpr int CH = D / 8, RS = THREADS / CH;
  static_assert(ROWS % RS == 0, "whole rows per pass");
  const int c = tid % CH, r0 = tid / CH;
  const bool col_ok = c < DR / 8;
  const __nv_bfloat16* p = src + (int64_t)(row0 + r0) * ss + (col_ok ? c * 8 : 0);
#pragma unroll
  for (int i = 0; i < ROWS / RS; ++i) {
    const int r = r0 + i * RS;
    const bool ok = col_ok && row0 + r < limit;
    cp_async16(smem_u32(dst + SwTile<D, ROWS>::off(r, c)), ok ? p : src, ok);
    p += RS * ss;
  }
}

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

}  // namespace hopper
