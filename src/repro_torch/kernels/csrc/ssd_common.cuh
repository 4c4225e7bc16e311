// Device helpers shared by the SSD scan's forward (ssd_scan.cu) and
// backward (ssd_scan_bwd.cu) kernels for Hopper (sm_90a): asynchronous
// copies, ldmatrix, the m16n8k16 bf16 tensor-core product, the split of an
// f32 pair into bf16 hi + lo halves, and tile loads into bf16 planes.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t4):
//   A (16 x 16, row major), 4 registers of 2 bf16:
//     {(g, 2t4..2t4+1), (g+8, 2t4..), (g, 8+2t4..), (g+8, 8+2t4..)}
//   B (16 x 8, k x n), 2 registers: {(k 2t4..2t4+1, n g), (k 8+2t4.., n g)}
//   C (16 x 8) f32: {(g, 2t4), (g, 2t4+1), (g+8, 2t4), (g+8, 2t4+1)}
// so the accumulators of two neighbouring n8 tiles, as bf16 pairs, are the
// A operand of a product whose k runs along their columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; `bytes` = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 x 16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v0, v1) as packed bf16 pairs hi + lo.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Rows [0, rows_pad) x columns [0, cols_pad) of a bf16 plane (row stride
// ld) from `src` (row stride `stride`, contiguous columns); entries past
// rows x cols are 0.  kCols >= cols_pad is a compile-time row width, so
// that the thread -> (row, column) split is a shift.  kAsync: 16-byte
// cp.async per 8 columns (cols is a multiple of 8).  Otherwise element
// loads; an f32 value also writes its lo half into `lo`.
template <typename T, bool kAsync, int kCols>
__device__ __forceinline__ void load_tile(bf16* hi, bf16* lo, int ld, const T* src,
                                          long long stride, int rows, int cols,
                                          int rows_pad, int cols_pad, int tid, int nthr) {
  if constexpr (kAsync) {
    constexpr int kPer = kCols / 8;
    for (int i = tid; i < rows_pad * kPer; i += nthr) {
      const int r = i / kPer, c = (i % kPer) * 8;
      if (c >= cols_pad) continue;
      const bool ok = r < rows && c < cols;
      cp_async16(hi + r * ld + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows_pad * kCols; i += nthr) {
      const int r = i / kCols, c = i % kCols;
      if (c >= cols_pad) continue;
      const float v = r < rows && c < cols ? to_f32(src[r * stride + c]) : 0.f;
      const bf16 h = __float2bfloat16_rn(v);
      hi[r * ld + c] = h;
      if constexpr (std::is_same<T, float>::value)
        lo[r * ld + c] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

}  // namespace
