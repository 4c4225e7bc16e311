// Causal GQA attention for prefill on Hopper (sm_90a): one launch computes
// what models/layers.py blocked_causal_attention computes, at its precision.
//
// It replaces no Pallas kernel.  The JAX package's attention is jnp code
// (f32 scores of bf16 operands, a mask of -1e30, softmax in f32, the weights
// rounded to bf16 before P V); the port's blocked function is its plain
// torch counterpart, and stays the path of CPU tensors and of training,
// which records a graph through it (this kernel has no backward).
//
// What bounds it.  Causal Q K^T and P V at zamba2-2.7b's prefill (B 8,
// T 4,096, H 32, hd 80) are 687 GFLOP an application: 0.695 ms at the
// card's 989 TFLOP/s of bf16, while Q, K, V and O are 168 MB each, ~0.2 ms
// of HBM.  By its operations and bytes it is bound by tensor-core FLOPs,
// and its design is the one of a fused (flash) attention on Hopper's
// warpgroup products:
//   * one block of kWG warpgroups (4 warps each) per (batch row, head, tile
//     of 64 kWG query rows); each warpgroup owns 64 rows, each of its warps
//     16.  The heaviest query tiles (the last ones, which see the most
//     keys) are launched first, over every head;
//   * the block walks the K/V tiles of 64 keys from the first key any of
//     its rows may see (0, or the first row's local chunk) up to the
//     diagonal and stops there: the causal skip halves the work; a
//     warpgroup skips the diagonal tiles that lie wholly after its rows;
//   * K/V tiles are double-buffered in shared memory by cp.async, the next
//     tile loading while this one is multiplied, in the 8 x 16-byte core
//     matrices that wgmma reads without a swizzle;
//   * S = Q K^T is one wgmma.m64n64k16 per 16 of hd with both operands in
//     shared memory; O += P V one wgmma.m64n{hd}k16 per 16 keys with P in
//     registers, straight from the score accumulators (per warp their
//     layout is the A operand's), and V read transposed (MN-major);
//   * the running max, the running sum and the O accumulator stay in
//     registers; nothing of size T x S reaches device memory.  The output
//     tile is staged through shared memory into 16-byte stores.
// On an H100 it takes ~2.9 ms at that shape, ~4x its bound; the K/V tiles'
// loads alone, with every product and exponential taken out, take ~2.4 ms
// (5.4 GB of tiles an application at 128 query rows a block), so the loads,
// not the tensor cores, are what a faster design has to cut (PERF.md).
//
// Precision, one pass (online softmax).  Scores are bf16 x bf16 products
// summed in f32 on the tensor cores, times hd^-0.5 in f32: the reference's
// "f32 scores of bf16 operands" (it upcasts before the product only
// because torch's bf16 matmul returns bf16); the kernel keeps them in
// base-2 units (times log2 e) for ex2.  Masked scores are -1e30, as the
// reference's, so a row without any key in its chunk spreads over all S
// keys as the reference's softmax does; keys past S are -inf.  The
// softmax runs in f32 against the running max m; the unnormalised weights
// exp(s - m) are rounded to bf16 for P V (the reference rounds the
// normalised ones: another point, the same 8 bits), P V is summed in f32,
// the f32 sum l of the unrounded weights divides it at the end, and the
// output is rounded once to bf16.  One pass rather than two: a second pass
// that rounds the normalised weights exactly as the reference does would
// compute Q K^T twice, for no gain in precision.
//
// The entry point launches on `stream` and returns cudaGetLastError() as
// an int (0 on success).  hd is a template parameter: 64, 80 (5 k-steps of
// 16), 128 and 256, the head dims of the port's configurations, and 16, the
// head dim of their smoke sizes (one k-step; P V is one m64n16k16).

#include "ssd_common.cuh"

#include <math.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kBN = 64;  // keys per K/V tile

// Warpgroups a block, and blocks an SM that the register budget must allow
// (chosen by timing the candidates on an H100 at B 8, T 4,096; PERF.md):
// two blocks of two warpgroups, a thread held to 128 registers, beat one
// block of the same with more registers (4.4 ms against 3.0 at hd 80), and
// one or three warpgroups a block.  hd 256's O alone takes 128 registers.
template <int HD> struct Shape;
template <> struct Shape<16> { static constexpr int kWG = 2, kMinBlocks = 2; };
template <> struct Shape<64> { static constexpr int kWG = 2, kMinBlocks = 2; };
template <> struct Shape<80> { static constexpr int kWG = 2, kMinBlocks = 2; };
template <> struct Shape<128> { static constexpr int kWG = 2, kMinBlocks = 2; };
template <> struct Shape<256> { static constexpr int kWG = 2, kMinBlocks = 1; };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long sq[3], sk[3], sv[3], so[3];  // (batch, time, head) element strides
  int heads, group, t, s, q_offset, chunk;
  float scale;
};

template <int HD>
__host__ __device__ constexpr int block_rows() { return 64 * Shape<HD>::kWG; }

template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (block_rows<HD>() + 4 * kBN) * HD * (int)sizeof(bf16);
}

// --- wgmma: m64nNk16, bf16 operands, f32 accumulators ---------------------
//
// Accumulator layout (d of m64nN): warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; lane 4 g + t4 holds, per 8 columns j, d[4 j + 0..3] =
// (row g, col 8 j + 2 t4), (g, 8 j + 2 t4 + 1), (g + 8, 8 j + 2 t4),
// (g + 8, 8 j + 2 t4 + 1), the layout of mma.sync's m16n8 C tile.  A in
// registers (m64k16) is mma.sync's m16n8k16 A fragment per warp.
//
// Shared-memory operands are tiles of 8-row x 16-byte core matrices, 128
// contiguous bytes each, with no swizzle: a plane of R rows and HD columns
// keeps core matrix (row group r, column chunk c) at (r * HD / 8 + c) * 128
// bytes.  K-major (Q as A, K as B of Q K^T): the leading byte offset steps
// along k (the next chunk, 128 bytes), the stride byte offset along m or n
// (the next row group, HD * 16 bytes).  MN-major (V as B of P V, k = keys,
// n = hd): the leading byte offset steps along k (the next row group), the
// stride byte offset along n (the next chunk).

// ss (both operands in shared memory) serves S = Q K^T, at n = 64 keys; rs
// (A in registers) serves O += P V, at n = hd.
template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  // d (64 x 64 f32; 32 a thread) = A B, + d with acc: A and B in shared memory.
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d += A B: A in registers, B in shared memory, MN-major.
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<16> {
  // d += A B: A in registers, B in shared memory, MN-major.
  __device__ __forceinline__ static void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<80> {
  // d += A B: A in registers, B in shared memory, MN-major.
  __device__ __forceinline__ static void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // d += A B: A in registers, B in shared memory, MN-major.
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<256> {
  // d += A B: A in registers, B in shared memory, MN-major.
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint64_t smem_desc(const void* p, int lead, int stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of `d` across a wgmma fence or wait.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// cp.async's writes (the generic proxy) made visible to wgmma's reads (the
// async proxy); the block's barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of a (time, hd) plane with row stride `stride` into
// shared memory as core matrices, 16 bytes a cp.async; rows at or past
// `limit` are zero-filled.  Thread i takes row 8 (j / (HD/8)) + i % 8 and
// chunk j % (HD/8), j = i / 8: shared memory is written in order, and a
// warp reads four 64-byte runs of global memory.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int r0,
                                          int limit, int tid) {
  constexpr int kPer = HD / 8;
  for (int i = tid; i < ROWS * kPer; i += THREADS) {
    const int j = i >> 3, r = (j / kPer) * 8 + (i & 7), c = (j % kPer) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + i * 8, ok ? src + (long long)(r0 + r) * stride + c : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

template <int HD>
__global__ void __launch_bounds__(128 * Shape<HD>::kWG, Shape<HD>::kMinBlocks) causal_attention_kernel(const Params p) {
  constexpr int kThreads = 128 * Shape<HD>::kWG, kBM = block_rows<HD>();
  constexpr int kPer = HD / 8;     // 16-byte chunks a row
  constexpr int kGroup = kPer * 128;  // bytes of a row group of 8
  constexpr int kKS = HD / 16;     // k-steps of Q K^T
  constexpr int kST = kBN / 8;     // 8-column tiles of S
  constexpr int kNT = HD / 8;      // 8-column tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBM][HD], then the output
  bf16* sK = sQ + kBM * HD;                      // [2][kBN][HD]
  bf16* sV = sK + 2 * kBN * HD;                  // [2][kBN][HD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads, kvh = h / p.group;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest tiles first
  const bf16* qg = p.q + b * p.sq[0] + h * p.sq[2];
  const bf16* kg = p.k + b * p.sk[0] + kvh * p.sk[2];
  const bf16* vg = p.v + b * p.sv[0] + kvh * p.sv[2];

  // The keys this block's rows may see: [kv_lo, kv_hi).  `spread`: some row
  // has no key in its chunk, and the reference spreads it over all S keys.
  const int qlo = p.q_offset + m0, qhi = p.q_offset + min(m0 + kBM, p.t) - 1;
  const bool spread = p.chunk && qhi / p.chunk * p.chunk >= p.s;
  int kv_lo = 0, kv_hi = spread ? p.s : min(p.s, qhi + 1);
  if (p.chunk && !spread) kv_lo = qlo / p.chunk * p.chunk;
  const int first = kv_lo / kBN * kBN;
  const int n_tiles = (kv_hi - first + kBN - 1) / kBN;

  load_rows<HD, kBM, kThreads>(sQ, qg, p.sq[1], m0, p.t, tid);
  load_rows<HD, kBN, kThreads>(sK, kg, p.sk[1], first, p.s, tid);
  load_rows<HD, kBN, kThreads>(sV, vg, p.sv[1], first, p.s, tid);
  cp_async_commit();

  const int wrow = 16 * warp;  // this warp's first row in the tile
  const int wg_last = p.q_offset + m0 + 64 * wg + 63;  // its warpgroup's last row's position
  const float scale2 = p.scale * kLog2e;  // scores in base-2 units: e^x = 2^(x log2 e)
  const bf16* wq = sQ + 64 * wg * HD;     // the warpgroup's 64 rows of Q
  float o[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = first + it * kBN;
    if (it + 1 < n_tiles) {
      load_rows<HD, kBN, kThreads>(sK + (stage ^ 1) * kBN * HD, kg, p.sk[1], k0 + kBN, p.s, tid);
      load_rows<HD, kBN, kThreads>(sV + (stage ^ 1) * kBN * HD, vg, p.sv[1], k0 + kBN, p.s, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const bf16* tK = sK + stage * kBN * HD;
    const bf16* tV = sV + stage * kBN * HD;

    // A tile wholly after this warpgroup's rows adds exactly nothing to them
    // (unless a row of the block spreads over every key): skip its work.
    if (k0 <= wg_last || spread) {
      // S = Q K^T for the warpgroup's 64 rows and the tile's 64 keys.
      float s[kST * 4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        Wgmma<kBN>::ss(s, smem_desc(wq + ks * 128, 128, kGroup),
                       smem_desc(tK + ks * 128, 128, kGroup), ks);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // The online softmax row by row (this warp's rows g and g + 8; a
      // row's scores lie on a quad).  A tile every row of the block sees
      // whole takes the short path: the max of the raw scores, then
      // 2^(s scale2 - m) in one FMA.  Others are scaled first and masked.
      const int k_last = k0 + kBN - 1;
      const bool masked = k_last > qlo || k0 + kBN > p.s ||
                          (p.chunk && (k0 / p.chunk < qhi / p.chunk ||
                                       k_last / p.chunk > qlo / p.chunk));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx;
        if (masked) {
          const int qpos = p.q_offset + m0 + wrow + g + 8 * i;
          mx = m[i];
#pragma unroll
          for (int n = 0; n < kST; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + n * 8 + 2 * t4 + e;
              float x = s[4 * n + 2 * i + e] * scale2;
              if (key >= p.s)
                x = -INFINITY;
              else if (key > qpos || (p.chunk && key / p.chunk != qpos / p.chunk))
                x = kMasked;
              s[4 * n + 2 * i + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = quad_max(mx);
        } else {
          float raw = s[2 * i];
#pragma unroll
          for (int n = 0; n < kST; ++n)
            raw = fmaxf(raw, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
          mx = fmaxf(m[i], quad_max(raw) * scale2);
        }
        const float alpha = fast_exp2(m[i] - mx);  // 0 on the first tile
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kST; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * n + 2 * i + e];
            x = fast_exp2(masked ? x - mx : fmaf(x, scale2, -mx));
            sum += x;
          }
        l[i] = l[i] * alpha + sum;  // this thread's share; the quad's at the end
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          o[4 * nt + 2 * i] *= alpha;
          o[4 * nt + 2 * i + 1] *= alpha;
        }
      }

      // O += bf16(P) V, 16 keys a product.
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        Wgmma<HD>::rs(o, pa[kk], smem_desc(tV + kk * 16 * HD, kGroup, 128));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // O / l, rounded once to bf16, staged through shared memory (Q's plane,
  // core-matrix order) and stored 16 bytes a thread.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const int r = wrow + g + 8 * i;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      *reinterpret_cast<uint32_t*>(sQ + ((r >> 3) * kPer + nt) * 64 + (r & 7) * 8 + 2 * t4) =
          pack_bf16(o[4 * nt + 2 * i] * inv, o[4 * nt + 2 * i + 1] * inv);
  }
  __syncthreads();
  bf16* og = p.o + b * p.so[0] + h * p.so[2];
  for (int i = tid; i < kBM * kPer; i += kThreads) {
    const int j = i >> 3, r = (j / kPer) * 8 + (i & 7), c = (j % kPer) * 8;
    if (m0 + r < p.t)
      *reinterpret_cast<uint4*>(og + (long long)(m0 + r) * p.so[1] + c) =
          *reinterpret_cast<const uint4*>(sQ + i * 8);
  }
}

template <int HD>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<HD>();
  // The opt-in to more than 48 KB of shared memory, on the current device.
  const cudaError_t err = cudaFuncSetAttribute(
      causal_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * p.heads, (p.t + block_rows<HD>() - 1) / block_rows<HD>());
  causal_attention_kernel<HD><<<grid, 128 * Shape<HD>::kWG, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, hd), k and v (B, S, KV, hd), o (B, T, H, hd), all bf16 with a
// contiguous hd; `strides` holds the (batch, time, head) element strides of
// q, k, v and o in that order (12 values, each a multiple of 8).  Query row
// i sits at position q_offset + i and sees keys j <= q_offset + i (and, with
// chunk > 0, only keys of its own chunk of `chunk` positions).  Returns 0 on
// success, the CUDA error otherwise; cudaErrorInvalidValue for a head dim
// without an instance.
extern "C" int causal_attention(const void* q, const void* k, const void* v, void* o,
                                int batch, int t, int s, int heads, int kv_heads, int hd,
                                int q_offset, int chunk, float scale,
                                const long long* strides, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.heads = heads;
  p.group = heads / kv_heads;
  p.t = t;
  p.s = s;
  p.q_offset = q_offset;
  p.chunk = chunk;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, batch, st);
    case 64: return launch<64>(p, batch, st);
    case 80: return launch<80>(p, batch, st);
    case 128: return launch<128>(p, batch, st);
    case 256: return launch<256>(p, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
