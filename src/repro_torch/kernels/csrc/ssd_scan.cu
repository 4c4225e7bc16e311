// Chunked Mamba-2 SSD (state-space duality) scan for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan.  For each (batch, head)
// row and each chunk of q steps, with s = cumsum(dt * a) over the chunk and
// L[t, j] = exp(s_t - s_j) for t >= j (0 above the diagonal):
//
//   G     = C B^T                               (per batch row and chunk)
//   y     = (L o G * dt) X + exp(s) * (C h_prev)
//   h_new = exp(s_last) * h_prev + (B * w)^T X,   w = dt * exp(s_last - s)
//
// x, b and c are bf16 or f32, dt, a, h0 f32; y and h_final are f32.
//
// Bound.  At the main shape (B=4, T=1024, H=64, P=64, N=128, q=128, bf16)
// the function must move 112.2 MB, 33.49 us at 3.35 TB/s; it is bytes-bound.
// The tensor-core work issued below is 22.09 GFLOP (1,312 m16n8k16 products
// per block and chunk, 576 per G), 22.3 us at 989 TFLOP/s, under the bytes.
//
// Two kernels.  ssd_chunk_gram_kernel computes G once per (batch, chunk) --
// b and c are shared by the H heads of a batch row -- and writes its 16 x 16
// tiles on and below the diagonal, f32, in the order the scan's threads read
// them (1.2 MB at the main shape, read back from L2).  ssd_scan_kernel runs
// one block per (batch, head, slice of kSlice = 32 columns of p), so no
// block talks to another: p = 64 gives 512 blocks, 3.9 waves of one
// 184 KB block per SM.  Each block loops over its chunks with h in
// registers (f32) from the first chunk to the last.
//
// Arithmetic.  Every product is mma.sync.m16n8k16 with bf16 operands and
// f32 accumulation; bf16 x bf16 products are exact in f32.  mma.sync rather
// than wgmma: the kernel is bytes-bound, the operands of two of its four
// products are built in registers per thread (M from G's fragment, B o w),
// and the m16 tiles fit the triangle of M.  bf16 inputs go in as they are.
// Operands computed in f32 -- M = L o G * dt, h, and B o w -- go in as
// hi + lo bf16 halves with two products (hi, lo against the other operand);
// f32 inputs are split the same way, and a product of two split operands
// takes three (lo x lo is dropped).  That keeps ~16 bits of every operand:
// the card tests' 1e-4 and the serving check's 1e-3 hold, where one bf16
// rounding does not.
//
// Per chunk, in a block of 16 warps, warps 0-7 compute y and warps 8-15
// the state, at once:
//   * C h_prev: y warp w owns the 16 rows of tile w' of y (w' = w for w < 4,
//     11 - w after, so the two y warps on one scheduler share 9 tiles of
//     M's triangle); A = C (ldmatrix), B = the hi/lo bf16 planes of h in
//     shared memory (ldmatrix.trans); scaled by exp(s_t) in registers.
//   * M X: the warp's tiles of G, requested two ahead, become M in
//     registers, with no branch: 2^(s_r - s_c) log2(e) * dt_c * G, the
//     exponent set to -inf above the diagonal before the exponential; M is
//     fed, split, as the A operand and never stored, on and below the
//     diagonal only.
//   * h update: h warp 8 + v owns state rows 16v..16v+15 in registers;
//     A = (B o w)^T from B by ldmatrix.trans, scaled and split; B = X.  The
//     new h goes to the planes after the chunk's last barrier.
//
// Loads.  The aligned bf16 path (16-byte-aligned bases and strides, n and p
// multiples of 8) loads the next chunk's x, b, c and dt with cp.async (16
// bytes, zero-filled past the edges) into the second of two stages while
// the current chunk computes: the h warps, which finish before the y warps,
// issue the copies, and warp 8 waits for dt alone and scans it into the
// other set of s, exp(s) and w, so the next chunk starts at its first
// barrier with its tiles and scan in place.  f32 inputs and unaligned bf16
// views (a base or stride off a 16-byte boundary, n or p not a multiple of
// 8) take a scalar path that loads and scans each chunk before computing
// it, splitting f32 values into hi/lo planes.  y is stored with 16-byte
// vector stores (lanes pair up by a shuffle) when p is a multiple of 4.
//
// Against the FMA kernel it replaces: the tensor cores take the four
// products (the FMA loops issued 21.5 GFLOP on 67 TFLOP/s CUDA cores); G is
// computed once per (batch, chunk), not per head, and the zero tiles above
// M's diagonal are skipped; the p-split gives 512 blocks instead of 256;
// loads overlap compute, and y goes out in 16-byte stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 128;        // q, n, p limits: 8 tiles of 16 rows
constexpr int kSlice = 32;          // p columns per block: four n8 tiles
constexpr int kLdx = kSlice + 8;    // row of the x and h planes, in bf16 (padded)
constexpr int kG = 2;               // G tiles in flight per y warp
constexpr float kLog2e = 1.4426950408889634f;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h0;  // (rows, n, p) contiguous, or null for zeros
  float* gram;      // G tiles, (batch, chunk, tile, lane, 8) f32
  float* y;
  float* hout;      // (rows, n, p) contiguous
  int nh, t, q, n, p;
  // element strides; row r is (bi, hi) = (r / nh, r % nh)
  long long sx_b, sx_h, sx_t;
  long long sdt_b, sdt_h, sdt_t;
  long long sa_b, sa_h;
  long long sb_b, sb_t;
  long long sc_b, sc_t;
  long long sy_b, sy_h, sy_t;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int gram_tiles(int q) {
  const int qt = round16(q) / 16;
  return qt * (qt + 1) / 2;
}

// Shared-memory layout of the scan kernel: two stages of {x (q16, kLdx),
// b (q16, ldn), c (q16, ldn) bf16; dt (q16) f32}, the hi/lo planes of h
// (n16, kLdx) bf16, and two sets (by chunk parity) of the f32 vectors
// s * log2(e), exp(s) and w (q16 each).
struct Layout {
  int q16, n16, ldn;
  long long x, b, c, dt, stage, h, vec, total;
  __host__ __device__ Layout(int q, int n) : q16(round16(q)), n16(round16(n)), ldn(n16 + 8) {
    x = 0;
    b = x + 2LL * q16 * kLdx;
    c = b + 2LL * q16 * ldn;
    dt = c + 2LL * q16 * ldn;
    stage = dt + 4LL * q16;
    h = 2 * stage;
    vec = h + 2 * 2LL * n16 * kLdx;
    total = vec + 2 * 3 * 4LL * q16;
  }
};

// The G kernel's: the hi (and, for f32 inputs, lo) planes of c and b.
__host__ __device__ inline long long gram_smem_bytes(int q, int n, int parts) {
  return (long long)parts * 2 * 2 * round16(q) * (round16(n) + 8);
}

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

// One block per (batch, chunk): the tiles of G = C B^T on and below the
// diagonal, each warp a tile at a time.  Lane l of a tile stores its two
// m16n8 accumulators, (row g, cols 2t, 2t+1), (row g+8, ...) for columns
// 0-7 then 8-15, as 8 consecutive floats.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads) ssd_chunk_gram_kernel(const SsdArgs args) {
  constexpr int kIn = std::is_same<T, float>::value ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = args.q, n = args.n, nc = args.t / args.q;
  const int q16 = round16(q), n16 = round16(n), ldn = n16 + 8, nt = n16 / 16;
  const int bi = blockIdx.x / nc, ci = blockIdx.x % nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* cs = reinterpret_cast<bf16*>(smem);  // plane k of c at cs + 2k*q16*ldn, of b after it
  const long long plane = (long long)q16 * ldn;
  const long long t0 = (long long)ci * q;
  load_tile<T, kAsync, kMaxDim>(cs, cs + 2 * plane, ldn,
                       static_cast<const T*>(args.c) + bi * args.sc_b + t0 * args.sc_t,
                       args.sc_t, q, n, q16, n16, threadIdx.x, kThreads);
  load_tile<T, kAsync, kMaxDim>(cs + plane, cs + 3 * plane, ldn,
                       static_cast<const T*>(args.b) + bi * args.sb_b + t0 * args.sb_t,
                       args.sb_t, q, n, q16, n16, threadIdx.x, kThreads);
  if constexpr (kAsync) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  const int ntiles = gram_tiles(q);
  float* out = args.gram + (long long)blockIdx.x * ntiles * 256;
  for (int tile = warp; tile < ntiles; tile += kWarps) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= tile) ++i;
    const int j = tile - i * (i + 1) / 2;
    float acc[2][4] = {};
    for (int kt = 0; kt < nt; ++kt) {
      uint32_t ca[kIn][4], bb[kIn][4];
#pragma unroll
      for (int k = 0; k < kIn; ++k) {
        ldsm_x4(ca[k], cs + 2 * k * plane + (16 * i + (lane & 15)) * ldn + 16 * kt +
                           (lane >> 4) * 8);
        ldsm_x4(bb[k], cs + (2 * k + 1) * plane +
                           (16 * j + (lane & 7) + (lane >> 4) * 8) * ldn + 16 * kt +
                           ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mma(acc[h2], ca[0], bb[0][2 * h2], bb[0][2 * h2 + 1]);
        if constexpr (kIn == 2) {
          mma(acc[h2], ca[0], bb[1][2 * h2], bb[1][2 * h2 + 1]);
          mma(acc[h2], ca[1], bb[0][2 * h2], bb[0][2 * h2 + 1]);
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(out + ((long long)tile * 32 + lane) * 8);
    dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    dst[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
}

// One block per (batch, head, p-slice); see the header.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const SsdArgs args) {
  constexpr int kIn = std::is_same<T, float>::value ? 2 : 1;
  constexpr int kHalf = kThreads / 2;  // threads of the y warps, and of the h warps
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = args.q, n = args.n, p = args.p, nc = args.t / args.q;
  const Layout lay(q, n);
  const int q16 = lay.q16, ldn = lay.ldn, qt = q16 / 16, nt = lay.n16 / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  const int slices = (p + kSlice - 1) / kSlice;
  const int row = blockIdx.x / slices, p0 = (blockIdx.x % slices) * kSlice;
  const int pw = min(kSlice, p - p0);
  const int bi = row / args.nh, hi = row % args.nh;
  const T* xg = static_cast<const T*>(args.x) + bi * args.sx_b + hi * args.sx_h + p0;
  const T* bg = static_cast<const T*>(args.b) + bi * args.sb_b;
  const T* cg = static_cast<const T*>(args.c) + bi * args.sc_b;
  const float* dtg = args.dt + bi * args.sdt_b + hi * args.sdt_h;
  float* yg = args.y + bi * args.sy_b + hi * args.sy_h + p0;
  const float a = args.a[bi * args.sa_b + hi * args.sa_h];
  const float* gram = args.gram + (long long)bi * nc * gram_tiles(q) * 256;

  // Buffer k's arrays.  The async path uses buffers 0 and 1 as two stages;
  // the scalar path loads each chunk into buffer 0, with the lo planes of
  // f32 inputs in buffer 1.  The scan's vectors alternate by chunk.
  auto xs = [&](int k) { return reinterpret_cast<bf16*>(smem + k * lay.stage + lay.x); };
  auto bs = [&](int k) { return reinterpret_cast<bf16*>(smem + k * lay.stage + lay.b); };
  auto cs = [&](int k) { return reinterpret_cast<bf16*>(smem + k * lay.stage + lay.c); };
  auto dts = [&](int k) { return reinterpret_cast<float*>(smem + k * lay.stage + lay.dt); };
  // s * log2(e), exp(s), w = dt * exp(s_last - s) of chunk ci
  auto vec = [&](int ci) { return reinterpret_cast<float*>(smem + lay.vec) + (ci & 1) * 3 * q16; };
  bf16* hp[2] = {reinterpret_cast<bf16*>(smem + lay.h),
                 reinterpret_cast<bf16*>(smem + lay.h) + lay.n16 * kLdx};

  // Warps 0-7 compute y, warps 8-15 the state update.  y warp w owns the
  // 16 rows of tile mi of y and M (mi = w for w < 4, 11 - w after, so that
  // the two y warps on one scheduler share 9 tiles of the triangle).  h warp
  // 8 + v holds state rows 16v + g (+8) and columns 8j + 2t4 (+1) of the
  // slice in f32 for every chunk; the planes carry its hi/lo halves to the
  // C h_prev product.  On the async path the h warps, which finish first,
  // load the next chunk and warp 8 scans its dt.
  const bool y_warp = warp < kWarps / 2;
  const int mi = warp < 4 ? warp : 11 - warp;
  const bool has_y = y_warp && mi < qt;
  const int yr = 16 * mi + g;
  const int hv = warp - kWarps / 2;
  const bool has_h = !y_warp && hv < nt;
  const int hr = 16 * hv + g;
  constexpr int kScanWarp = kWarps / 2;

  // x, b, c of chunk ci into buffer k by threads [t0, t0 + nthr); on the
  // async path dt goes first, as a group of its own, from the scan warp.
  auto load_chunk = [&](int ci, int k, int tid, int nthr) {
    const long long t0 = (long long)ci * q;
    if (!kAsync || warp == kScanWarp) {
      const int dl = kAsync ? lane : tid, dn = kAsync ? 32 : nthr;
      for (int i = dl; i < q16; i += dn) {
        const float* src = dtg + (t0 + i) * args.sdt_t;
        if constexpr (kAsync)
          cp_async4(dts(k) + i, i < q ? src : dtg, i < q ? 4 : 0);
        else
          dts(k)[i] = i < q ? *src : 0.f;
      }
    }
    if constexpr (kAsync) cp_async_commit();
    load_tile<T, kAsync, kSlice>(xs(k), xs(1), kLdx, xg + t0 * args.sx_t, args.sx_t, q, pw,
                                 q16, kSlice, tid, nthr);
    load_tile<T, kAsync, kMaxDim>(bs(k), bs(1), ldn, bg + t0 * args.sb_t, args.sb_t, q, n,
                                  q16, lay.n16, tid, nthr);
    load_tile<T, kAsync, kMaxDim>(cs(k), cs(1), ldn, cg + t0 * args.sc_t, args.sc_t, q, n,
                                  q16, lay.n16, tid, nthr);
    if constexpr (kAsync) cp_async_commit();
  };

  // The scan of chunk ci by one warp: s = inclusive cumsum of dt * a, each
  // lane summing up to four consecutive steps before the lanes scan their
  // totals.
  auto scan = [&](int ci, const float* d) {
    float* sl = vec(ci);
    float* ev = sl + q16;
    float* wv = ev + q16;
    const int per = (q + 31) / 32;
    float loc[kMaxDim / 32];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxDim / 32; ++u) {
      const int j = lane * per + u;
      if (u < per && j < q) run += d[j] * a;
      loc[u] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const float s_last = __shfl_sync(0xffffffffu, incl, 31);
    const float excl = incl - run;
#pragma unroll
    for (int u = 0; u < kMaxDim / 32; ++u) {
      const int j = lane * per + u;
      if (u < per && j < q16) {
        const float s = excl + loc[u];
        sl[j] = j < q ? s * kLog2e : 0.f;
        ev[j] = j < q ? expf(s) : 0.f;
        wv[j] = j < q ? d[j] * expf(s_last - s) : 0.f;
      }
    }
  };

  float acc_h[4][4] = {};
  if (has_h && args.h0) {
    const float* h0 = args.h0 + (long long)row * n * p + p0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = hr + (e >> 1) * 8, c = 8 * j + 2 * t4 + (e & 1);
        if (r < n && c < pw) acc_h[j][e] = h0[(long long)r * p + c];
      }
  }
  auto store_h_planes = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t h, l;
        split2(acc_h[j][2 * half], acc_h[j][2 * half + 1], h, l);
        const int off = (hr + 8 * half) * kLdx + 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(hp[0] + off) = h;
        *reinterpret_cast<uint32_t*>(hp[1] + off) = l;
      }
  };
  if (has_h) store_h_planes();
  if constexpr (kAsync) {
    if (!y_warp) {
      load_chunk(0, 0, threadIdx.x - kHalf, kHalf);
      if (warp == kScanWarp) {
        cp_async_wait<1>();
        __syncwarp();
        scan(0, dts(0));
      }
    }
  }

  for (int ci = 0; ci < nc; ++ci) {
    // This warp's tiles of G for the chunk, kG in flight: the first are
    // requested before the barrier, to arrive while C h_prev runs, and each
    // later one kG tiles before its use.
    float4 gt[kG][2];
    const float4* gsrc = reinterpret_cast<const float4*>(
        gram + (((long long)ci * gram_tiles(q) + mi * (mi + 1) / 2) * 32 + lane) * 8);
    if (has_y) {
#pragma unroll
      for (int u = 0; u < kG; ++u)
        if (u <= mi) gt[u][0] = gsrc[64 * u], gt[u][1] = gsrc[64 * u + 1];
    }
    const int k = kAsync ? ci & 1 : 0;
    if constexpr (kAsync) {
      if (!y_warp) cp_async_wait<0>();
    } else {
      load_chunk(ci, 0, threadIdx.x, kThreads);
      __syncthreads();
      if (warp == kScanWarp) scan(ci, dts(0));
    }
    __syncthreads();  // the chunk's tiles, its scan and the h planes are in place

    const float* sl = vec(ci);
    const float* ev = sl + q16;
    const float* wv = ev + q16;
    const bf16* x_[2] = {xs(k), xs(1)};
    auto load_x = [&](uint32_t (&xb)[kIn][2][4], int kt) {  // X (k = time, n = p)
#pragma unroll
      for (int u = 0; u < kIn; ++u)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm_x4_t(xb[u][np], x_[u] + (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdx +
                                   16 * np + (lane >> 4) * 8);
    };

    if (has_y) {
      // y = exp(s) * (C h_prev)
      const bf16* c_[2] = {cs(k), cs(1)};
      const float* dv = dts(k);
      float acc_y[4][4] = {};
#pragma unroll
      for (int kt = 0; kt < kMaxDim / 16; ++kt) {
        if (kt >= nt) break;
        uint32_t ca[kIn][4];
#pragma unroll
        for (int u = 0; u < kIn; ++u)
          ldsm_x4(ca[u], c_[u] + (16 * mi + (lane & 15)) * ldn + 16 * kt + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t hb[2][4];
          const int off = (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdx + 16 * np +
                          (lane >> 4) * 8;
          ldsm_x4_t(hb[0], hp[0] + off);
          ldsm_x4_t(hb[1], hp[1] + off);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float(&acc)[4] = acc_y[2 * np + h2];
            mma(acc, ca[0], hb[0][2 * h2], hb[0][2 * h2 + 1]);
            mma(acc, ca[0], hb[1][2 * h2], hb[1][2 * h2 + 1]);
            if constexpr (kIn == 2) mma(acc, ca[1], hb[0][2 * h2], hb[0][2 * h2 + 1]);
          }
        }
      }
      const float e0 = ev[yr], e1 = ev[yr + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_y[j][0] *= e0;
        acc_y[j][1] *= e0;
        acc_y[j][2] *= e1;
        acc_y[j][3] *= e1;
      }

      // y += M X over the tiles on and below the diagonal, with
      // M[r, c] = exp(s_r - s_c) * dt_c * G[r, c] for c <= r, else 0.  Only
      // the diagonal tile holds c > r, and there the exponent is masked
      // (to -inf) before the exponential.  Rows r >= q are never stored.
      const float sr[2] = {sl[yr], sl[yr + 8]};
#pragma unroll
      for (int kt = 0; kt < kMaxDim / 16; ++kt) {
        if (kt > mi) break;
        uint32_t xb[kIn][2][4];
        load_x(xb, kt);
        const float4(&gk)[2] = gt[kt % kG];
        const float gv[8] = {gk[0].x, gk[0].y, gk[0].z, gk[0].w,
                             gk[1].x, gk[1].y, gk[1].z, gk[1].w};
        if (kt + kG <= mi) {
          gt[kt % kG][0] = gsrc[64 * (kt + kG)];
          gt[kt % kG][1] = gsrc[64 * (kt + kG) + 1];
        }
        const int c0 = 16 * kt + 2 * t4;
        const float2 sc[2] = {*reinterpret_cast<const float2*>(sl + c0),
                              *reinterpret_cast<const float2*>(sl + c0 + 8)};
        const float2 dc[2] = {*reinterpret_cast<const float2*>(dv + c0),
                              *reinterpret_cast<const float2*>(dv + c0 + 8)};
        float m[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int rh = (e >> 1) & 1, ch = e >> 2;
          const float scv = e & 1 ? sc[ch].y : sc[ch].x, dcv = e & 1 ? dc[ch].y : dc[ch].x;
          float arg = sr[rh] - scv;
          if (kt == mi && c0 + 8 * ch + (e & 1) > yr + 8 * rh)
            arg = __uint_as_float(0xff800000u);  // -inf
          m[e] = fast_exp2(arg) * dcv * gv[e];
        }
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split2(m[2 * u], m[2 * u + 1], mh[u], ml[u]);
#pragma unroll
        for (int np = 0; np < 2; ++np)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float(&acc)[4] = acc_y[2 * np + h2];
            mma(acc, mh, xb[0][np][2 * h2], xb[0][np][2 * h2 + 1]);
            mma(acc, ml, xb[0][np][2 * h2], xb[0][np][2 * h2 + 1]);
            if constexpr (kIn == 2) mma(acc, mh, xb[1][np][2 * h2], xb[1][np][2 * h2 + 1]);
          }
      }

      // Store y: lanes t4 and t4 ^ 1 swap halves so that each holds four
      // consecutive columns of one row (even t4: row g, odd: row g + 8).
      const bool odd = t4 & 1;
      const int r = yr + (odd ? 8 : 0);
      const long long base = ((long long)ci * q + r) * args.sy_t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc_y[j][0] : acc_y[j][2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc_y[j][1] : acc_y[j][3], 1);
        const float4 v = odd ? make_float4(s0, s1, acc_y[j][2], acc_y[j][3])
                             : make_float4(acc_y[j][0], acc_y[j][1], s0, s1);
        const int col = 8 * j + 2 * (t4 & 2);
        if (r >= q || col >= pw) continue;
        if (p % 4 == 0) {
          *reinterpret_cast<float4*>(yg + base + col) = v;
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
          for (int e = 0; e < 4 && col + e < pw; ++e) yg[base + col + e] = vs[e];
        }
      }
    }

    if (has_h) {
      // h = exp(s_last) h + (B o w)^T X; A = (B o w)^T has this warp's
      // states as rows and time as k.
      const bf16* b_[2] = {bs(k), bs(1)};
      const float decay = ev[q - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_h[j][e] *= decay;
#pragma unroll
      for (int kt = 0; kt < kMaxDim / 16; ++kt) {
        if (kt >= qt) break;
        uint32_t xb[kIn][2][4], braw[kIn][4];
        load_x(xb, kt);
        const int off = (16 * kt + (lane & 7) + (lane >> 4) * 8) * ldn + 16 * hv +
                        ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int u = 0; u < kIn; ++u) ldsm_x4_t(braw[u], b_[u] + off);
        const float2 w0 = *reinterpret_cast<const float2*>(wv + 16 * kt + 2 * t4);
        const float2 w1 = *reinterpret_cast<const float2*>(wv + 16 * kt + 8 + 2 * t4);
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float2 f = unpack(braw[0][u]);
          if constexpr (kIn == 2) {
            const float2 lo = unpack(braw[1][u]);
            f.x += lo.x;
            f.y += lo.y;
          }
          const float2 w = u < 2 ? w0 : w1;
          split2(f.x * w.x, f.y * w.y, bh[u], bl[u]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float(&acc)[4] = acc_h[2 * np + h2];
            mma(acc, bh, xb[0][np][2 * h2], xb[0][np][2 * h2 + 1]);
            mma(acc, bl, xb[0][np][2 * h2], xb[0][np][2 * h2 + 1]);
            if constexpr (kIn == 2) mma(acc, bh, xb[1][np][2 * h2], xb[1][np][2 * h2 + 1]);
          }
      }
    }

    // The next chunk's loads and scan, by the h warps while the y warps
    // finish.  Buffer k ^ 1 and the other scan vectors were last read in
    // the chunk before this one.
    if constexpr (kAsync) {
      if (!y_warp && ci + 1 < nc) {
        load_chunk(ci + 1, k ^ 1, threadIdx.x - kHalf, kHalf);
        if (warp == kScanWarp) {
          cp_async_wait<1>();  // this warp's dt group
          __syncwarp();
          scan(ci + 1, dts(k ^ 1));
        }
      }
    }

    __syncthreads();  // every warp is done with the h planes and this stage
    if (has_h) store_h_planes();
  }

  if (has_h) {
    float* out = args.hout + (long long)row * n * p + p0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = hr + (e >> 1) * 8, c = 8 * j + 2 * t4 + (e & 1);
        if (r < n && c < pw) out[(long long)r * p + c] = acc_h[j][e];
      }
  }
}

template <typename T, bool kAsync>
int launch(const SsdArgs& args, int nb, int rows, cudaStream_t st) {
  const int nc = args.t / args.q;
  const size_t gsmem = (size_t)gram_smem_bytes(args.q, args.n, std::is_same<T, float>::value ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_gram_kernel<T, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsmem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_gram_kernel<T, kAsync><<<nb * nc, kThreads, gsmem, st>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess || rows == 0) return (int)err;
  const size_t smem = (size_t)Layout(args.q, args.n).total;
  err = cudaFuncSetAttribute(ssd_scan_kernel<T, kAsync>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (args.p + kSlice - 1) / kSlice;
  ssd_scan_kernel<T, kAsync><<<rows * slices, kThreads, smem, st>>>(args);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

bool bad_shape(int q, int n, int p, int t, int dtype) {
  return q <= 0 || t % q != 0 || q > kMaxDim || n <= 0 || n > kMaxDim || p <= 0 ||
         p > kMaxDim || (dtype != 0 && dtype != 1);
}

}  // namespace

// C interface.  `dtype` is 0 for f32 and 1 for bf16 (x, b and c).  Each
// entry point launches on `stream`, returns cudaGetLastError() as an int
// (0 = launched) or cudaErrorInvalidValue for a shape it does not take, and
// never synchronizes.
// G = C B^T of every (batch, chunk) into `gram`, as ssd_chunk_gram_kernel
// lays it out: b, c (nb, t, n) with element strides {sb_b, sb_t, sc_b, sc_t}
// and contiguous n.
extern "C" int ssd_chunk_gram(int dtype, const void* b, const void* c, void* gram, int nb,
                              int t, int q, int n, const long long* strides, void* stream) {
  if (nb <= 0 || bad_shape(q, n, 1, t, dtype)) return (int)cudaErrorInvalidValue;
  SsdArgs args{};
  args.b = b;
  args.c = c;
  args.gram = static_cast<float*>(gram);
  args.t = t, args.q = q, args.n = n, args.p = 1, args.nh = 1;
  args.sb_b = strides[0], args.sb_t = strides[1], args.sc_b = strides[2], args.sc_t = strides[3];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(args, nb, 0, st);
  const bool vec = n % 8 == 0 && aligned16(b, {args.sb_b, args.sb_t}) &&
                   aligned16(c, {args.sc_b, args.sc_t});
  return vec ? launch<bf16, true>(args, nb, 0, st) : launch<bf16, false>(args, nb, 0, st);
}

// The scan: G into `gram` ((rows / nh) * (t / q) * tiles * 256 floats, tiles
// = qt (qt + 1) / 2 for qt = ceil(q / 16)), then y and h_final.  `rows` is batch * heads; `strides` holds the 15
// element strides in SsdArgs order.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* a,
                        const void* b, const void* c, const void* h0, void* gram, void* y,
                        void* hout, int rows, int nh, int t, int q, int n, int p,
                        const long long* strides, void* stream) {
  if (rows <= 0 || nh <= 0 || rows % nh || bad_shape(q, n, p, t, dtype))
    return (int)cudaErrorInvalidValue;
  SsdArgs args{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c,
               static_cast<const float*>(h0), static_cast<float*>(gram), static_cast<float*>(y),
               static_cast<float*>(hout), nh, t, q, n, p,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
               strides[12], strides[13], strides[14]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = rows / nh;
  if (dtype == 0) return launch<float, false>(args, nb, rows, st);
  const bool vec = n % 8 == 0 && p % 8 == 0 &&
                   aligned16(x, {args.sx_b, args.sx_h, args.sx_t}) &&
                   aligned16(b, {args.sb_b, args.sb_t}) && aligned16(c, {args.sc_b, args.sc_t});
  return vec ? launch<bf16, true>(args, nb, rows, st) : launch<bf16, false>(args, nb, rows, st);
}
