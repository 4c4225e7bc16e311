// Backward pass of the chunked Mamba-2 SSD scan for Hopper (sm_90a), on the
// tensor cores.
//
// The gradient of src/repro/kernels/ssd_scan.py:ssd_scan, which the JAX
// package takes by differentiating models/mamba2.py:ssd_chunked.  Per
// (batch, head) row and chunk of q steps, with s = cumsum(dt * a) over the
// chunk, L[t, j] = exp(s_t - s_j) for t >= j (0 above the diagonal; the
// exponent is masked to -inf before the exponential), G = C B^T, H the
// state entering the chunk (saved by the forward kernel) and dH' the
// gradient of the state leaving it:
//
//   dx_j  = dt_j sum_t (L o G)[t, j] dy_t + w_j (B dH')_j,  w_j = dt_j e^(s_last - s_j)
//   dG    = L o (dY X^T) o dt_j                          (q x q)
//   dC    = dG B + e^s o (dY H^T)
//   dB    = dG^T C + w o (X dH'^T)
//   dH    = e^(s_last) dH' + (C o e^s)^T dY              (to the chunk before)
//   ds_t  = rowsum(P)_t - colsum(P)_t + e^(s_t) c_t.(H dy_t) - w_t b_t.(dH' x_t)
//           (+ e^(s_last) sum(H o dH') + sum_j w_j b_j.(dH' x_j) at t = last),
//           P = (L o G) o (dY X^T) o dt_j = G o dG
//   ddt_j = colsum((L o G) o (dY X^T))_j + e^(s_last - s_j) b_j.(dH' x_j) + a dla_j,
//   da    = sum_j dla_j dt_j,   dla = the reverse cumsum of ds.
//
// B and C are shared by the heads of a batch row, so the head sums of dB
// and dC regroup: dC = (sum_h dG_h) B + sum_h e^s_h o (dY_h H_h^T), and
// likewise dB.  The first term is one product per (batch, chunk); the
// second runs over heads in registers.  The same dY H^T gives the qv term
// of ds, c_t.(H dy_t) = sum_n C o (dY H^T).
//
// Six kernels, launched in order on one stream:
//   ssd_bwd_scan_kernel    one warp per (row, chunk): s log2(e), e^s,
//     e^(s_last - s), w and dt per step (sv), read by the others;
//   ssd_bwd_dstate_kernel  one block per (row, 32 columns of p), two per
//     SM, walks the chunks from the last to the first: dH' of every chunk
//     (rows / nh, t / q, nh, n, p) and dh0;
//   ssd_bwd_chunk_kernel   one block per (batch, chunk, group of heads):
//     G^T = B C^T once, then for each head of the group in order: dx, the
//     parts of ds and ddt that the chunk's q x q matrices give (dsp), and
//     dG summed over the group's heads on chip; one dG^T partial per group
//     (dgp).  The two warps of a scheduler share two 16-column tiles of the
//     triangle (9 of its 36 tiles), alternating its row tiles;
//   ssd_bwd_dbc_kernel     one block of 16 warps per (batch, chunk, 32
//     columns of n):
//     db and dc of its columns, final: e^s o (dY H^T) and w o (X dH'^T)
//     summed over all heads in order in registers, then the group partials
//     of dG summed in order and multiplied by B and C; per head, qv over
//     its columns (qvp) and sum(H o dH') over its rows (hsp);
//   ssd_bwd_tail_kernel    one warp per (row, chunk): ds, its reverse
//     cumsum, ddt and the chunk's share of da (dap);
//   ssd_bwd_da_kernel      da, over batch rows and chunks.
// No float atomics and no per-head partial of db or dc: every sum has one
// order, so the gradients are the same from run to run.
//
// Arithmetic.  Every product is mma.sync.m16n8k16 with bf16 operands and
// f32 accumulation, as in the forward (ssd_scan.cu).  bf16 inputs x, b, c
// go in as they are.  Operands in f32 -- dy, H, dH', and the matrices built
// in registers (L o G, dG, C o e^s) -- go in as hi + lo bf16 halves with two
// products against a bf16 operand, three when both are split (lo x lo
// dropped); f32 inputs x, b, c are split the same way on the scalar load
// path.  About 16 bits of every operand: the f32 value of each gradient
// stays well inside a bf16 ulp of its rounding.  Per-row factors (e^s, w,
// dt) scale a product's rows after it, not its operand.  The decay matrix
// is 2^((s_t - s_j) log2 e) with the exponent masked to -inf above the
// diagonal and past q before the exponential.  An accumulator tile of two
// n8 halves is, as bf16 pairs, the A operand of the next product (L o G
// into (L o G)^T dY): the per-chunk kernel works in the transposed
// orientation (warp = 16 columns j of the q x q matrices), so dx needs no
// trip through shared memory.
//
// Loads.  On the aligned bf16 path (16-byte-aligned bases and strides, n
// and p multiples of 8) the state pass loads the next chunk's c and e^s by
// cp.async into the second of two stages and its dy slice into registers;
// the db/dc pass keeps the next two heads' dy, x and vectors in flight by
// cp.async (three stages) and the next head's H and dH' rows in registers.
// The per-chunk kernel loads each head's f32 tiles with 16-byte loads, all
// of a thread's at once, then splits them.  f32 inputs and unaligned views
// take element loads.
//
// Bound.  At mamba2-1.3b's training shape (B=4, T=1024, H=64, P=64, N=128,
// q=128, bf16) the gradient must read x, dt, a, b, c and dy (f32) and
// write dx, ddt, da, db and dc: 140.5 MB, 41.9 us at 3.35 TB/s.  It needs
// 30.2 GFLOP (30.6 us at 989 TFLOP/s of bf16), so it is bytes-bound.  This
// design moves beside that hprev (67 MB), dH' written once and read twice
// (201 MB), dy read three times and x twice (the db/dc pass re-reads both
// from L2 for each of its n-slices), and issues ~2x the needed FLOPs for
// the split halves.  Its time goes to the per-chunk kernel's q x q tiles
// (chains of dependent mma.sync products and the elementwise work between
// them, two warps per scheduler), to the db/dc pass's loads, and to the
// latency between a block's phases: see PERF.md for the measured split.
#include <stdint.h>

#include <initializer_list>

#include "ssd_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 128;       // q and n limits: 8 tiles of 16
constexpr int kMaxP = 64;          // p limit: the per-chunk kernel stages (q, p) tiles
constexpr int kSlice = 32;         // p columns (state pass) or n columns (db/dc pass) per block
constexpr int kLdS = kSlice + 8;   // bf16 plane row of a dy slice
constexpr int kDbcWarps = 16;      // warps of the db/dc kernel: 8 row tiles x 2 column halves
constexpr int kDbcThreads = 32 * kDbcWarps;
constexpr int kVecs = 5;           // the scan's vectors per step:
constexpr int kSl = 0, kEs = 1, kWl = 2, kW = 3, kDt = 4;  // s log2 e, e^s, e^(s_last-s), w, dt

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dy;       // (B, T, H, P) contiguous
  const float* dhf;      // (rows, n, p) contiguous, or null for zeros
  const float* hprev;    // (rows / nh, nc, nh, n, p): H of each chunk
  float* dstate;         // (rows / nh, nc, nh, n, p): dH' of each chunk
  void* dx;              // x's type, through strides sdx_*
  float* ddt;            // (B, T, H) through strides sddt_*
  float* dh0;            // (rows, n, p) or null
  float* sv;             // (kVecs, rows, t): the scan's vectors
  float* dsp;            // (3, rows, t): ds and ddt parts of the per-chunk kernel; w b.(dH' x)
  float* qvp;            // (rows, 2 n-slices, t): e^(s_t) c_t.(H dy_t) per 16 columns of n
  float* hsp;            // (rows, nc, n-slices, kDbcWarps): sum(H o dH') per n-slice and warp
  float* dgp;            // (rows / nh, nc, groups, tiles, 256): dG^T per head group
  float* dap;            // (rows, nc)
  void* db;              // (B, T, N) contiguous, b's type
  void* dc;
  float* da;             // (H,) or (rows,)
  int rows, nh, t, q, n, p, a_per_row, na, groups, hg;
  long long sx_b, sx_h, sx_t;
  long long sdt_b, sdt_h, sdt_t;
  long long sa_b, sa_h;
  long long sb_b, sb_t;
  long long sc_b, sc_t;
  long long sdy_b, sdy_h, sdy_t;
  long long sdx_b, sdx_h, sdx_t;
  long long sddt_b, sddt_h, sddt_t;
};

__host__ __device__ inline int tri_tiles(int q) {
  const int qt = round16(q) / 16;
  return qt * (qt + 1) / 2;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Two neighbouring outputs (columns c, c + 1 of one row) in T; paired when
// `pair` (an even c with an aligned, even-width row), else one by one.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float v0, float v1, bool has1, bool pair) {
  if (pair && has1) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = from_f32<T>(v0);
    if (has1) dst[1] = from_f32<T>(v1);
  }
}

// The vectors of one (row, chunk) into shared memory: `which` of the scan's
// vectors, q16 each (0 past q), by threads [tid, tid + nthr).
template <bool kAsync>
__device__ __forceinline__ void load_vecs(float* dst, const BwdArgs& args, long long row,
                                          long long t0, std::initializer_list<int> which,
                                          int q16, int tid, int nthr) {
  int slot = 0;
  for (int v : which) {
    const float* src = args.sv + ((long long)v * args.rows + row) * args.t + t0;
    for (int i = tid; i < q16; i += nthr) {
      if constexpr (kAsync)
        cp_async4(dst + slot * q16 + i, i < args.q ? src + i : src, i < args.q ? 4 : 0);
      else
        dst[slot * q16 + i] = i < args.q ? src[i] : 0.f;
    }
    ++slot;
  }
}

// The chunk steps j = lane * per + u (u < per) of one warp, per = ceil(q / 32).
__device__ __forceinline__ int lane_steps(int q) { return (q + 31) / 32; }

// ------------------------------------------------------------ chunk scans

// One warp per (row, chunk): s = inclusive cumsum of dt * a over the chunk
// (each lane four consecutive steps, then a shuffle scan of the lanes'
// totals: one fixed order) and the vectors the other kernels read.
__global__ void __launch_bounds__(kThreads) ssd_bwd_scan_kernel(const BwdArgs args) {
  const int q = args.q, nc = args.t / q;
  const long long item = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (item >= (long long)args.rows * nc) return;
  const long long row = item / nc, t0 = (item % nc) * q;
  const int bi = (int)(row / args.nh), hi = (int)(row % args.nh);
  const float* dtg = args.dt + bi * args.sdt_b + hi * args.sdt_h;
  const float a = args.a[bi * args.sa_b + hi * args.sa_h];
  const int per = lane_steps(q);
  float d[4], loc[4], run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = lane * per + u;
    d[u] = u < per && j < q ? dtg[(t0 + j) * args.sdt_t] : 0.f;
    run += d[u] * a;
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
  float* out = args.sv + row * args.t + t0;
  const long long plane = (long long)args.rows * args.t;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = lane * per + u;
    if (u < per && j < q) {
      const float s = excl + loc[u], e = expf(s_last - s);
      out[kSl * plane + j] = s * kLog2e;
      out[kEs * plane + j] = expf(s);
      out[kWl * plane + j] = e;
      out[kW * plane + j] = d[u] * e;
      out[kDt * plane + j] = d[u];
    }
  }
}

// ------------------------------------------------------------ state pass

// Shared memory of the state pass: two stages of {c (q16, ldn) bf16, e^s
// (q16) f32} and the hi/lo planes of the dy slice (q16, kLdS).  On the
// scalar path stage 1's c area holds the lo plane of f32 c.  ~90 KB at
// q = n = 128: two blocks per SM.
struct DstateLayout {
  int q16, n16, ldn;
  long long c, es, stage, dyp, total;
  __host__ __device__ DstateLayout(int q, int n) : q16(round16(q)), n16(round16(n)), ldn(n16 + 8) {
    c = 0;
    es = c + 2LL * q16 * ldn;
    stage = es + 4LL * q16;
    dyp = 2 * stage;
    total = dyp + 2 * 2LL * q16 * kLdS;
  }
};

// f32 rows of a 32-column slice held in registers on their way to bf16
// hi/lo planes: kRegs float4 per thread cover kMaxDim rows.
constexpr int kRegs = kMaxDim * kSlice / 4 / kThreads;

template <bool kVec>
__device__ __forceinline__ void slice_to_regs(float4 (&v)[kRegs], const float* src,
                                              long long stride, int rows, int cols) {
#pragma unroll
  for (int u = 0; u < kRegs; ++u) {
    const int i = threadIdx.x + u * kThreads, r = i / (kSlice / 4), c = (i % (kSlice / 4)) * 4;
    if constexpr (kVec) {
      v[u] = r < rows && c < cols ? __ldg(reinterpret_cast<const float4*>(src + r * stride + c))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = r < rows && c + k < cols ? src[r * stride + c + k] : 0.f;
      v[u] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

__device__ __forceinline__ void regs_to_planes(const float4 (&v)[kRegs], bf16* hi, bf16* lo,
                                               int rows_pad) {
#pragma unroll
  for (int u = 0; u < kRegs; ++u) {
    const int i = threadIdx.x + u * kThreads, r = i / (kSlice / 4), c = (i % (kSlice / 4)) * 4;
    if (r >= rows_pad) continue;
    uint2 h, l;
    split2(v[u].x, v[u].y, h.x, l.x);
    split2(v[u].z, v[u].w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * kLdS + c) = h;
    *reinterpret_cast<uint2*>(lo + r * kLdS + c) = l;
  }
}

// One block per (row, slice of p); warp v holds state rows 16v..16v+15 of
// dH (f32, registers) from the last chunk to the first.  Per chunk: dH' out
// (16-byte stores), then dH <- e^(s_last) dH + (C o e^s)^T dY.  The next
// chunk's c and e^s arrive by cp.async and its dy slice in registers while
// this one computes.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dstate_kernel(const BwdArgs args) {
  constexpr int kIn = std::is_same<T, float>::value ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = args.q, n = args.n, p = args.p, nc = args.t / q;
  const DstateLayout lay(q, n);
  const int q16 = lay.q16, n16 = lay.n16, ldn = lay.ldn, qt = q16 / 16, nt = n16 / 16;
  const int slices = (p + kSlice - 1) / kSlice;
  const int row = blockIdx.x / slices, p0 = (blockIdx.x % slices) * kSlice;
  const int pw = min(kSlice, p - p0);
  const int bi = row / args.nh, hi = row % args.nh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const T* cg = static_cast<const T*>(args.c) + bi * args.sc_b;
  const float* dyg = args.dy + bi * args.sdy_b + hi * args.sdy_h + p0;
  const long long np_ = (long long)n * p;

  auto cs = [&](int k) { return reinterpret_cast<bf16*>(smem + k * lay.stage + lay.c); };
  auto ess = [&](int k) { return reinterpret_cast<float*>(smem + k * lay.stage + lay.es); };
  bf16* dyp[2] = {reinterpret_cast<bf16*>(smem + lay.dyp),
                  reinterpret_cast<bf16*>(smem + lay.dyp) + q16 * kLdS};

  // chunk ci's c (planes) and e^s into stage k, its dy slice into vdy
  float4 vdy[kRegs];
  auto load_c = [&](int ci, int k) {
    const long long t0 = (long long)ci * q;
    load_vecs<kAsync>(ess(k), args, row, t0, {kEs}, q16, threadIdx.x, kThreads);
    load_tile<T, kAsync, kMaxDim>(cs(k), cs(1), ldn, cg + t0 * args.sc_t, args.sc_t, q, n, q16,
                                  n16, threadIdx.x, kThreads);
    if constexpr (kAsync) cp_async_commit();
  };
  auto load_dy = [&](int ci) {
    slice_to_regs<kAsync>(vdy, dyg + (long long)ci * q * args.sdy_t, args.sdy_t, q, pw);
  };

  const bool has_n = warp < nt;
  const int nr = 16 * warp + g;  // this warp's state rows nr, nr + 8
  float acc[4][4] = {};
  if (has_n && args.dhf) {
    const float* src = args.dhf + (long long)row * np_ + p0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nr + (e >> 1) * 8, c = 8 * j + 2 * t4 + (e & 1);
        if (r < n && c < pw) acc[j][e] = src[(long long)r * p + c];
      }
  }
  load_c(nc - 1, 0);
  load_dy(nc - 1);
  regs_to_planes(vdy, dyp[0], dyp[1], q16);
  if constexpr (kAsync) cp_async_wait<0>();
  __syncthreads();

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int k = kAsync ? (nc - 1 - ci) & 1 : 0;
    // the next chunk on its way (on the scalar path c follows this chunk)
    if (ci > 0) {
      if constexpr (kAsync) load_c(ci - 1, k ^ 1);
      load_dy(ci - 1);
    }
    const bf16* c_[2] = {cs(k), cs(1)};
    const float* es = ess(k);
    if (has_n) {
      // dH' of this chunk: lanes t4 and t4 ^ 1 swap halves, so that each
      // holds 4 columns of one row
      float* out = args.dstate + (((long long)bi * nc + ci) * args.nh + hi) * np_ + p0;
      const bool odd = t4 & 1;
      const int r4 = nr + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
        const float4 v = odd ? make_float4(s0, s1, acc[j][2], acc[j][3])
                             : make_float4(acc[j][0], acc[j][1], s0, s1);
        const int col = 8 * j + 2 * (t4 & 2);
        if (r4 >= n || col >= pw) continue;
        float* dst = out + (long long)r4 * p + col;
        if (p % 4 == 0) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
          for (int e = 0; e < 4 && col + e < pw; ++e) dst[e] = vs[e];
        }
      }
      // dH = e^(s_last) dH + (C o e^s)^T dY: A = (C o e^s)^T (state rows,
      // k = time) from c by ldmatrix.trans, scaled and split; B = dY.
      const float decay = es[q - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= decay;
#pragma unroll 1
      for (int kt = 0; kt < qt; ++kt) {
        uint32_t craw[kIn][4];
        const int off = (16 * kt + (lane & 7) + (lane >> 4) * 8) * ldn + 16 * warp +
                        ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int u = 0; u < kIn; ++u) ldsm_x4_t(craw[u], c_[u] + off);
        const float2 e0 = *reinterpret_cast<const float2*>(es + 16 * kt + 2 * t4);
        const float2 e1 = *reinterpret_cast<const float2*>(es + 16 * kt + 8 + 2 * t4);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float2 f = unpack(craw[0][u]);
          if constexpr (kIn == 2) {
            const float2 lo = unpack(craw[1][u]);
            f.x += lo.x;
            f.y += lo.y;
          }
          const float2 ev = u < 2 ? e0 : e1;
          split2(f.x * ev.x, f.y * ev.y, ah[u], al[u]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t yb[2][4];
          const int yoff = (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdS + 16 * np +
                           (lane >> 4) * 8;
          ldsm_x4_t(yb[0], dyp[0] + yoff);
          ldsm_x4_t(yb[1], dyp[1] + yoff);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float(&d)[4] = acc[2 * np + h2];
            mma(d, ah, yb[0][2 * h2], yb[0][2 * h2 + 1]);
            mma(d, al, yb[0][2 * h2], yb[0][2 * h2 + 1]);
            mma(d, ah, yb[1][2 * h2], yb[1][2 * h2 + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this chunk's planes and stage
    if (ci > 0) {
      if constexpr (!kAsync) load_c(ci - 1, 0);
      regs_to_planes(vdy, dyp[0], dyp[1], q16);
      if constexpr (kAsync) cp_async_wait<0>();
      __syncthreads();
    }
  }
  if (has_n && args.dh0) {
    float* out = args.dh0 + (long long)row * np_ + p0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nr + (e >> 1) * 8, c = 8 * j + 2 * t4 + (e & 1);
        if (r < n && c < pw) out[(long long)r * p + c] = acc[j][e];
      }
  }
}

// ------------------------------------------------------- per-chunk pass

// Shared memory of the per-chunk kernel: an area that first holds the b and
// c planes (hi, and lo for f32) and then, per head, the x planes, the hi/lo
// planes of dy (q16, ldp) and dH' (n16, ldp) and the exchange of the warp
// pairs (kXch floats each); the G^T tiles and the group's dG^T tiles (f32,
// each lane's 8 values together); two sets (by head parity) of a head's
// kChunkVecs vectors; colsum and b.(dH' x) (q16 each); two sets of the warps'
// column sums of P (kWarps x q16).
constexpr int kXch = 34 * 32;  // a warp's dx1 partial (32 floats) and colsum partial (2), per lane
constexpr int kChunkVecs = 4;  // s log2(e), e^(s_last - s), w, dt of a head
struct ChunkLayout {
  int q16, n16, p16, ldn, ldp, tiles;
  long long bp, cp, xp, dyp, dhp, xch, area, gt, dgs, vec, red, total;
  __host__ __device__ ChunkLayout(int q, int n, int p, int parts)
      : q16(round16(q)), n16(round16(n)), p16(round16(p)), ldn(n16 + 8), ldp(p16 + 8),
        tiles(tri_tiles(q)) {
    bp = 0;
    cp = bp + 2LL * parts * q16 * ldn;
    xp = 0;
    dyp = xp + 2LL * parts * q16 * ldp;
    dhp = dyp + 2 * 2LL * q16 * ldp;
    xch = dhp + 2 * 2LL * n16 * ldp;
    const long long setup = cp + 2LL * parts * q16 * ldn, head = xch + 4LL * 4 * kXch;
    area = setup > head ? setup : head;
    gt = area;
    dgs = gt + 1024LL * tiles;
    vec = dgs + 1024LL * tiles;
    red = vec + 4LL * (2 * kChunkVecs + 2) * q16;
    total = red + 2 * 4LL * kWarps * q16;
  }
};

// One block per (batch, chunk, group of heads).  Warp w owns the 16 columns
// j of tile mj (mj = w for w < 4, 11 - w after): it computes G^T's tiles
// (mj, kt >= mj) at the start and holds B's rows j.  Per head, warps w and
// w + 4 (one scheduler) work through the row tiles of their two j-tiles in
// turn; see the header.  The warps then sum their column sums of P into
// rowsum(P) and write the head's parts of ds and ddt (dsp), 16 steps each.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(const BwdArgs args) {
  constexpr int kIn = std::is_same<T, float>::value ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = args.q, n = args.n, p = args.p, nc = args.t / q, nh = args.nh;
  const ChunkLayout lay(q, n, p, kIn);
  const int q16 = lay.q16, n16 = lay.n16, p16 = lay.p16, ldn = lay.ldn, ldp = lay.ldp;
  const int qt = q16 / 16, nt = n16 / 16, pt = p16 / 16;
  const int grp = blockIdx.x % args.groups, chunk = blockIdx.x / args.groups;
  const int bi = chunk / nc, ci = chunk % nc;
  const int h_lo = grp * args.hg, h_hi = min(nh, h_lo + args.hg);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  // The warps of scheduler s4 (s4 and s4 + 4) share j-tiles s4 and 7 - s4:
  // their t-tiles alternate between the two, and the warp whose own j-tile
  // it is (mj) adds the other's dx1 partial and finishes the rows.
  const int s4 = warp & 3, role = warp >> 2;
  const int mj = role ? 7 - s4 : s4;
  const bool has_j = mj < qt;
  const long long t0 = (long long)ci * q;

  bf16* bpl[2] = {reinterpret_cast<bf16*>(smem + lay.bp),
                  reinterpret_cast<bf16*>(smem + lay.bp) + q16 * ldn};
  bf16* cpl[2] = {reinterpret_cast<bf16*>(smem + lay.cp),
                  reinterpret_cast<bf16*>(smem + lay.cp) + q16 * ldn};
  bf16* xpl[2] = {reinterpret_cast<bf16*>(smem + lay.xp),
                  reinterpret_cast<bf16*>(smem + lay.xp) + q16 * ldp};
  bf16* dypl[2] = {reinterpret_cast<bf16*>(smem + lay.dyp),
                   reinterpret_cast<bf16*>(smem + lay.dyp) + q16 * ldp};
  bf16* dhpl[2] = {reinterpret_cast<bf16*>(smem + lay.dhp),
                   reinterpret_cast<bf16*>(smem + lay.dhp) + n16 * ldp};
  float* gts = reinterpret_cast<float*>(smem + lay.gt);
  float* dgs = reinterpret_cast<float*>(smem + lay.dgs);
  float* colg = reinterpret_cast<float*>(smem + lay.vec) + 2 * kChunkVecs * q16;
  float* t2v = colg + q16;
  float* xch = reinterpret_cast<float*>(smem + lay.xch) + s4 * kXch;

  // Setup: b and c of the chunk; G^T = B C^T on this warp's tiles (mj, kt
  // >= mj), the A fragments of B's rows j kept for B dH'; dG^T zeroed.
  load_tile<T, kAsync, kMaxDim>(bpl[0], bpl[1], ldn,
                                static_cast<const T*>(args.b) + bi * args.sb_b + t0 * args.sb_t,
                                args.sb_t, q, n, q16, n16, threadIdx.x, kThreads);
  load_tile<T, kAsync, kMaxDim>(cpl[0], cpl[1], ldn,
                                static_cast<const T*>(args.c) + bi * args.sc_b + t0 * args.sc_t,
                                args.sc_t, q, n, q16, n16, threadIdx.x, kThreads);
  if constexpr (kAsync) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  for (int i = threadIdx.x; i < 256 * lay.tiles; i += kThreads) dgs[i] = 0.f;
  __syncthreads();
  uint32_t bfr[kIn][kMaxDim / 16][4];
  if (has_j) {
#pragma unroll
    for (int kk = 0; kk < kMaxDim / 16; ++kk) {
      if (kk >= nt) break;
#pragma unroll
      for (int u = 0; u < kIn; ++u)
        ldsm_x4(bfr[u][kk], bpl[u] + (16 * mj + (lane & 15)) * ldn + 16 * kk + (lane >> 4) * 8);
    }
    for (int kt = mj; kt < qt; ++kt) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kMaxDim / 16; ++kk) {
        if (kk >= nt) break;
        uint32_t cb[kIn][4];
#pragma unroll
        for (int u = 0; u < kIn; ++u)
          ldsm_x4(cb[u], cpl[u] + (16 * kt + (lane & 7) + (lane >> 4) * 8) * ldn + 16 * kk +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mma(acc[h2], bfr[0][kk], cb[0][2 * h2], cb[0][2 * h2 + 1]);
          if constexpr (kIn == 2) {
            mma(acc[h2], bfr[0][kk], cb[1][2 * h2], cb[1][2 * h2 + 1]);
            mma(acc[h2], bfr[1][kk], cb[0][2 * h2], cb[0][2 * h2 + 1]);
          }
        }
      }
      float4* dst = reinterpret_cast<float4*>(gts + ((kt * (kt + 1) / 2 + mj) * 32 + lane) * 8);
      dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      dst[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
  }
  __syncthreads();  // the area now takes the heads' tiles

  // An f32 (rows, p) tile split into hi/lo planes: 16-byte loads, all of a
  // thread's issued before the first is split (aligned path), or element
  // loads.
  auto split_f32 = [&](bf16* const (&pl)[2], const float* src, long long stride, int rows,
                       int rows_pad) {
    if constexpr (kAsync) {
      constexpr int kPer = kMaxDim * kMaxP / 4 / kThreads;
      float4 v[kPer];
      const int per_row = p16 / 4;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * kThreads, r = i / per_row, c = (i % per_row) * 4;
        v[u] = r < rows && c < p ? __ldg(reinterpret_cast<const float4*>(src + r * stride + c))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * kThreads, r = i / per_row, c = (i % per_row) * 4;
        if (r >= rows_pad) continue;
        uint2 h, l;
        split2(v[u].x, v[u].y, h.x, l.x);
        split2(v[u].z, v[u].w, h.y, l.y);
        *reinterpret_cast<uint2*>(pl[0] + r * ldp + c) = h;
        *reinterpret_cast<uint2*>(pl[1] + r * ldp + c) = l;
      }
    } else {
      for (int i = threadIdx.x; i < rows_pad * p16; i += kThreads) {
        const int r = i / p16, c = i % p16;
        const float v = r < rows && c < p ? src[r * stride + c] : 0.f;
        const bf16 h = __float2bfloat16_rn(v);
        pl[0][r * ldp + c] = h;
        pl[1][r * ldp + c] = __float2bfloat16_rn(v - __bfloat162float(h));
      }
    }
  };

  for (int hi = h_lo; hi < h_hi; ++hi) {
    const long long row = (long long)bi * nh + hi;
    float* vk = reinterpret_cast<float*>(smem + lay.vec) + ((hi - h_lo) & 1) * kChunkVecs * q16;
    const float *sl = vk, *wl = vk + q16, *wv = vk + 2 * q16, *dts = vk + 3 * q16;

    // This head's tiles: x (as is, or split), dy and dH' split into planes,
    // and its vectors.
    load_tile<T, kAsync, kMaxP>(xpl[0], xpl[1], ldp,
                                static_cast<const T*>(args.x) + bi * args.sx_b + hi * args.sx_h +
                                    t0 * args.sx_t,
                                args.sx_t, q, p, q16, p16, threadIdx.x, kThreads);
    load_vecs<kAsync>(vk, args, row, t0, {kSl, kWl, kW, kDt}, q16, threadIdx.x, kThreads);
    if constexpr (kAsync) cp_async_commit();
    for (int i = lane; i < q16; i += 32)
      reinterpret_cast<float*>(smem + lay.red)[(((hi - h_lo) & 1) * kWarps + warp) * q16 + i] = 0.f;
    split_f32(dypl, args.dy + bi * args.sdy_b + hi * args.sdy_h + t0 * args.sdy_t, args.sdy_t,
              q, q16);
    split_f32(dhpl, args.dstate + (((long long)bi * nc + ci) * nh + hi) * n * p, p, n, n16);
    if constexpr (kAsync) cp_async_wait<0>();
    __syncthreads();

    float* red = reinterpret_cast<float*>(smem + lay.red) + ((hi - h_lo) & 1) * kWarps * q16;
#pragma unroll 1
    for (int ph = 0; ph < 2; ++ph) {
      const int J = ph ? 7 - s4 : s4;  // this phase's j-tile; warp role ph finishes it
      if (J >= qt) continue;
      float dx1[kMaxP / 8][4] = {};
      float cgp[2] = {0.f, 0.f};  // colsum partials of rows j = 16 J + g (+8)
      const int jr[2] = {16 * J + g, 16 * J + g + 8};
      const float slj[2] = {sl[jr[0]], sl[jr[1]]}, dtj[2] = {dts[jr[0]], dts[jr[1]]};
#pragma unroll 1
      for (int kt = J + role; kt < qt; kt += 2) {
        // (dY X^T)^T tile (rows j, columns t): A = X rows j, B = dY rows t;
        // the products with dY's hi and lo halves in separate accumulators
        float yh[2][4] = {}, yl[2][4] = {};
#pragma unroll
        for (int pk = 0; pk < kMaxP / 16; ++pk) {
          if (pk >= pt) break;
          uint32_t xa[kIn][4], yb[2][4];
#pragma unroll
          for (int u = 0; u < kIn; ++u)
            ldsm_x4(xa[u], xpl[u] + (16 * J + (lane & 15)) * ldp + 16 * pk + (lane >> 4) * 8);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            ldsm_x4(yb[u], dypl[u] + (16 * kt + (lane & 7) + (lane >> 4) * 8) * ldp + 16 * pk +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            mma(yh[h2], xa[0], yb[0][2 * h2], yb[0][2 * h2 + 1]);
            mma(yl[h2], xa[0], yb[1][2 * h2], yb[1][2 * h2 + 1]);
            if constexpr (kIn == 2) mma(yl[h2], xa[1], yb[0][2 * h2], yb[0][2 * h2 + 1]);
          }
        }
        const int tile = kt * (kt + 1) / 2 + J;
        const float4* gsrc = reinterpret_cast<const float4*>(gts + (tile * 32 + lane) * 8);
        const float4 g0 = gsrc[0], g1 = gsrc[1];
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const int c0 = 16 * kt + 2 * t4;
        const float2 st[2] = {*reinterpret_cast<const float2*>(sl + c0),
                              *reinterpret_cast<const float2*>(sl + c0 + 8)};
        float lg[8], dg[8], rp[2][2] = {};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int rh = (e >> 1) & 1, ch = e >> 2, cl = e & 1;
          const float yv = yh[ch][e & 3] + yl[ch][e & 3];
          const float stv = cl ? st[ch].y : st[ch].x;
          float arg = stv - slj[rh];
          const int tc = c0 + 8 * ch + cl;  // L = 0 above the diagonal and past q
          if ((kt == J && tc < jr[rh]) || tc >= q) arg = __uint_as_float(0xff800000u);
          const float l = fast_exp2(arg);
          lg[e] = l * gv[e];
          dg[e] = l * dtj[rh] * yv;
          cgp[rh] += lg[e] * yv;
          rp[ch][cl] += gv[e] * dg[e];
        }
        // dG^T summed over the group's heads, in order
        float4* dgt = reinterpret_cast<float4*>(dgs + (tile * 32 + lane) * 8);
        float4 d0 = dgt[0], d1 = dgt[1];
        d0.x += dg[0], d0.y += dg[1], d0.z += dg[2], d0.w += dg[3];
        d1.x += dg[4], d1.y += dg[5], d1.z += dg[6], d1.w += dg[7];
        dgt[0] = d0, dgt[1] = d1;
        // column sums of P over this tile's 16 rows j, added to this warp's
        // (its rows zeroed with the head's loads)
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int cl = 0; cl < 2; ++cl) {
            float v = rp[ch][cl];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) red[warp * q16 + c0 + 8 * ch + cl] += v;
          }
        // dx1 += (L o G)^T dY over this tile's t: A = the tile split, B = dY^T
        uint32_t lh[4], ll[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split2(lg[2 * u], lg[2 * u + 1], lh[u], ll[u]);
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (np >= pt) break;
          uint32_t yt[2][4];
          const int off = (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8) * ldp + 16 * np +
                          (lane >> 4) * 8;
          ldsm_x4_t(yt[0], dypl[0] + off);
          ldsm_x4_t(yt[1], dypl[1] + off);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float(&d)[4] = dx1[2 * np + h2];
            mma(d, lh, yt[0][2 * h2], yt[0][2 * h2 + 1]);
            mma(d, ll, yt[0][2 * h2], yt[0][2 * h2 + 1]);
            mma(d, lh, yt[1][2 * h2], yt[1][2 * h2 + 1]);
          }
        }
      }
      // The pair's partials meet: the other warp leaves its dx1 and colsum
      // partials in the exchange, the finishing warp adds them, role 0's
      // first, after a barrier of the two warps.
      if (role != ph) {
#pragma unroll
        for (int j = 0; j < kMaxP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xch[(4 * j + e) * 32 + lane] = dx1[j][e];
        xch[32 * 32 + lane] = cgp[0];
        xch[33 * 32 + lane] = cgp[1];
      }
      asm volatile("bar.sync %0, 64;\n" :: "r"(1 + s4) : "memory");
      if (role != ph) continue;
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float o = xch[(4 * j + e) * 32 + lane];
          dx1[j][e] = role ? o + dx1[j][e] : dx1[j][e] + o;
        }
      {
        const float o0 = xch[32 * 32 + lane], o1 = xch[33 * 32 + lane];
        cgp[0] = role ? o0 + cgp[0] : cgp[0] + o0;
        cgp[1] = role ? o1 + cgp[1] : cgp[1] + o1;
      }
      // dx2 = B dH' (rows j, k = n); B's fragments are this warp's (J = mj)
      float dx2[kMaxP / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kMaxDim / 16; ++kk) {
        if (kk >= nt) break;
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (np >= pt) break;
          uint32_t hb[2][4];
          const int off = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldp + 16 * np +
                          (lane >> 4) * 8;
          ldsm_x4_t(hb[0], dhpl[0] + off);
          ldsm_x4_t(hb[1], dhpl[1] + off);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float(&d)[4] = dx2[2 * np + h2];
            mma(d, bfr[0][kk], hb[0][2 * h2], hb[0][2 * h2 + 1]);
            mma(d, bfr[0][kk], hb[1][2 * h2], hb[1][2 * h2 + 1]);
            if constexpr (kIn == 2) mma(d, bfr[1][kk], hb[0][2 * h2], hb[0][2 * h2 + 1]);
          }
        }
      }
      // dx = dt o dx1 + w o dx2 and t2_j = x_j . dx2_j
      T* dxg = static_cast<T*>(args.dx) + bi * args.sdx_b + hi * args.sdx_h + t0 * args.sdx_t;
      const bool pair = p % 2 == 0;
      float t2p[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j) {
        if (j >= 2 * pt) break;
        const int c = 8 * j + 2 * t4;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = jr[rh];
          float2 xv = unpack(*reinterpret_cast<const uint32_t*>(xpl[0] + r * ldp + c));
          if constexpr (kIn == 2) {
            const float2 lo = unpack(*reinterpret_cast<const uint32_t*>(xpl[1] + r * ldp + c));
            xv.x += lo.x;
            xv.y += lo.y;
          }
          const float v0 = dx2[j][2 * rh], v1 = dx2[j][2 * rh + 1];
          t2p[rh] += xv.x * v0 + xv.y * v1;
          if (r < q && c < p)
            store2(dxg + r * args.sdx_t + c, dts[r] * dx1[j][2 * rh] + wv[r] * v0,
                   dts[r] * dx1[j][2 * rh + 1] + wv[r] * v1, c + 1 < p, pair);
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float cgv = cgp[rh], t2 = t2p[rh];
        cgv += __shfl_xor_sync(0xffffffffu, cgv, 1);
        cgv += __shfl_xor_sync(0xffffffffu, cgv, 2);
        t2 += __shfl_xor_sync(0xffffffffu, t2, 1);
        t2 += __shfl_xor_sync(0xffffffffu, t2, 2);
        if (t4 == 0) {
          colg[jr[rh]] = cgv;
          t2v[jr[rh]] = t2;
        }
      }
    }
    __syncthreads();  // red, colg, t2 in place; the planes are free

    {
      // ds without qv, e^(s_last) sum(H o dH') and sum_j w_j t2_j, ddt
      // without a dla, and w t2 (its sum is the tail kernel's): step t =
      // 16 warp + lane of the first 16 lanes; rowsum(P) over the warps in order
      const int t = 16 * warp + lane;
      if (lane < 16 && t < q) {
        float rowp = 0.f;
        for (int w2 = 0; w2 < kWarps; ++w2) rowp += red[w2 * q16 + t];
        const long long plane = (long long)args.rows * args.t;
        float* dsg = args.dsp + row * args.t + t0 + t;
        dsg[0] = rowp - dts[t] * colg[t] - wv[t] * t2v[t];
        dsg[plane] = colg[t] + wl[t] * t2v[t];
        dsg[2 * plane] = wv[t] * t2v[t];
      }
    }
  }

  // The group's dG^T tiles out
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(
      args.dgp + ((long long)chunk * args.groups + grp) * lay.tiles * 256);
  const float4* src = reinterpret_cast<const float4*>(dgs);
  for (int i = threadIdx.x; i < 64 * lay.tiles; i += kThreads) out[i] = src[i];
}

// ------------------------------------------------------------ db/dc pass

// Shared memory of the db/dc kernel: the b and c columns of the slice (q16,
// kSlice) in their type; kStages stages (one on the scalar path) of {dy
// (q16, ldp) f32, the x planes (q16, ldp), e^s and w (q16 each) f32}, which
// after the heads take dG (q16, q16 + 4) f32; the hi/lo planes of the H
// and dH' slices (kSlice, ldp).
constexpr int kStages = 3;
struct DbcLayout {
  int q16, p16, ldp, ldg;
  long long bcol, ccol, s0, dy, x, vec, stage, dg, hp, total;
  __host__ __device__ DbcLayout(int q, int p, int parts, int tsize, int stages)
      : q16(round16(q)), p16(round16(p)), ldp(p16 + 8), ldg(q16 + 4) {
    bcol = 0;
    ccol = bcol + (long long)tsize * q16 * kSlice;
    s0 = ccol + (long long)tsize * q16 * kSlice;
    dy = 0;
    x = dy + 4LL * q16 * ldp;
    vec = x + 2LL * parts * q16 * ldp;
    stage = vec + 2 * 4LL * q16;
    dg = s0;
    const long long stages_end = s0 + stages * stage, dg_end = dg + 4LL * q16 * ldg;
    hp = stages_end > dg_end ? stages_end : dg_end;
    total = hp + 4 * 2LL * kSlice * ldp;
  }
};

// Rows [0, rows_pad) x columns [0, p16) of an f32 (rows, p) tile into an
// f32 area (row stride ld), zero past rows x p: 16-byte cp.async (source
// 16-byte aligned, p a multiple of 4) or element loads.
template <bool kAsync>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src,
                                              long long stride, int rows, int rows_pad, int p,
                                              int p16) {
  constexpr int kPer = kMaxP / 4;
  for (int i = threadIdx.x; i < rows_pad * kPer; i += kDbcThreads) {
    const int r = i / kPer, c = (i % kPer) * 4;
    if (c >= p16) continue;
    if constexpr (kAsync) {
      const bool ok = r < rows && c < p;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[r * ld + c + e] = r < rows && c + e < p ? src[r * stride + c + e] : 0.f;
    }
  }
}

// The kSlice rows x p columns of an f32 (rows, p) tile in registers: kHRegs
// float4 per thread (16-byte loads on the aligned path), 0 past rows x p.
constexpr int kHRegs = kSlice * kMaxP / 4 / kDbcThreads;
template <bool kVec>
__device__ __forceinline__ void rows_to_regs(float4 (&v)[kHRegs], const float* src, int rows,
                                             int p) {
#pragma unroll
  for (int u = 0; u < kHRegs; ++u) {
    const int i = threadIdx.x + u * kDbcThreads, r = i / (kMaxP / 4), c = (i % (kMaxP / 4)) * 4;
    if constexpr (kVec) {
      v[u] = r < rows && c < p ? __ldg(reinterpret_cast<const float4*>(src + (long long)r * p + c))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        e[k] = r < rows && c + k < p ? src[(long long)r * p + c + k] : 0.f;
      v[u] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

// One block of 16 warps per (batch, chunk, 32 columns of n).  Warp w holds
// rows 16 (w % 8).. of dC (time t) and dB (time j) for 16 of the slice's
// columns (16 (w / 8)..) in registers over every head of the batch row in
// order: per head the products dY H^T (A =
// dY split) and X dH'^T (A = x as it is, by ldmatrix), scaled by e^(s_t)
// and w_j as they are added; dY H^T's row dot with c gives the head's qv
// over the slice, and the H and dH' rows give sum(H o dH') over them.  dy,
// x and the vectors of the next two heads load by cp.async while a head
// computes, its H and dH' rows into registers.  Then adds (sum dG) B and
// (sum dG)^T C and writes db and dc.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kDbcThreads, 1) ssd_bwd_dbc_kernel(const BwdArgs args) {
  constexpr int kIn = std::is_same<T, float>::value ? 2 : 1;
  constexpr int kS = kAsync ? kStages : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = args.q, n = args.n, p = args.p, nc = args.t / q, nh = args.nh;
  const DbcLayout lay(q, p, kIn, sizeof(T), kS);
  const int q16 = lay.q16, p16 = lay.p16, ldp = lay.ldp, qt = q16 / 16, pt = p16 / 16;
  const int nslices = (n + kSlice - 1) / kSlice;
  const int ns = blockIdx.x % nslices, chunk = blockIdx.x / nslices;
  const int bi = chunk / nc, ci = chunk % nc, n0 = ns * kSlice, nw = min(kSlice, n - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int rt = warp % 8, half = warp / 8;  // row tile, and columns 16 half.. of the slice
  const long long t0 = (long long)ci * q;
  const bool has_r = rt < qt;
  const int r0 = 16 * rt + g;

  T* bcol = reinterpret_cast<T*>(smem + lay.bcol);
  T* ccol = reinterpret_cast<T*>(smem + lay.ccol);
  auto stage = [&](int k) { return smem + lay.s0 + k * lay.stage; };
  auto dys = [&](int k) { return reinterpret_cast<float*>(stage(k) + lay.dy); };
  auto xs = [&](int k) { return reinterpret_cast<bf16*>(stage(k) + lay.x); };
  auto vecs = [&](int k) { return reinterpret_cast<float*>(stage(k) + lay.vec); };
  bf16* hpl = reinterpret_cast<bf16*>(smem + lay.hp);  // H hi, H lo, dH' hi, dH' lo

  // Head hi's dy (f32), x (its bf16 planes), e^s and w into stage k.
  auto load_head = [&](int hi, int k) {
    load_vecs<kAsync>(vecs(k), args, (long long)bi * nh + hi, t0, {kEs, kW}, q16, threadIdx.x,
                      kDbcThreads);
    load_rows_f32<kAsync>(dys(k), ldp,
                          args.dy + bi * args.sdy_b + hi * args.sdy_h + t0 * args.sdy_t,
                          args.sdy_t, q, q16, p, p16);
    load_tile<T, kAsync, kMaxP>(xs(k), xs(k) + q16 * ldp, ldp,
                                static_cast<const T*>(args.x) + bi * args.sx_b + hi * args.sx_h +
                                    t0 * args.sx_t,
                                args.sx_t, q, p, q16, p16, threadIdx.x, kDbcThreads);
    if constexpr (kAsync) cp_async_commit();
  };
  // Head hi's H and dH' rows n0.. into registers; then into the planes,
  // with this warp's part of sum(H o dH') written out.
  float4 vh[kHRegs], vd[kHRegs];
  auto hrows_to_regs = [&](int hi) {
    const long long soff = (((long long)bi * nc + ci) * nh + hi) * n * p + (long long)n0 * p;
    rows_to_regs<kAsync>(vh, args.hprev + soff, nw, p);
    rows_to_regs<kAsync>(vd, args.dstate + soff, nw, p);
  };
  auto hregs_to_planes = [&](int hi) {
    float hsum = 0.f;
#pragma unroll
    for (int u = 0; u < kHRegs; ++u) {
      const int i = threadIdx.x + u * kDbcThreads, r = i / (kMaxP / 4), c = (i % (kMaxP / 4)) * 4;
      hsum += vh[u].x * vd[u].x + vh[u].y * vd[u].y + vh[u].z * vd[u].z + vh[u].w * vd[u].w;
      if (c >= p16) continue;
      uint2 h, l;
      bf16* pl = hpl + r * ldp + c;
      split2(vh[u].x, vh[u].y, h.x, l.x);
      split2(vh[u].z, vh[u].w, h.y, l.y);
      *reinterpret_cast<uint2*>(pl) = h;
      *reinterpret_cast<uint2*>(pl + kSlice * ldp) = l;
      split2(vd[u].x, vd[u].y, h.x, l.x);
      split2(vd[u].z, vd[u].w, h.y, l.y);
      *reinterpret_cast<uint2*>(pl + 2 * kSlice * ldp) = h;
      *reinterpret_cast<uint2*>(pl + 3 * kSlice * ldp) = l;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) hsum += __shfl_xor_sync(0xffffffffu, hsum, off);
    if (lane == 0)
      args.hsp[((((long long)bi * nh + hi) * nc + ci) * nslices + ns) * kDbcWarps + warp] = hsum;
  };

  if constexpr (kAsync) {
    for (int s = 0; s < kS - 1 && s < nh; ++s) load_head(s, s);
  }
  hrows_to_regs(0);
  {  // the slice's b and c columns
    const T* bg = static_cast<const T*>(args.b) + bi * args.sb_b + t0 * args.sb_t + n0;
    const T* cg = static_cast<const T*>(args.c) + bi * args.sc_b + t0 * args.sc_t + n0;
    for (int i = threadIdx.x; i < q16 * kSlice; i += kDbcThreads) {
      const int r = i / kSlice, c = i % kSlice;
      const bool ok = r < q && c < nw;
      bcol[i] = ok ? bg[r * args.sb_t + c] : from_f32<T>(0.f);
      ccol[i] = ok ? cg[r * args.sc_t + c] : from_f32<T>(0.f);
    }
  }
  hregs_to_planes(0);
  __syncthreads();
  float cv[2][4] = {};  // c at this lane's accumulator positions (rows r0, r0 + 8)
  if (has_r) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cv[j][e] =
            to_f32(ccol[(r0 + (e >> 1) * 8) * kSlice + 16 * half + 8 * j + 2 * t4 + (e & 1)]);
  }

  float dcc[2][4] = {}, dbb[2][4] = {};
  for (int hi = 0; hi < nh; ++hi) {
    const long long row = (long long)bi * nh + hi;
    const int k = hi % kS;
    if constexpr (kAsync) {
      if (hi + 1 < nh)
        cp_async_wait<kStages - 2>();  // head hi's group landed, the next still on its way
      else
        cp_async_wait<0>();
      __syncthreads();  // stage k and the planes in place; stage (hi - 1) % kS free
      if (hi + kS - 1 < nh) load_head(hi + kS - 1, (hi + kS - 1) % kS);
    } else {
      __syncthreads();
      load_head(hi, 0);
      __syncthreads();
    }
    if (hi + 1 < nh) hrows_to_regs(hi + 1);

    if (has_r) {
      const float* dy = dys(k);
      const bf16* x_[2] = {xs(k), xs(k) + q16 * ldp};
      float qa[2][4] = {}, pa[2][4] = {};  // this head's dY H^T and X dH'^T
#pragma unroll
      for (int pk = 0; pk < kMaxP / 16; ++pk) {
        if (pk >= pt) break;
        uint32_t yh[4], yl[4], xa[kIn][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + (u & 1) * 8, c = 16 * pk + 2 * t4 + (u >> 1) * 8;
          const float2 yv = *reinterpret_cast<const float2*>(dy + r * ldp + c);
          split2(yv.x, yv.y, yh[u], yl[u]);
        }
#pragma unroll
        for (int u = 0; u < kIn; ++u)
          ldsm_x4(xa[u], x_[u] + (16 * rt + (lane & 15)) * ldp + 16 * pk + (lane >> 4) * 8);
        {
          uint32_t hb[2][4], db_[2][4];
          const int off = (16 * half + (lane & 7) + (lane >> 4) * 8) * ldp + 16 * pk +
                          ((lane >> 3) & 1) * 8;
          ldsm_x4(hb[0], hpl + off);
          ldsm_x4(hb[1], hpl + kSlice * ldp + off);
          ldsm_x4(db_[0], hpl + 2 * kSlice * ldp + off);
          ldsm_x4(db_[1], hpl + 3 * kSlice * ldp + off);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float(&qv)[4] = qa[h2];
            mma(qv, yh, hb[0][2 * h2], hb[0][2 * h2 + 1]);
            mma(qv, yl, hb[0][2 * h2], hb[0][2 * h2 + 1]);
            mma(qv, yh, hb[1][2 * h2], hb[1][2 * h2 + 1]);
            float(&pv)[4] = pa[h2];
            mma(pv, xa[0], db_[0][2 * h2], db_[0][2 * h2 + 1]);
            mma(pv, xa[0], db_[1][2 * h2], db_[1][2 * h2 + 1]);
            if constexpr (kIn == 2) mma(pv, xa[1], db_[0][2 * h2], db_[0][2 * h2 + 1]);
          }
        }
      }
      const float* es = vecs(k);
      const float* wv = es + q16;
      const float e_[2] = {es[r0], es[r0 + 8]}, w_[2] = {wv[r0], wv[r0 + 8]};
      float qd[2] = {0.f, 0.f};  // c_t . (dY H^T)_t over the warp's 16 columns
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qd[e >> 1] += cv[j][e] * qa[j][e];
          dcc[j][e] += e_[e >> 1] * qa[j][e];
          dbb[j][e] += w_[e >> 1] * pa[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qd[h] += __shfl_xor_sync(0xffffffffu, qd[h], 1);
        qd[h] += __shfl_xor_sync(0xffffffffu, qd[h], 2);
        const int r = r0 + 8 * h;
        if (t4 == 0 && r < q)
          args.qvp[(row * 2 * nslices + 2 * ns + half) * args.t + t0 + r] = e_[h] * qd[h];
      }
    }
    if (hi + 1 < nh) {
      __syncthreads();  // every warp is done with the planes
      hregs_to_planes(hi + 1);
    }
  }

  // dG summed over the head groups in order, dense (rows j, columns t)
  __syncthreads();  // every warp is done with the stages
  float* dgd = reinterpret_cast<float*>(smem + lay.dg);
  const int tiles = tri_tiles(q), ldg = lay.ldg;
  for (int i = threadIdx.x; i < q16 * ldg; i += kDbcThreads) dgd[i] = 0.f;
  __syncthreads();
  const float* part = args.dgp + (long long)chunk * args.groups * tiles * 256;
  for (int i = threadIdx.x; i < tiles * 256; i += kDbcThreads) {
    float s = 0.f;
    for (int gi = 0; gi < args.groups; ++gi) s += part[(long long)gi * tiles * 256 + i];
    const int tile = i / 256, ln = (i / 8) % 32, e = i % 8;
    int kt = 0;
    while ((kt + 1) * (kt + 2) / 2 <= tile) ++kt;
    const int jt = tile - kt * (kt + 1) / 2;
    const int j = 16 * jt + (ln >> 2) + 8 * ((e >> 1) & 1);
    const int t = 16 * kt + 8 * (e >> 2) + 2 * (ln & 3) + (e & 1);
    dgd[j * ldg + t] = s;
  }
  __syncthreads();
  if (!has_r) return;
  // dC += dG B (rows t, k = j) and dB += dG^T C (rows j, k = t)
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) {
    if (kk >= qt) break;
    uint32_t ah[4], al[4], at[4], atl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + (u & 1) * 8, c = 16 * kk + 2 * t4 + (u >> 1) * 8;
      // dG[t = r, j = c, c + 1] = dgd[c][r], dgd[c + 1][r]; dG^T[j = r, t = c..]
      split2(dgd[c * ldg + r], dgd[(c + 1) * ldg + r], ah[u], al[u]);
      const float2 v = *reinterpret_cast<const float2*>(dgd + r * ldg + c);
      split2(v.x, v.y, at[u], atl[u]);
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int col = 16 * half + 8 * nn + g, k0 = 16 * kk + 2 * t4;
      uint32_t bh[2], bl[2], ch_[2], cl_[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int kr = k0 + 8 * v;
        split2(to_f32(bcol[kr * kSlice + col]), to_f32(bcol[(kr + 1) * kSlice + col]), bh[v],
               bl[v]);
        split2(to_f32(ccol[kr * kSlice + col]), to_f32(ccol[(kr + 1) * kSlice + col]), ch_[v],
               cl_[v]);
      }
      mma(dcc[nn], ah, bh[0], bh[1]);
      mma(dcc[nn], al, bh[0], bh[1]);
      mma(dbb[nn], at, ch_[0], ch_[1]);
      mma(dbb[nn], atl, ch_[0], ch_[1]);
      if constexpr (kIn == 2) {
        mma(dcc[nn], ah, bl[0], bl[1]);
        mma(dbb[nn], at, cl_[0], cl_[1]);
      }
    }
  }
  T* dbg = static_cast<T*>(args.db) + ((long long)bi * args.t + t0) * n + n0;
  T* dcg = static_cast<T*>(args.dc) + ((long long)bi * args.t + t0) * n + n0;
  const bool pair = n % 2 == 0;
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = r0 + 8 * rh, c = 16 * half + 8 * nn + 2 * t4;
      if (r >= q || c >= nw) continue;
      store2(dcg + (long long)r * n + c, dcc[nn][2 * rh], dcc[nn][2 * rh + 1], c + 1 < nw, pair);
      store2(dbg + (long long)r * n + c, dbb[nn][2 * rh], dbb[nn][2 * rh + 1], c + 1 < nw, pair);
    }
}

// ------------------------------------------------------------ ds and da

// One warp per (row, chunk): ds = the per-chunk kernel's part + qv over the
// n-slices (+ e^(s_last) sum(H o dH') + sum_j w_j t2_j at t = last), its
// reverse cumsum dla by a shuffle scan, ddt = the per-chunk kernel's part +
// a dla, and the chunk's share of da, sum_j dla_j dt_j.
__global__ void __launch_bounds__(kThreads) ssd_bwd_tail_kernel(const BwdArgs args) {
  const int q = args.q, nc = args.t / q;
  const long long item = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (item >= (long long)args.rows * nc) return;
  const long long row = item / nc;
  const int ci = (int)(item % nc);
  const long long t0 = (long long)ci * q;
  const int bi = (int)(row / args.nh), hi = (int)(row % args.nh);
  const int nslices = (args.n + kSlice - 1) / kSlice, per = lane_steps(q);
  const long long plane = (long long)args.rows * args.t;
  const float a = args.a[bi * args.sa_b + hi * args.sa_h];
  const float* ds_part = args.dsp + row * args.t + t0;
  const float* sv = args.sv + row * args.t + t0;
  const float* hsp = args.hsp + (row * nc + ci) * nslices * kDbcWarps;
  // e^(s_last) sum(H o dH') + sum_j w_j t2_j, added at t = last: each a fixed tree
  float hs = 0.f, wt2 = 0.f;
  for (int i = lane; i < nslices * kDbcWarps; i += 32) hs += hsp[i];
  for (int j = lane; j < q; j += 32) wt2 += ds_part[2 * plane + j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hs += __shfl_xor_sync(0xffffffffu, hs, off);
    wt2 += __shfl_xor_sync(0xffffffffu, wt2, off);
  }
  float ds[4], tot = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = lane * per + u;
    ds[u] = 0.f;
    if (u < per && t < q) {
      float qv = 0.f;  // over the n-slices, in order
      for (int sc = 0; sc < 2 * nslices; ++sc)
        qv += args.qvp[(row * 2 * nslices + sc) * args.t + t0 + t];
      ds[u] = ds_part[t] + qv + (t == q - 1 ? sv[kEs * plane + t] * hs + wt2 : 0.f);
    }
    tot += ds[u];
  }
  float incl = tot;  // sum over this lane and the lanes after it
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  float run = incl - tot, dap = 0.f;
  float* ddtg = args.ddt + bi * args.sddt_b + hi * args.sddt_h + t0 * args.sddt_t;
#pragma unroll
  for (int u = 3; u >= 0; --u) {
    const int t = lane * per + u;
    if (u < per && t < q) {
      run += ds[u];
      ddtg[t * args.sddt_t] = ds_part[plane + t] + a * run;
      dap += run * sv[kDt * plane + t];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dap += __shfl_xor_sync(0xffffffffu, dap, off);
  if (lane == 0) args.dap[row * nc + ci] = dap;
}

// da: over batch rows and chunks (a per head), or over chunks (a per row).
__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(const BwdArgs args) {
  const int nc = args.t / args.q, nb = args.rows / args.nh;
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < args.na; k += gridDim.x * kThreads) {
    float acc = 0.f;
    if (args.a_per_row) {
      for (int c2 = 0; c2 < nc; ++c2) acc += args.dap[(long long)k * nc + c2];
    } else {
      for (int b2 = 0; b2 < nb; ++b2)
        for (int c2 = 0; c2 < nc; ++c2) acc += args.dap[((long long)b2 * args.nh + k) * nc + c2];
    }
    args.da[k] = acc;
  }
}

template <typename K>
cudaError_t launch_one(K kernel, int blocks, long long smem, cudaStream_t st, const BwdArgs& args,
                       int threads = kThreads) {
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, st>>>(args);
  return cudaGetLastError();
}

template <typename T, bool kAsync>
int launch(const BwdArgs& args, cudaStream_t st) {
  constexpr int kIn = std::is_same<T, float>::value ? 2 : 1;
  const int nc = args.t / args.q, nb = args.rows / args.nh, items = args.rows * nc;
  const int pslices = (args.p + kSlice - 1) / kSlice, nslices = (args.n + kSlice - 1) / kSlice;
  cudaError_t err = launch_one(ssd_bwd_scan_kernel, (items + kWarps - 1) / kWarps, 0, st, args);
  if (err == cudaSuccess)
    err = launch_one(ssd_bwd_dstate_kernel<T, kAsync>, args.rows * pslices,
                     DstateLayout(args.q, args.n).total, st, args);
  if (err == cudaSuccess)
    err = launch_one(ssd_bwd_chunk_kernel<T, kAsync>, nb * nc * args.groups,
                     ChunkLayout(args.q, args.n, args.p, kIn).total, st, args);
  if (err == cudaSuccess)
    err = launch_one(ssd_bwd_dbc_kernel<T, kAsync>, nb * nc * nslices,
                     DbcLayout(args.q, args.p, kIn, sizeof(T), kAsync ? kStages : 1).total, st, args,
                     kDbcThreads);
  if (err == cudaSuccess)
    err = launch_one(ssd_bwd_tail_kernel, (items + kWarps - 1) / kWarps, 0, st, args);
  if (err == cudaSuccess)
    err = launch_one(ssd_bwd_da_kernel, (args.na + kThreads - 1) / kThreads, 0, st, args);
  return (int)err;
}

bool aligned16(const void* ptr, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

}  // namespace

// C interface.  `dtype` is 0 for f32 and 1 for bf16 (x, b, c and dx, db,
// dc).  `strides` holds the 21 element strides in BwdArgs order (x, dt, a,
// b, c, dy, dx, ddt); dy is contiguous.  Scratch, all f32: dstate (rows /
// nh, t / q, nh, n, p); sv (5, rows, t); dsp (3, rows, t); qvp (rows, 2
// ceil(n / 32), t); hsp (rows, t / q, ceil(n / 32), 16); dgp (rows / nh,
// t / q, groups, tiles, 256) with tiles = qt (qt + 1) / 2, qt = ceil(q /
// 16); dap (rows, t / q).  Heads [g hg, (g + 1) hg) form group g.  `na` is the
// length of a and da; `a_per_row` is 1 when a holds one value per row (rows
// layout, nh = 1).  Launches six kernels on `stream`; returns
// cudaGetLastError() as an int or cudaErrorInvalidValue for a shape it
// does not take; never synchronizes.
extern "C" int ssd_scan_bwd(int dtype, const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* dy, const void* dhf,
                            const void* hprev, void* dstate, void* dx, void* ddt, void* dh0,
                            void* sv, void* dsp, void* qvp, void* hsp, void* dgp, void* dap,
                            void* db, void* dc, void* da, int rows, int nh, int t, int q, int n,
                            int p, int a_per_row, int na, int groups, int hg,
                            const long long* strides, void* stream) {
  if (rows <= 0 || nh <= 0 || rows % nh || q <= 0 || t % q || q > kMaxDim || n <= 0 ||
      n > kMaxDim || p <= 0 || p > kMaxP || groups <= 0 || hg <= 0 ||
      (long long)groups * hg < nh || (long long)(groups - 1) * hg >= nh ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  BwdArgs args{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c,
               static_cast<const float*>(dy), static_cast<const float*>(dhf),
               static_cast<const float*>(hprev), static_cast<float*>(dstate), dx,
               static_cast<float*>(ddt), static_cast<float*>(dh0), static_cast<float*>(sv),
               static_cast<float*>(dsp), static_cast<float*>(qvp), static_cast<float*>(hsp),
               static_cast<float*>(dgp), static_cast<float*>(dap), db, dc,
               static_cast<float*>(da), rows, nh, t, q, n, p, a_per_row, na, groups, hg,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
               strides[12], strides[13], strides[14], strides[15], strides[16], strides[17],
               strides[18], strides[19], strides[20]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(args, st);
  const bool vec = n % 8 == 0 && p % 8 == 0 &&
                   aligned16(x, {args.sx_b, args.sx_h, args.sx_t}) &&
                   aligned16(b, {args.sb_b, args.sb_t}) && aligned16(c, {args.sc_b, args.sc_t}) &&
                   aligned16(dy, {args.sdy_b, args.sdy_h, args.sdy_t}) &&
                   aligned16(hprev, {}) && aligned16(dstate, {});
  return vec ? launch<bf16, true>(args, st) : launch<bf16, false>(args, st);
}

