// Chunked Mamba-2 SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan.  For each (batch, head)
// row and each chunk of q steps, with s = cumsum(dt * a) over the chunk and
// L[t, j] = exp(s_t - s_j) for t >= j (0 above the diagonal):
//
//   y     = (L o (C B^T)) (dt * X) + exp(s) * (C h_prev)
//   h_new = exp(s_last) * h_prev + (B * w)^T X,   w = dt * exp(s_last - s)
//
// All arithmetic is f32; x, b and c are read as f32 or bf16 (template T),
// dt, a, h0 are f32, and y and h_final are written in f32.
//
// Grid and carry.  The Pallas kernel walks a sequential grid axis over the
// chunks and carries h in VMEM scratch.  Hopper runs blocks in no order, so
// here one block owns one (batch, head) row and loops over its chunks; the
// f32 (n, p) state stays in shared memory from the first chunk to the last
// and is written to h_final once.
//
// Layout.  The model holds x as (B, T, H, P) -- a strided view of the conv
// output -- and b, c as (B, T, N), shared by the H heads of a batch row.
// The kernel takes every operand with its strides (the innermost p or n
// dimension must be contiguous), so neither x nor y is copied into a
// (B*H, T, P) layout, and b, c are never expanded per head: row (bi, hi)
// reads b[bi].  The Pallas layout (bh, t, p) with per-row b, c is the same
// kernel at H = 1.
//
// Shared memory (f32, one chunk): X (q, p); B^T (n, q+1); C (q, n+1), whose
// space is reused for the masked decay matrix M = L o (C B^T) * dt once C
// is no longer needed; h (n, p); and four q-vectors.  At q = n = 128, p = 64
// that is 199,680 bytes, so one 256-thread block runs per SM; the rows of
// B^T, C and M are padded by one word so that column walks do not collide
// in one bank.
//
// Products.  Each of the four products is an FMA loop over shared memory in
// which thread (tx, ty) of a 16 x 16 block owns the outputs at rows
// ty + 16 i and columns tx + 16 j: per step of the contraction it loads 8
// row values (broadcast across the 16 lanes of a half-warp) and up to 8
// column values (16 consecutive words), and does up to 64 FMAs.  The mask
// is applied before the exponential (exp of the positive upper-triangle
// exponent would overflow, and inf * 0 is NaN).
//
// Bound.  At the main shape (B=4, T=1024, H=64, P=64, N=128, q=128, bf16
// inputs) the work is ~15 GFLOP and the bytes ~112 MB, so on the tensor
// cores the function is memory-bound (~33 us at 3.35 TB/s).  This kernel
// uses the CUDA cores' f32 FMA instead, so it is held to ~15 GFLOP over
// 67 TFLOP/s (~0.23 ms) at best, and by one block per row to 256 blocks on
// 132 SMs.  It is written simple and right; wgmma tiles, TMA loads and a
// split of the chunk loop across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSide = 16;                // threads per block side
constexpr int kThreads = kSide * kSide;  // 256
constexpr int kMaxDim = 128;             // q, n and p limits
constexpr int kRows = kMaxDim / kSide;   // 8 rows per thread

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h0;  // (rows, n, p) contiguous, or null for zeros
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

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Shared-memory floats for one block (kernels/ssd_scan.py asks for it
// through ssd_scan_smem_bytes before a launch).
__host__ __device__ inline long long smem_floats(int q, int n, int p) {
  const long long cm = (long long)q * (n > q ? n + 1 : q + 1);
  return (long long)q * p + (long long)n * (q + 1) + cm + (long long)n * p + 4LL * q;
}

// PJ: column tiles of p per thread (p <= 16 * PJ).
template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const SsdArgs args) {
  extern __shared__ float smem[];
  const int q = args.q, n = args.n, p = args.p;
  const int qs = q + 1, ns = n + 1;  // padded row strides of B^T, C and M
  float* xs = smem;                  // (q, p)
  float* bs = xs + q * p;            // B^T (n, qs)
  float* cm = bs + n * qs;           // C (q, ns), then M (q, qs)
  float* hs = cm + q * (n > q ? ns : qs);  // (n, p)
  float* sv = hs + n * p;            // s: cumulative log-decay
  float* dtv = sv + q;               // dt
  float* ev = dtv + q;               // exp(s)
  float* wv = ev + q;                // dt * exp(s_last - s)

  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int row = blockIdx.x;
  const int bi = row / args.nh, hi = row % args.nh;
  const T* xg = static_cast<const T*>(args.x) + bi * args.sx_b + hi * args.sx_h;
  const T* bg = static_cast<const T*>(args.b) + bi * args.sb_b;
  const T* cg = static_cast<const T*>(args.c) + bi * args.sc_b;
  const float* dtg = args.dt + bi * args.sdt_b + hi * args.sdt_h;
  float* yg = args.y + bi * args.sy_b + hi * args.sy_h;
  const float a = args.a[bi * args.sa_b + hi * args.sa_h];
  const long long np = (long long)n * p;

  for (int i = tid; i < n * p; i += kThreads)
    hs[i] = args.h0 ? args.h0[row * np + i] : 0.f;

  // Output coordinates of this thread, clamped into range so the inner
  // loops need no guards; only the stores check the true bounds.
  int rq[kRows], rn[kRows], cq[kRows], cp[PJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    rq[i] = min(ty + kSide * i, q - 1);
    rn[i] = min(ty + kSide * i, n - 1);
    cq[i] = min(tx + kSide * i, q - 1);
  }
#pragma unroll
  for (int j = 0; j < PJ; ++j) cp[j] = min(tx + kSide * j, p - 1);

  for (int t0 = 0; t0 < args.t; t0 += q) {
    __syncthreads();  // the previous chunk is done with X, B^T, M and h
    for (int i = tid; i < q * p; i += kThreads) {
      const int j = i / p, c = i - j * p;
      xs[i] = load_f32(xg + (t0 + j) * args.sx_t + c);
    }
    for (int i = tid; i < q * n; i += kThreads) {
      const int j = i / n, k = i - j * n;
      bs[k * qs + j] = load_f32(bg + (t0 + j) * args.sb_t + k);
      cm[j * ns + k] = load_f32(cg + (t0 + j) * args.sc_t + k);
    }
    for (int i = tid; i < q; i += kThreads) dtv[i] = dtg[(t0 + i) * args.sdt_t];
    __syncthreads();

    // s = inclusive cumsum of dt * a: each lane of warp 0 sums up to four
    // consecutive steps, then the lanes scan their totals.
    if (tid < 32) {
      const int per = (q + 31) / 32;
      float loc[kMaxDim / 32];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxDim / 32; ++u) {
        const int j = tid * per + u;
        if (u < per && j < q) run += dtv[j] * a;
        loc[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
#pragma unroll
      for (int u = 0; u < kMaxDim / 32; ++u) {
        const int j = tid * per + u;
        if (u < per && j < q) sv[j] = excl + loc[u];
      }
    }
    __syncthreads();
    const float s_last = sv[q - 1];
    for (int i = tid; i < q; i += kThreads) {
      ev[i] = expf(sv[i]);
      wv[i] = dtv[i] * expf(s_last - sv[i]);
    }
    __syncthreads();

    // y_inter = C h_prev (scaled by exp(s) below) and G = C B^T.
    float acc_y[kRows][PJ];
    float acc_g[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc_y[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc_g[i][j] = 0.f;
    }
    for (int k = 0; k < n; ++k) {
      float cr[kRows], hc[PJ], bc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) cr[i] = cm[rq[i] * ns + k];
#pragma unroll
      for (int j = 0; j < PJ; ++j) hc[j] = hs[k * p + cp[j]];
#pragma unroll
      for (int j = 0; j < kRows; ++j) bc[j] = bs[k * qs + cq[j]];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc_y[i][j] = fmaf(cr[i], hc[j], acc_y[i][j]);
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc_g[i][j] = fmaf(cr[i], bc[j], acc_g[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float e = ev[rq[i]];
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc_y[i][j] *= e;
    }
    __syncthreads();  // every thread is done reading C: M takes its space

    // M[t, j] = exp(s_t - s_j) * dt_j * G[t, j] for t >= j, else 0; the
    // exponent is masked before exp.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int tr = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int tc = tx + kSide * j;
        if (tr < q && tc < q)
          cm[tr * qs + tc] =
              tr >= tc ? expf(sv[tr] - sv[tc]) * dtv[tc] * acc_g[i][j] : 0.f;
      }
    }
    __syncthreads();

    // y += M X, then store y.
    for (int k = 0; k < q; ++k) {
      float mr[kRows], xc[PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) mr[i] = cm[rq[i] * qs + k];
#pragma unroll
      for (int j = 0; j < PJ; ++j) xc[j] = xs[k * p + cp[j]];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc_y[i][j] = fmaf(mr[i], xc[j], acc_y[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int tr = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int tc = tx + kSide * j;
        if (tr < q && tc < p) yg[(t0 + tr) * args.sy_t + tc] = acc_y[i][j];
      }
    }

    // h = exp(s_last) h + (B w)^T X.  Each thread reads and writes only its
    // own h entries here; the other readers of h (C h_prev above) finished
    // before the last barrier.
    float acc_h[kRows][PJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc_h[i][j] = 0.f;
    for (int k = 0; k < q; ++k) {
      const float w = wv[k];
      float br[kRows], xc[PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) br[i] = bs[rn[i] * qs + k] * w;
#pragma unroll
      for (int j = 0; j < PJ; ++j) xc[j] = xs[k * p + cp[j]];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc_h[i][j] = fmaf(br[i], xc[j], acc_h[i][j]);
    }
    const float decay = ev[q - 1];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int tr = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int tc = tx + kSide * j;
        if (tr < n && tc < p) hs[tr * p + tc] = decay * hs[tr * p + tc] + acc_h[i][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * p; i += kThreads) args.hout[row * np + i] = hs[i];
}

template <typename T, int PJ>
int launch(const SsdArgs& args, int rows, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(args.q, args.n, args.p);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, PJ><<<rows, kThreads, smem, st>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface.  `dtype` is 0 for f32 and 1 for bf16 (x, b and c); `rows` is
// batch * heads; `strides` holds the 15 element strides in SsdArgs order.
// Launches on `stream`, returns cudaGetLastError() as an int (0 = launched)
// or cudaErrorInvalidValue for a shape the kernel does not take; it never
// synchronizes.
extern "C" long long ssd_scan_smem_bytes(int q, int n, int p) {
  return (long long)sizeof(float) * smem_floats(q, n, p);
}

extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* a,
                        const void* b, const void* c, const void* h0, void* y,
                        void* hout, int rows, int nh, int t, int q, int n, int p,
                        const long long* strides, void* stream) {
  if (rows <= 0 || nh <= 0 || q <= 0 || t % q != 0 || q > kMaxDim || n <= 0 ||
      n > kMaxDim || p <= 0 || p > kMaxDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  SsdArgs args{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c,
               static_cast<const float*>(h0), static_cast<float*>(y),
               static_cast<float*>(hout), nh, t, q, n, p,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
               strides[12], strides[13], strides[14]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = p > kSide * 4;
  if (dtype == 0)
    return wide ? launch<float, 8>(args, rows, st) : launch<float, 4>(args, rows, st);
  return wide ? launch<__nv_bfloat16, 8>(args, rows, st)
              : launch<__nv_bfloat16, 4>(args, rows, st);
}
