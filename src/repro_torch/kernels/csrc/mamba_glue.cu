// The Mamba-2 block's prefill glue on Hopper (sm_90a): two kernels that
// take the elementwise work around the SSD scan off the tap-by-tap,
// cast-by-cast torch chain of models/mamba2.py mamba_apply.
//
// They replace no Pallas kernel.  The JAX package's glue is jnp code
// (src/repro/models/mamba2.py causal_conv, the SiLU, the D skip, the gate
// and the gated RMSNorm), whose plain torch counterpart in the port stays
// the path of CPU tensors, float32 models, training (which records a graph;
// these kernels have no backward), decode and DTensors.
//
// mamba_conv: the depthwise causal conv over time of the concatenation
// [x | B | C] (C = d_inner + 2 N channels), plus its bias, then SiLU:
//   out[t, ch] = silu(sum_j w[j, ch] * in[t - W + 1 + j, ch] + bias[ch]),
// rows before 0 being 0.  It reads x, B and C where the projections left
// them, so the concatenation never exists, and it also writes the conv
// tail (the last W - 1 input rows, zeros in front where T < W - 1) as a
// tensor of its own, which decode continues from.  The taps are summed in
// f32 in the plain path's order, each product rounded before its add (no
// FMA), and the bias added last, so the f32 sum is the plain path's; the
// SiLU follows in f32 (with the hardware's exp2 and reciprocal: a few f32
// ulps) and the result is rounded once to bf16 (the plain path rounds
// before the SiLU and after it).
//
// mamba_gate_norm: for each token row of d_inner channels, from the scan's
// f32 output y (as it wrote it, before any cast), the conv's x, the gate z,
// D (f32, one a head) and the norm's scale:
//   v = (y + D x) silu(z);  out = bf16(bf16(v rsqrt(mean(v^2) + eps)) scale)
// in f32 throughout, with models/layers.py rmsnorm's cast order at the end
// (normalise in f32, round to bf16, then scale).  The plain path rounds y,
// D x, the skip's sum, silu(z) and the gated product to bf16 on the way.
//
// What bounds them.  Both move bytes and do a few operations a byte.  At
// mamba2-1.3b's prefill block (B 16, T 2,048, d_inner 4,096, N 128) the
// conv reads and writes 285 MB each (0.17 ms at 3.35 TB/s) and the norm
// reads y (537 MB), x and z and writes its output (1.34 GB, 0.40 ms); the
// plain chain moves ~25 GB for the same work.  So their design is that of
// a streaming kernel:
//   * every load and store is a vector of 8 or 16 bytes a thread,
//     neighbouring threads on neighbouring addresses;
//   * the conv gives each thread 4 channels and a run of kConvRows time
//     steps, with the previous W - 1 rows in registers as a sliding window:
//     each input row is read once, plus a halo of W - 1 rows a run (5% at
//     64 rows), and kConvUnroll rows are loaded ahead of their use to keep
//     enough bytes in flight.  Its SiLU takes the hardware's exp2 and
//     reciprocal: with the accurate expf and an IEEE division the kernel
//     was bound by its instructions, at half its byte bound (PERF.md);
//   * the norm gives each token row one block of kNormThreads threads; a
//     thread keeps its up to kNormMaxChunks x 8 gated values in registers
//     while the block sums their squares (warp shuffles, then shared
//     memory), so each operand crosses HBM once.
//
// The entry points launch on `stream` and return cudaGetLastError() as an
// int (0 on success), cudaErrorInvalidValue for a shape without an
// instance (the wrapper, kernels/mamba_glue.py, refuses those first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConvVec = 4;        // channels a thread (8-byte accesses)
constexpr int kConvThreads = 128;  // threads a block
constexpr int kConvRows = 64;      // time steps a block
constexpr int kConvUnroll = 8;     // rows loaded ahead of their use
constexpr int kNormThreads = 128;  // one block a token row
constexpr int kNormMaxChunks = 8;  // chunks of 8 channels a thread: d_inner <= 8,192

// Vectors of V bf16 values: 16-byte (V = 8) or 8-byte (V = 4) accesses.
template <int V> struct Vec;
template <> struct Vec<8> { typedef uint4 T; };
template <> struct Vec<4> { typedef uint2 T; };

template <int V>
__device__ __forceinline__ typename Vec<V>::T load_vec(const bf16* p) {
  return __ldg(reinterpret_cast<const typename Vec<V>::T*>(p));
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const typename Vec<V>::T& v) {
  *reinterpret_cast<typename Vec<V>::T*>(p) = v;
}

template <int V>
__device__ __forceinline__ void unpack(const typename Vec<V>::T& raw, float (&f)[V]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <int V>
__device__ __forceinline__ typename Vec<V>::T pack(const float (&f)[V]) {
  typename Vec<V>::T raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

// x sigmoid(x), as torch's SiLU computes it in f32.
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// SiLU with the hardware's exp2 and reciprocal (a few f32 ulps, far below
// the bf16 rounding that follows; -0 below -87, where 1 + e^-v overflows).
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

struct ConvParams {
  const bf16* src[3];      // x (B, T, d_inner), B (B, T, N), C (B, T, N)
  long long sb[3], st[3];  // their batch and time strides, in elements
  const bf16* w;           // (W, C) contiguous
  const bf16* bias;        // (C,)
  bf16* out;               // (B, T, C) contiguous
  bf16* tail;              // (B, W - 1, C) contiguous
  int t, di, n, c;         // c = di + 2 n
};

// Grid (channel groups / kConvThreads, T / kConvRows, B), rounded up: a
// thread owns V channels of one batch row over kConvRows steps, U rows
// loaded at a time.
template <int W, int V = kConvVec, int U = kConvUnroll>
__global__ void __launch_bounds__(kConvThreads) mamba_conv_kernel(const ConvParams p) {
  typedef typename Vec<V>::T VecT;
  const int ch = (blockIdx.x * kConvThreads + threadIdx.x) * V;
  if (ch >= p.c) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kConvRows;
  const int t1 = min(t0 + kConvRows, p.t);
  // Which projection these channels come from (d_inner and N are multiples
  // of 8, so a group never straddles two), selected by branches: a runtime
  // index into the parameter arrays would copy them to local memory.
  const bf16* src;
  long long st;
  if (ch < p.di) {
    src = p.src[0] + b * p.sb[0] + ch;
    st = p.st[0];
  } else if (ch < p.di + p.n) {
    src = p.src[1] + b * p.sb[1] + (ch - p.di);
    st = p.st[1];
  } else {
    src = p.src[2] + b * p.sb[2] + (ch - p.di - p.n);
    st = p.st[2];
  }
  bf16* out = p.out + (long long)b * p.t * p.c + ch;
  bf16* tail = p.tail + (long long)b * (W - 1) * p.c + ch;
  const int first_tail = p.t - (W - 1);  // the input row of tail row 0
  const VecT zero = {};

  float w[W][V], bias[V];
#pragma unroll
  for (int j = 0; j < W; ++j) unpack<V>(load_vec<V>(p.w + (long long)j * p.c + ch), w[j]);
  unpack<V>(load_vec<V>(p.bias + ch), bias);

  // win[j] holds input row t - (W - 1) + j of the step t about to be computed.
  float win[W - 1][V];
#pragma unroll
  for (int j = 0; j < W - 1; ++j) {
    const int tt = t0 - (W - 1) + j;
    if (tt >= 0) {
      unpack<V>(load_vec<V>(src + tt * st), win[j]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) win[j][k] = 0.f;
      // Rows before 0 are the tail's zeros where T < W - 1; only the
      // first run of a batch row visits them.
      if (tt >= first_tail) store_vec<V>(tail + (long long)(tt - first_tail) * p.c, zero);
    }
  }

  for (int t = t0; t < t1; t += U) {
    VecT raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) raw[u] = t + u < t1 ? load_vec<V>(src + (t + u) * st) : zero;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u >= t1) break;
      float cur[V], o[V];
      unpack<V>(raw[u], cur);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float acc = __fmul_rn(win[0][k], w[0][k]);
#pragma unroll
        for (int j = 1; j < W - 1; ++j) acc = __fadd_rn(acc, __fmul_rn(win[j][k], w[j][k]));
        acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(cur[k], w[W - 1][k])), bias[k]);
        o[k] = silu_fast(acc);
      }
      store_vec<V>(out + (long long)(t + u) * p.c, pack<V>(o));
      if (t + u >= first_tail) store_vec<V>(tail + (long long)(t + u - first_tail) * p.c, raw[u]);
#pragma unroll
      for (int j = 0; j + 1 < W - 1; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k) win[j][k] = win[j + 1][k];
#pragma unroll
      for (int k = 0; k < V; ++k) win[W - 2][k] = cur[k];
    }
  }
}

template <int W>
int launch_conv(const ConvParams& p, int batch, cudaStream_t stream) {
  const int groups = p.c / kConvVec;
  const dim3 grid((groups + kConvThreads - 1) / kConvThreads,
                  (p.t + kConvRows - 1) / kConvRows, batch);
  mamba_conv_kernel<W><<<grid, kConvThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

struct NormParams {
  const float* y;          // the scan's output, a row of d_inner f32 values a token
  const bf16* x;           // the conv's x channels, a row of d_inner a token
  const bf16* z;           // the gate, a row of d_inner a token
  long long sy[2], sx[2], sz[2];  // batch and time strides, in elements
  const float* d;          // (H,)
  const bf16* norm;        // (d_inner,)
  bf16* out;               // (B, T, d_inner) contiguous
  int t, di, p;            // p: the head dim (a multiple of 8)
  float eps;
};

// One block a token row (grid B * T).
template <int NCH>
__global__ void __launch_bounds__(kNormThreads) mamba_gate_norm_kernel(const NormParams p) {
  const int row = blockIdx.x;
  const int b = row / p.t, t = row - b * p.t;
  const float* y = p.y + b * p.sy[0] + t * p.sy[1];
  const bf16* x = p.x + b * p.sx[0] + t * p.sx[1];
  const bf16* z = p.z + b * p.sz[0] + t * p.sz[1];
  bf16* out = p.out + (long long)row * p.di;
  const int chunks = p.di / 8;

  float v[NCH][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (threadIdx.x + i * kNormThreads) * 8;
    if (c < p.di) {
      const float4 y0 = __ldg(reinterpret_cast<const float4*>(y + c));
      const float4 y1 = __ldg(reinterpret_cast<const float4*>(y + c + 4));
      float xf[8], zf[8];
      unpack<8>(load_vec<8>(x + c), xf);
      unpack<8>(load_vec<8>(z + c), zf);
      const float dh = __ldg(p.d + c / p.p);
      const float yf[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = (yf[e] + dh * xf[e]) * silu(zf[e]);
        ss += v[i][e] * v[i][e];
      }
    }
  }

  __shared__ float part[kNormThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) total += part[w];
  const float r = rsqrtf(total / (float)p.di + p.eps);

#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int k = threadIdx.x + i * kNormThreads;
    if (k < chunks) {
      float sc[8], o[8];
      unpack<8>(load_vec<8>(p.norm + k * 8), sc);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = __bfloat162float(__float2bfloat16_rn(v[i][e] * r)) * sc[e];
      store_vec<8>(out + k * 8, pack<8>(o));
    }
  }
}

template <int NCH>
int launch_norm(const NormParams& p, int batch, cudaStream_t stream) {
  mamba_gate_norm_kernel<NCH><<<batch * p.t, kNormThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T, d_inner), b and c (B, T, n), w (W, d_inner + 2 n), bias
// (d_inner + 2 n), all bf16, each with contiguous channels and 16-byte
// aligned rows; `strides` holds the (batch, time) element strides of x, b
// and c in that order.  Writes out (B, T, d_inner + 2 n) and tail (B, W - 1,
// d_inner + 2 n), both contiguous.  d_inner and n are multiples of 8, W is
// 4 (the width of every configuration), T >= 1.
extern "C" int mamba_conv(const void* x, const void* b, const void* c, const void* w,
                          const void* bias, void* out, void* tail, int batch, int t,
                          int di, int n, int width, const long long* strides, void* stream) {
  ConvParams p;
  p.src[0] = static_cast<const bf16*>(x);
  p.src[1] = static_cast<const bf16*>(b);
  p.src[2] = static_cast<const bf16*>(c);
  for (int i = 0; i < 3; ++i) {
    p.sb[i] = strides[2 * i];
    p.st[i] = strides[2 * i + 1];
  }
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.out = static_cast<bf16*>(out);
  p.tail = static_cast<bf16*>(tail);
  p.t = t;
  p.di = di;
  p.n = n;
  p.c = di + 2 * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width != 4) return (int)cudaErrorInvalidValue;
  return launch_conv<4>(p, batch, st);
}

// y (f32), x and z (bf16): a row of d_inner contiguous values for each
// (batch row, step), 16-byte aligned; `strides` holds the (batch, time)
// element strides of y, x and z in that order.  d (H,) f32, norm (d_inner,)
// bf16; out (B, T, d_inner) bf16 contiguous.  d_inner and head_dim are
// multiples of 8, d_inner <= 8,192.
extern "C" int mamba_gate_norm(const void* y, const void* x, const void* z, const void* d,
                               const void* norm, void* out, int batch, int t, int di,
                               int head_dim, float eps, const long long* strides,
                               void* stream) {
  NormParams p;
  p.y = static_cast<const float*>(y);
  p.x = static_cast<const bf16*>(x);
  p.z = static_cast<const bf16*>(z);
  for (int i = 0; i < 2; ++i) {
    p.sy[i] = strides[i];
    p.sx[i] = strides[2 + i];
    p.sz[i] = strides[4 + i];
  }
  p.d = static_cast<const float*>(d);
  p.norm = static_cast<const bf16*>(norm);
  p.out = static_cast<bf16*>(out);
  p.t = t;
  p.di = di;
  p.p = head_dim;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((di / 8 + kNormThreads - 1) / kNormThreads) {
    case 1: return launch_norm<1>(p, batch, st);
    case 2: return launch_norm<2>(p, batch, st);
    case 3: return launch_norm<3>(p, batch, st);
    case 4: return launch_norm<4>(p, batch, st);
    case 5: return launch_norm<5>(p, batch, st);
    case 6: return launch_norm<6>(p, batch, st);
    case 7: return launch_norm<7>(p, batch, st);
    case kNormMaxChunks: return launch_norm<kNormMaxChunks>(p, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
