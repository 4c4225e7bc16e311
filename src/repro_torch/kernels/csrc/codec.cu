// Stripe-codec kernels for Hopper (sm_90a): XOR parity and GF(256) matmul.
//
// All kernels work on int32 lanes that pack four bytes each, exactly as the
// host arenas do, and are built by kernels/_build.py into one shared library
// with a plain C interface (loaded with ctypes; no PyTorch headers).
//
// Two forms of each.  The batched kernels (xor_reduce, gf256_matmul) take a
// stripe group, (S, k, n), from device memory.  The single-stripe kernels
// (stripe_xor, stripe_gf256) take one stripe, and on the datapath read and
// write it in pinned host memory that the card maps, across the host link
// (see their section below).
//
// Lane ownership: each thread owns 16 bytes (four int32 lanes) of a row of
// the output.  When every row starts on a 16-byte boundary (n % 4 == 0 and
// aligned base pointers: the wrapper passes `vec`), the thread moves its
// lanes with one 128-bit load per input row and one 128-bit store per output
// row; otherwise it falls back to scalar loads.  Either way the ragged tail
// (n not a multiple of 4) is masked here, so any n >= 1 works.  Offsets are
// 64-bit: a whole-zone rebuild decode is ~1e8 lanes.
//
// The batched kernels are memory-bound on an H100: each input byte is read
// once and each output byte written once, and the per-byte work (one XOR, or
// 8 SWAR double-and-add steps per coefficient) is far below the card's
// integer rate.
//
// Synchronisation: every entry launches on the stream it is given and
// returns cudaGetLastError() as an int (0 = launched).  The single-stripe
// entries are the one codec entry that can also synchronise that stream
// (their `sync` argument): their output lies in host memory, where the
// kernel's stores are visible to the host only once the stream has finished,
// so StripeCodec's per-stripe path asks for the sync and one ctypes call is
// the whole launch-and-wait.  With sync = 0 (device tensors) they stay
// asynchronous like the batched entries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------- XOR reduce
//
// Replaces kernels/parity_xor.py::parity_xor_batch: (S, k, n) int32 ->
// (S, n) int32.
// Bound: 4 * S * (k + 1) * n bytes over the memory rate.
template <bool VEC>
__global__ void xor_reduce_kernel(const int32_t* __restrict__ in,
                                  int32_t* __restrict__ out, int64_t S, int k,
                                  int64_t n, int64_t nv) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * nv) return;
  const int64_t s = t / nv;
  const int64_t lane = (t - s * nv) * 4;
  const int32_t* src = in + s * (int64_t)k * n + lane;
  int32_t* dst = out + s * n + lane;
  if (VEC) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < k; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + (int64_t)i * n);
      acc.x ^= v.x;
      acc.y ^= v.y;
      acc.z ^= v.z;
      acc.w ^= v.w;
    }
    *reinterpret_cast<uint4*>(dst) = acc;
  } else {
    const int64_t w = n - lane < 4 ? n - lane : 4;
    for (int64_t j = 0; j < w; ++j) {
      uint32_t acc = 0u;
      for (int i = 0; i < k; ++i) acc ^= (uint32_t)src[(int64_t)i * n + j];
      dst[j] = (int32_t)acc;
    }
  }
}

// ------------------------------------------------------------ GF(256) matmul
//
// Replaces kernels/gf256_matmul.py::gf256_matmul_batch: (m, k) coefficients
// x (S, k, n) -> (S, m, n), four GF(256) bytes per lane, field polynomial
// 0x11d.
// Bound: 4 * S * (k + m) * n bytes over the memory rate.
//
// The SWAR double-and-add of core/gf.py::swar_gf_scale, in uint32: the
// reference's (v & 0x7F7F7F7F) << 1 relies on int32 wraparound, which is
// undefined for signed ints in C++; in uint32 it is the same bits, defined.
// The (v >> 7) is masked, so the logical shift equals the arithmetic one.
__device__ __forceinline__ uint32_t swar_xtime(uint32_t v) {
  const uint32_t hi = (v >> 7) & 0x01010101u;
  return ((v & 0x7F7F7F7Fu) << 1) ^ (hi * 0x1Du);
}

__device__ __forceinline__ uint32_t swar_gf_scale(uint32_t v, uint32_t coeff) {
  uint32_t acc = 0u;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const uint32_t mask = 0u - ((coeff >> bit) & 1u);
    acc ^= v & mask;
    v = swar_xtime(v);
  }
  return acc;
}

template <bool VEC>
__global__ void gf256_matmul_kernel(const int32_t* __restrict__ coeff,
                                    const int32_t* __restrict__ in,
                                    int32_t* __restrict__ out, int m, int k,
                                    int64_t S, int64_t n, int64_t nv) {
  // The (m, k) coefficients are loaded once per block into shared memory.
  extern __shared__ uint32_t sc[];
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) sc[i] = (uint32_t)coeff[i];
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * nv) return;
  const int64_t s = t / nv;
  const int64_t lane = (t - s * nv) * 4;
  const int32_t* src = in + s * (int64_t)k * n + lane;
  int32_t* dst = out + s * (int64_t)m * n + lane;
  if (VEC) {
    for (int j = 0; j < m; ++j) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      for (int i = 0; i < k; ++i) {
        // rows are re-read per output row from L1/L2, not from DRAM
        const uint4 v = *reinterpret_cast<const uint4*>(src + (int64_t)i * n);
        const uint32_t c = sc[j * k + i];
        acc.x ^= swar_gf_scale(v.x, c);
        acc.y ^= swar_gf_scale(v.y, c);
        acc.z ^= swar_gf_scale(v.z, c);
        acc.w ^= swar_gf_scale(v.w, c);
      }
      *reinterpret_cast<uint4*>(dst + (int64_t)j * n) = acc;
    }
  } else {
    const int64_t w = n - lane < 4 ? n - lane : 4;
    for (int j = 0; j < m; ++j) {
      for (int64_t l = 0; l < w; ++l) {
        uint32_t acc = 0u;
        for (int i = 0; i < k; ++i)
          acc ^= swar_gf_scale((uint32_t)src[(int64_t)i * n + l], sc[j * k + i]);
        dst[(int64_t)j * n + l] = (int32_t)acc;
      }
    }
  }
}

// ------------------------------------------------ single-stripe (S = 1) forms
//
// Replace kernels/parity_xor.py::parity_xor (one stripe, (k, n) -> (n,)) and
// kernels/gf256_matmul.py::gf256_matmul ((m, k) x (k, n) -> (m, n)).  On the
// datapath a stripe is small (k rows of one 16 KiB chunk, or of a few OOB
// words) and its operands lie in pinned host memory that the card maps, so
// every load and store crosses the host link (PCIe): a launch is bound by
// the link's latency and by 4 * (k + m) * n bytes over its rate, not by HBM.
// The design follows from that:
//   * each input row is read once: a thread loads its 16 bytes of all k rows
//     into registers and produces every output row from them (the batched
//     GF kernel re-reads the k rows per output row from L1/L2; across the
//     link that would be m crossings);
//   * with compile-time K (and M) all k loads are in flight before the
//     first combine (rows_zero below keeps them together), so a thread
//     waits for the link once, not k times.
//     Instances cover k = 2..8 for XOR and (M, K) = (2, k) and (k, k),
//     k = 2..8, for GF (RAID-6 encode and decode at 4-10 drives); a
//     runtime-k instance takes every other shape (GF: 8 rows in flight and
//     8 outputs at a time, so beyond 8 outputs it reads each row once per
//     8);
//   * 64 threads per block, so a 4096-lane stripe spreads over 16 SMs and
//     their load queues;
//   * the GF coefficients go by value in the launch's parameters (m * k <=
//     kMaxStripeCoeffs bytes): the kernel touches no device memory at all.
// The GF product computes each input lane's doublings (v, 2v, ..., 128v)
// once and adds the ones a coefficient selects into all m outputs: 7 xtimes
// per input row instead of 8 per (output, input) pair.  The same kernels run
// on device memory (the wrappers on CUDA tensors): a pointer is a pointer.
constexpr int kStripeThreads = 64;
constexpr int kMaxStripeCoeffs = 1024;
constexpr int kRuntimeTile = 8;  // runtime GF: rows in flight, outputs a pass

struct StripeCoeffs {
  uint8_t c[kMaxStripeCoeffs];  // (m, k) row-major
};

// Thread -> its first lane and the lanes left in the row (>= 4 except at the
// ragged tail); false past the end.  No __restrict__ on the operands: they
// may be host-mapped, so plain global loads, not the read-only path.
__device__ __forceinline__ bool stripe_lane(int64_t n, int64_t& lane, int64_t& w) {
  lane = ((int64_t)blockIdx.x * kStripeThreads + threadIdx.x) * 4;
  w = n - lane;
  return lane < n;
}

template <bool VEC>
__device__ __forceinline__ void load16(const int32_t* p, int64_t w, uint32_t (&v)[4]) {
  if (VEC) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = l < w ? (uint32_t)p[l] : 0u;
  }
}

template <bool VEC>
__device__ __forceinline__ void store16(int32_t* p, int64_t w, const uint32_t (&v)[4]) {
  if (VEC) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (l < w) p[l] = (int32_t)v[l];
  }
}

// Whether R loaded rows are all zero.  The kernels test it on every row
// they loaded before the first combine, and skip the combine when it holds
// (zero rows add nothing: padding, empty OOB words).  The test is what keeps
// the loads together: without it the compiler starts on row 0 after two of
// the k loads of a GF product (k >= 3), and each later load waits a link
// round trip of its own.
template <int R>
__device__ __forceinline__ bool rows_zero(const uint32_t (&v)[R][4], int rows = R) {
  uint32_t any = 0u;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < rows) any |= v[i][0] | v[i][1] | v[i][2] | v[i][3];
  return any == 0u;
}

// K > 0: compile-time k (all loads first); K == 0: runtime k.
template <int K, bool VEC>
__global__ void __launch_bounds__(kStripeThreads)
    stripe_xor_kernel(const int32_t* in, int32_t* out, int k, int64_t n) {
  int64_t lane, w;
  if (!stripe_lane(n, lane, w)) return;
  const int32_t* src = in + lane;
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  if constexpr (K > 0) {
    uint32_t v[K][4];
#pragma unroll
    for (int i = 0; i < K; ++i) load16<VEC>(src + (int64_t)i * n, w, v[i]);
    if (!rows_zero(v)) {
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[l] ^= v[i][l];
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < k; ++i) {
      uint32_t v[4];
      load16<VEC>(src + (int64_t)i * n, w, v);
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[l] ^= v[l];
    }
  }
  store16<VEC>(out + lane, w, acc);
}

// acc[j] ^= c[j] (*) v over GF(256) for T output rows, where c[j] is row
// j's coefficient for this input row and v its 4 lanes of 4 bytes.
// The doublings of v are computed once and shared by the T outputs.
template <int T>
__device__ __forceinline__ void gf_accumulate(uint32_t (&acc)[T][4], const uint32_t (&v)[4],
                                              const uint32_t (&c)[T]) {
  uint32_t p[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint32_t mask = 0u - ((c[j] >> bit) & 1u);
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[j][l] ^= p[l] & mask;
    }
    if (bit < 7) {
#pragma unroll
      for (int l = 0; l < 4; ++l) p[l] = swar_xtime(p[l]);
    }
  }
}

// K, M > 0: compile-time shape (all k loads first, m accumulators in
// registers); K == M == 0: runtime m, k, kRuntimeTile rows in flight and
// output rows a pass.
template <int K, int M, bool VEC>
__global__ void __launch_bounds__(kStripeThreads)
    stripe_gf256_kernel(const StripeCoeffs coeff, const int32_t* in, int32_t* out, int m,
                        int k, int64_t n) {
  int64_t lane, w;
  if (!stripe_lane(n, lane, w)) return;
  const int32_t* src = in + lane;
  int32_t* dst = out + lane;
  if constexpr (K > 0) {
    uint32_t v[K][4];
#pragma unroll
    for (int i = 0; i < K; ++i) load16<VEC>(src + (int64_t)i * n, w, v[i]);
    uint32_t acc[M][4] = {};
    if (!rows_zero(v)) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        uint32_t c[M];
#pragma unroll
        for (int j = 0; j < M; ++j) c[j] = coeff.c[j * K + i];
        gf_accumulate<M>(acc, v[i], c);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) store16<VEC>(dst + (int64_t)j * n, w, acc[j]);
  } else {
    for (int j0 = 0; j0 < m; j0 += kRuntimeTile) {
      uint32_t acc[kRuntimeTile][4] = {};
      for (int i0 = 0; i0 < k; i0 += kRuntimeTile) {  // kRuntimeTile rows in flight
        uint32_t v[kRuntimeTile][4];
#pragma unroll
        for (int q = 0; q < kRuntimeTile; ++q)
          if (i0 + q < k) load16<VEC>(src + (int64_t)(i0 + q) * n, w, v[q]);
        if (rows_zero(v, k - i0)) continue;
#pragma unroll
        for (int q = 0; q < kRuntimeTile; ++q) {
          if (i0 + q < k) {
            uint32_t c[kRuntimeTile];
#pragma unroll
            for (int j = 0; j < kRuntimeTile; ++j)
              c[j] = j0 + j < m ? coeff.c[(j0 + j) * k + i0 + q] : 0u;
            gf_accumulate<kRuntimeTile>(acc, v[q], c);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRuntimeTile; ++j)
        if (j0 + j < m) store16<VEC>(dst + (int64_t)(j0 + j) * n, w, acc[j]);
    }
  }
}

inline unsigned int stripe_blocks(int64_t n) {
  return (unsigned int)(((n + 3) / 4 + kStripeThreads - 1) / kStripeThreads);
}

template <bool VEC>
void launch_stripe_xor(const int32_t* in, int32_t* out, int k, int64_t n, cudaStream_t st) {
  const unsigned int blocks = stripe_blocks(n);
  switch (k) {
#define CODEC_XOR_CASE(K) \
  case K:                 \
    stripe_xor_kernel<K, VEC><<<blocks, kStripeThreads, 0, st>>>(in, out, k, n); break;
    CODEC_XOR_CASE(2) CODEC_XOR_CASE(3) CODEC_XOR_CASE(4) CODEC_XOR_CASE(5)
    CODEC_XOR_CASE(6) CODEC_XOR_CASE(7) CODEC_XOR_CASE(8)
#undef CODEC_XOR_CASE
    default:
      stripe_xor_kernel<0, VEC><<<blocks, kStripeThreads, 0, st>>>(in, out, k, n);
  }
}

template <bool VEC>
void launch_stripe_gf256(const StripeCoeffs& c, const int32_t* in, int32_t* out, int m, int k,
                         int64_t n, cudaStream_t st) {
  const unsigned int blocks = stripe_blocks(n);
#define CODEC_GF_CASE(K, M)                                                         \
  if (k == K && m == M) {                                                           \
    stripe_gf256_kernel<K, M, VEC><<<blocks, kStripeThreads, 0, st>>>(c, in, out, m, k, n); \
    return;                                                                         \
  }
  CODEC_GF_CASE(2, 2) CODEC_GF_CASE(3, 2) CODEC_GF_CASE(4, 2) CODEC_GF_CASE(5, 2)
  CODEC_GF_CASE(6, 2) CODEC_GF_CASE(7, 2) CODEC_GF_CASE(8, 2)
  CODEC_GF_CASE(3, 3) CODEC_GF_CASE(4, 4) CODEC_GF_CASE(5, 5) CODEC_GF_CASE(6, 6)
  CODEC_GF_CASE(7, 7) CODEC_GF_CASE(8, 8)
#undef CODEC_GF_CASE
  stripe_gf256_kernel<0, 0, VEC><<<blocks, kStripeThreads, 0, st>>>(c, in, out, m, k, n);
}

inline int finish(cudaStream_t st, int sync) {
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && sync) err = cudaStreamSynchronize(st);
  return (int)err;
}

inline unsigned int blocks_for(int64_t work) {
  return (unsigned int)((work + kThreads - 1) / kThreads);
}

}  // namespace

// C interface: pointers and the stream as void*, sizes as int / long long.

extern "C" int codec_xor_reduce(const void* in, void* out, long long S, int k,
                                long long n, int vec, void* stream) {
  const int64_t nv = (n + 3) / 4;
  const int64_t work = (int64_t)S * nv;
  if (work == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    xor_reduce_kernel<true><<<blocks_for(work), kThreads, 0, st>>>(
        static_cast<const int32_t*>(in), static_cast<int32_t*>(out), S, k, n, nv);
  else
    xor_reduce_kernel<false><<<blocks_for(work), kThreads, 0, st>>>(
        static_cast<const int32_t*>(in), static_cast<int32_t*>(out), S, k, n, nv);
  return (int)cudaGetLastError();
}

extern "C" int codec_gf256_matmul(const void* coeff, const void* in, void* out,
                                  int m, int k, long long S, long long n,
                                  int vec, void* stream) {
  const int64_t nv = (n + 3) / 4;
  const int64_t work = (int64_t)S * nv;
  if (work == 0 || m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(uint32_t) * (size_t)m * (size_t)k;
  if (vec)
    gf256_matmul_kernel<true><<<blocks_for(work), kThreads, smem, st>>>(
        static_cast<const int32_t*>(coeff), static_cast<const int32_t*>(in),
        static_cast<int32_t*>(out), m, k, S, n, nv);
  else
    gf256_matmul_kernel<false><<<blocks_for(work), kThreads, smem, st>>>(
        static_cast<const int32_t*>(coeff), static_cast<const int32_t*>(in),
        static_cast<int32_t*>(out), m, k, S, n, nv);
  return (int)cudaGetLastError();
}

// One stripe: (k, n) -> (n,) at `out`.  `in` and `out` are device addresses
// (of device memory, or of pinned host memory the card maps); `sync` as in
// the header.
extern "C" int codec_stripe_xor(const void* in, void* out, int k, long long n, int vec,
                                void* stream, int sync) {
  if (k < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(in);
  int32_t* dst = static_cast<int32_t*>(out);
  if (vec)
    launch_stripe_xor<true>(src, dst, k, n, st);
  else
    launch_stripe_xor<false>(src, dst, k, n, st);
  return finish(st, sync);
}

// One stripe: (m, k) coefficients x (k, n) -> (m, n).  `coeff` is a HOST
// pointer to m * k int32 coefficients in [0, 256), row-major; they are
// copied into the launch's parameters (m * k <= kMaxStripeCoeffs, else
// cudaErrorInvalidValue).  `in`, `out` and `sync` as codec_stripe_xor.
extern "C" int codec_stripe_gf256(const int32_t* coeff, int m, int k, const void* in, void* out,
                                  long long n, int vec, void* stream, int sync) {
  if (m < 0 || k < 0 || n < 0 || (long long)m * k > kMaxStripeCoeffs)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return 0;
  StripeCoeffs c{};
  for (int i = 0; i < m * k; ++i) c.c[i] = (uint8_t)coeff[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(in);
  int32_t* dst = static_cast<int32_t*>(out);
  if (vec)
    launch_stripe_gf256<true>(c, src, dst, m, k, n, st);
  else
    launch_stripe_gf256<false>(c, src, dst, m, k, n, st);
  return finish(st, sync);
}

// The card's address of pinned host memory at `host` (allocated by
// cudaHostAlloc or registered), into *dev.  Not assumed equal to `host`.
extern "C" int codec_host_device_pointer(void* host, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, host, 0);
}

// Whether the current device can map pinned host memory, into *can.
extern "C" int codec_can_map_host_memory(int* can) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(can, cudaDevAttrCanMapHostMemory, dev);
  return (int)err;
}
