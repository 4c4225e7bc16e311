// Stripe-codec kernels for Hopper (sm_90a): XOR parity and GF(256) matmul.
//
// Both kernels work on int32 lanes that pack four bytes each, exactly as the
// host arenas do, and are built by kernels/_build.py into one shared library
// with a plain C interface (loaded with ctypes; no PyTorch headers).
//
// Lane ownership: each thread owns 16 bytes (four int32 lanes) of one
// stripe's output.  When every row starts on a 16-byte boundary (n % 4 == 0
// and aligned base pointers: the wrapper passes `vec`), the thread moves its
// lanes with one 128-bit load per input row and one 128-bit store per output
// row; otherwise it falls back to scalar loads.  Either way the ragged tail
// (n not a multiple of 4) is masked here, so any n >= 1 works.  Offsets are
// 64-bit: a whole-zone rebuild decode is ~1e8 lanes.
//
// Both kernels are memory-bound on an H100: each input byte is read once and
// each output byte written once, and the per-byte work (one XOR, or 8 SWAR
// double-and-add steps per coefficient) is far below the card's integer rate.
// They are written simple and right; the speed work (wider tiles, cp.async
// pipelines, pinned arenas) is for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------- XOR reduce
//
// Replaces kernels/parity_xor.py::parity_xor_batch (and ::parity_xor, which
// is this kernel launched with S = 1): (S, k, n) int32 -> (S, n) int32.
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
// Replaces kernels/gf256_matmul.py::gf256_matmul_batch (and ::gf256_matmul,
// this kernel launched with S = 1): (m, k) coefficients x (S, k, n) -> (S, m,
// n), four GF(256) bytes per lane, field polynomial 0x11d.
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

inline unsigned int blocks_for(int64_t work) {
  return (unsigned int)((work + kThreads - 1) / kThreads);
}

}  // namespace

// C interface.  Each function launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched); it never synchronizes.

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
