// The copy design of a single-stripe codec round trip, for
// scripts/stripe_designs.py to time against the design the port uses (the
// kernel on pinned host memory the card maps), and write-combined mapped
// buffers for the same comparison.
//
// It reaches the port's kernels only through the library's C entries
// (codec_stripe_xor, codec_stripe_gf256), so both designs run the same
// kernels.  The script builds it with nvcc into build/stripe_designs/,
// linked against the port's library; it is not part of the port.
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int codec_stripe_xor(const void* in, void* out, int k, long long n, int vec,
                                void* stream, int sync);
extern "C" int codec_stripe_gf256(const int32_t* coeff, int m, int k, const void* in, void* out,
                                  long long n, int vec, void* stream, int sync);

// Pinned host (k, n) in -> device scratch (cudaMemcpyAsync), the stripe
// kernel on the scratch (GF(256) with the (m, k) host coefficients `coeff`,
// XOR when it is null), the (m, n) result -> host (cudaMemcpyAsync), one
// stream sync: the whole round trip in one call.
extern "C" int design_copies(const int32_t* coeff, int m, int k, const void* host_in,
                             void* host_out, void* dev_in, void* dev_out, long long n,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemcpyAsync(dev_in, host_in, 4ull * k * n, cudaMemcpyHostToDevice, st);
  if (err) return err;
  err = coeff ? codec_stripe_gf256(coeff, m, k, dev_in, dev_out, n, 1, stream, 0)
              : codec_stripe_xor(dev_in, dev_out, k, n, 1, stream, 0);
  if (err) return err;
  err = (int)cudaMemcpyAsync(host_out, dev_out, 4ull * m * n, cudaMemcpyDeviceToHost, st);
  if (err) return err;
  return (int)cudaStreamSynchronize(st);
}

// Mapped, write-combined pinned host memory.
extern "C" int design_host_alloc_wc(unsigned long long bytes, void** host) {
  return (int)cudaHostAlloc(host, bytes, cudaHostAllocMapped | cudaHostAllocWriteCombined);
}

extern "C" int design_host_free(void* host) { return (int)cudaFreeHost(host); }
