// Uniform random numbers for Hopper (sm_90a): the port's Philox stream.
//
// Replaces the JAX package's TPU kernel
//   ensem3a_openclraytracer_tpu/ops/rng.py  _rng_kernel (uniforms_tpu)
// which fills [rows, 128] with the top 24 bits of the TPU core's hardware
// PRNG.  Here each thread computes one Philox4x32-10 counter block (four
// uniforms) of the stream in csrc/philox.cuh and stores it as one 16-byte
// write, so neighbouring threads write neighbouring addresses.
// What bounds it on an H100: the 4 bytes written per uniform at 3.35 TB/s,
// and about as much the 32-bit integer work (10 rounds of two 32x32->64
// products and two 3-way XORs, nine key bumps: ~70 integer instructions
// per block of four) at 64 integer lanes per SM.  Nothing is read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
uniforms_kernel(const unsigned* __restrict__ key_words, unsigned sample,
                float* __restrict__ out, long long n) {
  const uint2 key = make_uint2(key_words[0], key_words[1]);
  const long long n_blocks = (n + 3) >> 2;
  for (long long b = blockIdx.x * (long long)THREADS + threadIdx.x; b < n_blocks;
       b += (long long)gridDim.x * THREADS) {
    const uint4 w = philox::block(static_cast<unsigned long long>(b), sample, key);
    const long long f = b << 2;
    if (f + 3 < n) {
      *reinterpret_cast<float4*>(out + f) = make_float4(
          philox::to_unit(w.x), philox::to_unit(w.y), philox::to_unit(w.z), philox::to_unit(w.w));
    } else {
      for (int i = 0; f + i < n; ++i) out[f + i] = philox::to_unit(philox::word(w, i));
    }
  }
}

}  // namespace

// Fill out[0 .. n) (float32, 16-byte aligned) with the stream of
// (key_words[0..1] on the card, sample) on `stream`.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int uniforms_launch(const unsigned* key_words, int sample, float* out, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const long long n_blocks = (n + 3) >> 2;
  long long grid = (n_blocks + THREADS - 1) / THREADS;
  if (grid > 132 * 64) grid = 132 * 64;  // grid-stride beyond 64 CTAs per SM
  uniforms_kernel<<<(unsigned)grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      key_words, static_cast<unsigned>(sample), out, n);
  return (int)cudaGetLastError();
}
