// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants) and the
// port's uniform stream, shared by csrc/rng.cu and csrc/fused_sample.cu so
// that both draw the same numbers.  Contract (ops/rng.py): element f of
// the stream (key, sample) is philox(ctr=(f >> 2, sample, 0, 0), key)[f & 3]
// >> 8, times 2^-24: a float in [0, 1) with 24 significant bits.
#pragma once
#include <stdint.h>

namespace philox {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_unit(unsigned w) {
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ unsigned word(const uint4& c, int i) {
  return i == 0 ? c.x : i == 1 ? c.y : i == 2 ? c.z : c.w;
}

// The four uniforms of counter block `blk` (flat indices 4 blk .. 4 blk + 3).
__device__ __forceinline__ uint4 block(unsigned long long blk, unsigned sample, uint2 key) {
  return philox4x32_10(make_uint4(static_cast<unsigned>(blk), sample, 0u, 0u), key);
}

}  // namespace philox
