// Closest hit of rays on triangle blocks, shared by every closest-hit and
// fused kernel of the port.  Exact f32, as ops/closest_hit.trace_plain:
//   w_e = sum_k edges[e][k] * [d, d x o][k]  (e = AB, BC, CA)
//   inside = all w >= 0 or all w <= 0;  t = ([o,1] . plane) / (d . n)
//   hit = inside && d.n != 0 && t > MIN_HIT_DIST; closest (t, tri) in
//   lexicographic order, so ties keep the lowest triangle index whatever the
//   visit order.  t >= 0.999 * MAX_DIST is a miss (t = MAX_DIST, tri = 0).
//
// Two layouts of one block's features in shared memory, both of the rows of
// TriFeatures.packed:
//   * packed (stage_packed / test_packed): per triangle the 25 feature rows
//     of TriFeatures.packed as 6 float4s, then row 24 (the normal's z) of every
//     triangle as a float; one 16-byte broadcast read feeds 4 of a pair test's
//     ~45 FP32 operations, and each read of a triangle serves R rays.  The
//     one-block roles (csrc/closest_hit.cu, csrc/fused_sample.cu) stage their
//     block once per CUDA block and keep it; csrc/pairs.cuh stages queued
//     blocks in the same layout and tests the sub-tiles a ray enters
//     (test_range).
//   * packed rows copied whole (bulk_copy / test_two): PACK4 float4s per
//     triangle, as TriFeatures.packed holds them, copied by TMA; the two
//     prototypes' kernels (csrc/grouped_pairs.cu, csrc/pair_compact.cu)
//     test two rays per read of a triangle.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ch {

constexpr int TRI_TILE = 256;
constexpr int FEAT_ROWS = 25;  // 18 edge rows, 4 plane rows, 3 normal rows
constexpr float MAX_DIST = 1000.0f;
constexpr float MIN_HIT_DIST = 1e-4f;
constexpr float MISS_T = MAX_DIST * 0.999f;
constexpr int PACK4 = 7;  // float4s per triangle in TriFeatures.packed [tp, 28]
// One staged block in the packed layout: 6 float4s per triangle, then row 24
// of each triangle as a float (25,600 bytes); rows 25-27 are padding and stay
// in device memory.
constexpr int PACKED_BUF4 = TRI_TILE * 6 + TRI_TILE / 4;

struct Ray {
  float o[3], d[3], inv[3], r6[6];
};

// Counters a trace adds to (per lane; the kernels reduce them).
struct Counts {
  unsigned long long pairs = 0, stagings = 0, slabs = 0;
};

__device__ __forceinline__ Ray make_ray(const float o[3], const float d[3]) {
  Ray r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[k];
    r.d[k] = d[k];
    float dk = d[k];
    if (fabsf(dk) < 1e-12f) dk = dk < 0.0f ? -1e-12f : 1e-12f;
    r.inv[k] = 1.0f / dk;
    r.r6[k] = d[k];
  }
  r.r6[3] = r.d[1] * r.o[2] - r.d[2] * r.o[1];  // d x o
  r.r6[4] = r.d[2] * r.o[0] - r.d[0] * r.o[2];
  r.r6[5] = r.d[0] * r.o[1] - r.d[1] * r.o[0];
  return r;
}

// Slab test of a ray against block j's AABB, grown by its margin.  Returns
// the conservative entry distance (>= 0), or +inf when the box is missed.
__device__ __forceinline__ float block_entry(const Ray& r, const float* __restrict__ bounds, int j) {
  const float* b = bounds + 8 * j;
  if (!(b[0] <= b[3])) return __int_as_float(0x7f800000);  // padding-only block
  float tmin = -__int_as_float(0x7f800000), tmax = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t1 = (b[k] - r.o[k]) * r.inv[k];
    float t2 = (b[3 + k] - r.o[k]) * r.inv[k];
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
  }
  float eps = b[6];
  tmin = tmin - eps - 1e-6f * fabsf(tmin);
  tmax = tmax + eps + 1e-6f * fabsf(tmax);
  if (tmax >= tmin && tmax >= 0.0f) return fmaxf(tmin, 0.0f);
  return __int_as_float(0x7f800000);
}

// Copy the `tile` triangles of packed features from `src` (the block's first
// row) into f4 in the packed layout, with plain read-only loads (all threads
// of the CUDA block take part; the caller puts the barrier after it).
__device__ __forceinline__ void stage_packed(const float4* __restrict__ src, int tile, float4* f4) {
  for (int k = threadIdx.x; k < 6 * tile; k += blockDim.x) {
    const int c = k / 6;
    f4[k] = __ldg(src + c * PACK4 + (k - 6 * c));
  }
  float* fz = reinterpret_cast<float*>(f4 + 6 * TRI_TILE);
  for (int c = threadIdx.x; c < tile; c += blockDim.x)
    fz[c] = __ldg(reinterpret_cast<const float*>(src + c * PACK4 + 6));
}

// Test R rays against triangles [lo, hi) of a block staged in the packed
// layout (global index base + c for staged triangle c), each dot product
// summed term by term in index order.  Rays with act[k] false keep their best.
template <int R>
__device__ __forceinline__ void test_range(const float4* f4, int base, int lo, int hi,
                                           const Ray (&r)[R], const bool (&act)[R],
                                           float (&best_t)[R], int (&best_i)[R]) {
  const float* fz = reinterpret_cast<const float*>(f4 + 6 * TRI_TILE);
  for (int c = lo; c < hi; ++c) {
    float f[FEAT_ROWS];
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      const float4 x = f4[6 * c + v];
      f[4 * v] = x.x;
      f[4 * v + 1] = x.y;
      f[4 * v + 2] = x.z;
      f[4 * v + 3] = x.w;
    }
    f[24] = fz[c];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float w[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float acc = f[6 * e] * r[k].r6[0];
#pragma unroll
        for (int m = 1; m < 6; ++m) acc = acc + f[6 * e + m] * r[k].r6[m];
        w[e] = acc;
      }
      const bool inside = (w[0] >= 0.0f && w[1] >= 0.0f && w[2] >= 0.0f) ||
                          (w[0] <= 0.0f && w[1] <= 0.0f && w[2] <= 0.0f);
      const float den = f[22] * r[k].d[0] + f[23] * r[k].d[1] + f[24] * r[k].d[2];
      if (!act[k] || !inside || den == 0.0f) continue;
      const float num = f[18] * r[k].o[0] + f[19] * r[k].o[1] + f[20] * r[k].o[2] + f[21];
      const float t = num / den;
      const int g = base + c;
      if (t > MIN_HIT_DIST && (t < best_t[k] || (t == best_t[k] && g < best_i[k]))) {
        best_t[k] = t;
        best_i[k] = g;
      }
    }
  }
}

// Test R rays against the `tile` triangles of block `base / tile` staged in
// the packed layout.
template <int R>
__device__ __forceinline__ void test_packed(const float4* f4, int base, int tile,
                                            const Ray (&r)[R], const bool (&act)[R],
                                            float (&best_t)[R], int (&best_i)[R]) {
  test_range(f4, base, 0, tile, r, act, best_t, best_i);
}

// (float bits of t) << 32 | tri: ordered as (t, tri) for t >= 0, so a 64-bit
// atomicMin keeps the lexicographic closest hit whatever the order.
__device__ __forceinline__ unsigned long long hit_key(float t, int tri) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) | static_cast<unsigned>(tri);
}

// A block of TriFeatures.packed rows copied whole into shared memory by TMA
// (cp.async.bulk, completion on an mbarrier): PACK4 float4s per triangle,
// rows 0-23 in the first six, row 24 in the seventh's x.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier that one arrival (with its bytes) completes.  A
// barrier of the CUDA block must follow before another thread waits on it.
__device__ __forceinline__ void init_bar(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One thread: copy `bytes` (a multiple of 16) from `src` into `dst`, both
// 16-byte aligned, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// test_packed's pair test for two rays (r6 = [d, d x o], ro = o) against
// triangles [lo, hi) of a block copied whole (PACK4 float4s per triangle,
// global index base + c), one broadcast read of a triangle feeding both
// tests; best_t / best_i keep the lexicographic least (t, tri), found[k] is
// set where ray k's best changed.
__device__ __forceinline__ void test_two(const float4* f4, int base, int lo, int hi,
                                         const float (&r6)[2][6], const float (&ro)[2][3],
                                         float (&best_t)[2], int (&best_i)[2], bool (&found)[2]) {
  for (int c = lo; c < hi; ++c) {
    float f[FEAT_ROWS];
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      const float4 x = f4[PACK4 * c + v];
      f[4 * v] = x.x;
      f[4 * v + 1] = x.y;
      f[4 * v + 2] = x.z;
      f[4 * v + 3] = x.w;
    }
    f[24] = reinterpret_cast<const float*>(f4 + PACK4 * c + 6)[0];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float w[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float acc = f[6 * e] * r6[k][0];
#pragma unroll
        for (int m = 1; m < 6; ++m) acc = acc + f[6 * e + m] * r6[k][m];
        w[e] = acc;
      }
      const bool inside = (w[0] >= 0.0f && w[1] >= 0.0f && w[2] >= 0.0f) ||
                          (w[0] <= 0.0f && w[1] <= 0.0f && w[2] <= 0.0f);
      const float den = f[22] * r6[k][0] + f[23] * r6[k][1] + f[24] * r6[k][2];
      if (!inside || den == 0.0f) continue;
      const float num = f[18] * ro[k][0] + f[19] * ro[k][1] + f[20] * ro[k][2] + f[21];
      const float t = num / den;
      const int g = base + c;
      if (t > MIN_HIT_DIST && (t < best_t[k] || (t == best_t[k] && g < best_i[k]))) {
        best_t[k] = t;
        best_i[k] = g;
        found[k] = true;
      }
    }
  }
}

}  // namespace ch
