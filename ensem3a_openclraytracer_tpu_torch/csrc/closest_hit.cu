// Closest hit of rays on a one-block scene for Hopper (sm_90a): the resident
// kernel, closest-hit role #1.
//
// Replaces the one-block Pallas kernel of the JAX package:
//   ensem3a_openclraytracer_tpu/ops/intersect_mxu.py  _mxu_kernel  (1 block)
// whose block lived in VMEM.  Here each CUDA block stages the scene's packed
// features (TriFeatures.packed) once in shared memory and each thread tests
// RPT rays against them with ch::test_packed, the test of
// csrc/fused_sample.cu; no cull, sort or visit list is needed.  It computes
// what trace_plain (ops/closest_hit.py) computes, in exact f32 (no bf16
// split, no packed keys, no matmul).  Scenes of more blocks take the block
// queues of csrc/pairs.cu (roles #3 and #4); ops/closest_hit.resident picks.
// What bounds it on an H100: FP32 operations, about 51 per (ray, triangle)
// pair tested (three 6-term and two 3/4-term dot products, one divide), at
// 67 TFLOP/s; the bytes (rays in, t/tri out, features read once per CUDA
// block from L2) are small beside them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

constexpr int RAYS = 128;
constexpr int RPT = 2;  // rays per thread of the resident kernel

// nb == 1: the block's features resident in shared memory; RAYS * RPT rays
// per CUDA block, ray blockIdx.x * RAYS * RPT + k * RAYS + threadIdx.x.
__global__ void __launch_bounds__(RAYS)
resident_hit_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                    const float4* __restrict__ packed, const float* __restrict__ bounds, int tile,
                    float* __restrict__ out_t, int* __restrict__ out_tri,
                    unsigned long long* __restrict__ stats) {
  __shared__ float4 feat[ch::PACKED_BUF4];
  ch::stage_packed(packed, tile, feat);
  __syncthreads();

  ch::Ray r[RPT];
  bool act[RPT];
  float best_t[RPT];
  int best_i[RPT];
  unsigned long long pairs = 0;
  bool any = false;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = blockIdx.x * RAYS * RPT + k * RAYS + threadIdx.x;
    const bool in_range = i < n_rays;
    float o[3], d[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[j] = in_range ? ray_o[3 * i + j] : 0.0f;
      d[j] = in_range ? ray_d[3 * i + j] : (j == 2 ? 1.0f : 0.0f);
    }
    r[k] = ch::make_ray(o, d);
    act[k] = in_range && ch::block_entry(r[k], bounds, 0) <= ch::MAX_DIST;
    best_t[k] = ch::MAX_DIST;
    best_i[k] = 0;
    if (act[k]) pairs += tile;
    any = any || act[k];
  }
  if (any) ch::test_packed(feat, 0, tile, r, act, best_t, best_i);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = blockIdx.x * RAYS * RPT + k * RAYS + threadIdx.x;
    if (i < n_rays) {
      const bool hit = best_t[k] < ch::MISS_T;
      out_t[i] = hit ? best_t[k] : ch::MAX_DIST;
      out_tri[i] = hit ? best_i[k] : 0;
    }
  }
  if (stats != nullptr) {
    for (int off = 16; off > 0; off >>= 1) pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(&stats[0], pairs);
    if (threadIdx.x == 0) atomicAdd(&stats[1], 1ull);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*) on one triangle block
// (nb == 1, tile == tp) of packed features ([tp, 28] f32, 16-byte aligned);
// any other nb is cudaErrorInvalidValue.  `stats` may be null, else it
// receives [pairs tested, block stagings] (added).  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int closest_hit_launch(const float* ray_o, const float* ray_d, int n_rays,
                                  const float* packed, const float* bounds, int tp, int tile,
                                  int nb, float* out_t, int* out_tri, unsigned long long* stats,
                                  void* stream) {
  if (n_rays <= 0) return 0;
  if (tile <= 0 || tile > ch::TRI_TILE || nb != 1 || tile != tp || packed == nullptr)
    return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + RAYS * RPT - 1) / (RAYS * RPT);
  resident_hit_kernel<<<grid, RAYS, 0, static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, reinterpret_cast<const float4*>(packed), bounds, tile, out_t, out_tri,
      stats);
  return (int)cudaGetLastError();
}
