// Closest-hit kernels for Hopper (sm_90a): one-block resident and block-culled.
//
// Replaces three Pallas kernels of the JAX package, one per scene size:
//   ensem3a_openclraytracer_tpu/ops/intersect_mxu.py  _mxu_kernel        (1 block)
//   ensem3a_openclraytracer_tpu/ops/pairs.py          _tile_loop_kernel  (2-64 blocks)
//   ensem3a_openclraytracer_tpu/ops/pairs.py          _tile_stream_kernel (> 64 blocks)
// Those kernels needed a VMEM-resident or HBM-streamed operand and an XLA-built
// [rays x blocks] visit schedule; here a CUDA block of rays builds its own visit
// list and only one 256-triangle block lives in shared memory at a time, so one
// kernel covers every size.  It computes what trace_plain (ops/closest_hit.py)
// computes, in exact f32 (no bf16 split, no packed keys, no matmul), with the
// cull -> bitonic sort -> front-to-back visit of csrc/closest_hit.cuh: one
// thread per ray, RAYS rays per CUDA block, rays pre-sorted by
// ops/closest_hit.coherent_order so a block's rays are neighbours.
// A one-block scene (nb == 1, the role of _mxu_kernel) needs no cull, sort
// or visit list: resident_hit_kernel stages the block's packed features
// (TriFeatures.packed) once per CUDA block and each thread tests RPT rays
// against them with ch::test_packed, the test of csrc/fused_sample.cu.
// What bounds it on an H100: FP32 operations, about 51 per (ray, triangle)
// pair tested (three 6-term and two 3/4-term dot products, one divide), at
// 67 TFLOP/s; the bytes (rays in, t/tri out, features read once per block
// visit from L2) are small beside them.  The design keeps the pairs tested
// few by culling per CUDA block and visiting front to back; staging is not
// yet overlapped with compute (a later step: cp.async / TMA double buffers).
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

__global__ void __launch_bounds__(RAYS)
closest_hit_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                   ch::Feats f, float* __restrict__ out_t, int* __restrict__ out_tri,
                   unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* feat = reinterpret_cast<float*>(smem_raw);  // [FEAT_ROWS][TRI_TILE]
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(feat + ch::FEAT_ROWS * ch::TRI_TILE);  // [cap]
  __shared__ int n_live;

  const int i = blockIdx.x * RAYS + threadIdx.x;
  const bool active = i < n_rays;
  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = active ? ray_o[3 * i + k] : 0.0f;
    d[k] = active ? ray_d[3 * i + k] : (k == 2 ? 1.0f : 0.0f);
  }
  const ch::Ray r = ch::make_ray(o, d);
  float best_t;
  int best_i;
  ch::Counts counts;
  ch::trace_culled(f, r, active, feat, keys, &n_live, best_t, best_i, counts);

  if (active) {
    const bool hit = best_t < ch::MISS_T;
    out_t[i] = hit ? best_t : ch::MAX_DIST;
    out_tri[i] = hit ? best_i : 0;
  }
  if (stats != nullptr) {
    unsigned long long pairs = counts.pairs;
    for (int off = 16; off > 0; off >>= 1) pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(&stats[0], pairs);
    if (threadIdx.x == 0) atomicAdd(&stats[1], counts.stagings);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*).  One block (nb == 1)
// takes the resident kernel on `packed` ([tp, 28] f32, 16-byte aligned);
// more blocks the block-culled kernel on edges, plane and normal_d (`packed`
// may then be null).  `stats` may be null, else it receives [pairs tested,
// block stagings] (added).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int closest_hit_launch(const float* ray_o, const float* ray_d, int n_rays,
                                  const float* edges, const float* plane, const float* normal_d,
                                  const float* packed, const float* bounds, int tp, int tile,
                                  int nb, float* out_t, int* out_tri, unsigned long long* stats,
                                  void* stream) {
  if (n_rays <= 0) return 0;
  if (tile <= 0 || tile > ch::TRI_TILE || nb <= 0 || tile * nb != tp)
    return (int)cudaErrorInvalidValue;
  if (nb == 1) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    const int grid = (n_rays + RAYS * RPT - 1) / (RAYS * RPT);
    resident_hit_kernel<<<grid, RAYS, 0, static_cast<cudaStream_t>(stream)>>>(
        ray_o, ray_d, n_rays, reinterpret_cast<const float4*>(packed), bounds, tile, out_t,
        out_tri, stats);
    return (int)cudaGetLastError();
  }
  int cap = 1;
  while (cap < nb) cap <<= 1;
  const ch::Feats f{edges, plane, normal_d, bounds, tp, tile, nb, cap};
  const size_t smem = ch::FEAT_ROWS * ch::TRI_TILE * sizeof(float) + cap * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(closest_hit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rays + RAYS - 1) / RAYS;
  closest_hit_kernel<<<grid, RAYS, smem, static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, f, out_t, out_tri, reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}
