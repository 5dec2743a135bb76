// Grouped-pair closest hit for Hopper (sm_90a).
//
// Replaces the prototype Pallas kernel
//   experiments/proto_grouped.py  _grouped_kernel  (driven by trace_grouped)
// On the TPU an XLA-built schedule -- per tile of 1024 coherent rays, every
// triangle block that some ray of the tile may hit, front to back -- became a
// flat (tile, block) pair list walked by a sequential grid, one split-bf16
// matmul per pair, the best hit carried between grid steps as packed
// (t | row) keys.  Here the same schedule (built by tensor ops in
// experiments/proto_grouped.py build_schedule of the port) is walked by one
// CUDA block per tile, since CUDA blocks run in no order: the block loops over
// its tile's segment of the pair list, stages the pair's 25 x 256 feature
// floats in shared memory (ch::stage_block), and every ray of the tile that
// is still in the running tests them in exact f32 (ch::test_block; lexicographic
// (t, tri), as ops/closest_hit.trace_plain).  A ray is in the running while its
// best t is not below the pair's lod, the least entry distance of the tile's
// rays into that block; the tile stops once no ray is (a block-wide
// __syncthreads_and, the TPU's per-step `run` test).  lod only grows along a
// tile's list and the entry is margined, so the stop is exact.
// One thread per ray, RT threads per CUDA block (RT = the tile, 32..1024).
// What bounds it on an H100: FP32 operations, about 45 per (ray, triangle) pair
// tested, at 67 TFLOP/s; rays, the pair list and the features (read once per
// staging, from L2) are small beside them.  The design keeps the TPU
// schedule as it was (no per-ray cull inside a tile; at RT = 1024 and 65,536
// rays only 64 CUDA blocks, on fewer than half of the 132 SMs): it is the
// prototype, ported to compare schedules, not tuned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

constexpr int MAX_RT = 1024;

__global__ void __launch_bounds__(MAX_RT)
grouped_pairs_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                     ch::Feats f, const int* __restrict__ offsets, const int* __restrict__ blk,
                     const float* __restrict__ lod, float* __restrict__ out_t,
                     int* __restrict__ out_tri, unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float feat[ch::FEAT_ROWS * ch::TRI_TILE];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_rays;
  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = active ? ray_o[3 * i + k] : 0.0f;
    d[k] = active ? ray_d[3 * i + k] : (k == 2 ? 1.0f : 0.0f);
  }
  const ch::Ray r = ch::make_ray(o, d);
  float best_t = ch::MAX_DIST;
  int best_i = 0;
  unsigned long long pairs = 0, stagings = 0;

  const int end = offsets[blockIdx.x + 1];
  for (int s = offsets[blockIdx.x]; s < end; ++s) {
    const float l = lod[s];
    // every thread reaches this barrier, dead lanes included; it also keeps
    // the previous block's features in use until every lane is done with them
    if (__syncthreads_and(!active || best_t < l)) break;
    const int j = blk[s];
    ch::stage_block(f, j, feat);
    ++stagings;
    __syncthreads();
    if (active && !(best_t < l)) {
      pairs += f.tile;
      ch::test_block(r, feat, j * f.tile, f.tile, best_t, best_i);
    }
  }

  if (active) {
    const bool hit = best_t < ch::MISS_T;
    out_t[i] = hit ? best_t : ch::MAX_DIST;
    out_tri[i] = hit ? best_i : 0;
  }
  if (stats != nullptr) {
    for (int off = 16; off > 0; off >>= 1) pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(&stats[0], pairs);
    if (threadIdx.x == 0 && stagings) atomicAdd(&stats[1], stagings);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*): `tiles` CUDA blocks of
// `rt` threads over rays [tiles * rt, 3] (only the first n_rays are read).
// `offsets` [tiles + 1], `blk` and `lod` [offsets[tiles]...] are the schedule.
// `stats` may be null, else it receives [pairs tested, block stagings]
// (added).  Returns the cudaError_t of the launch (0 on success).
extern "C" int grouped_pairs_launch(const float* ray_o, const float* ray_d, int n_rays, int rt,
                                    const float* edges, const float* plane, const float* normal_d,
                                    const float* bounds, int tp, int tile, int nb,
                                    const int* offsets, const int* blk, const float* lod,
                                    int tiles, float* out_t, int* out_tri,
                                    unsigned long long* stats, void* stream) {
  if (n_rays <= 0) return 0;
  if (rt < 32 || rt > MAX_RT || rt % 32 != 0 || (long long)tiles * rt < n_rays ||
      tile <= 0 || tile > ch::TRI_TILE || nb <= 0 || tile * nb != tp)
    return (int)cudaErrorInvalidValue;
  const ch::Feats f{edges, plane, normal_d, bounds, tp, tile, nb, 1};
  grouped_pairs_kernel<<<tiles, rt, 0, static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, f, offsets, blk, lod, out_t, out_tri, stats);
  return (int)cudaGetLastError();
}
