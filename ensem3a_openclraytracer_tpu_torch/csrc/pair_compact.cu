// Pair-compaction closest hit, one round, for Hopper (sm_90a).
//
// Replaces the prototype Pallas kernel
//   experiments/proto_compact.py  _pair_kernel  (driven by trace_compact; also
//   launched by experiments/bench_pieces2.py and experiments/profile_compact2.py)
// Each round of the prototype groups the (ray, block) pairs that its rays still
// need by block, into queues padded to tiles of RT slots; one grid step tests
// one queue tile against its block with a split-bf16 matmul on block-recentred
// features, gathered rays o_q / d_q made by XLA, and packed (t | row) keys.
// Here one CUDA block takes one queue tile (the queues are built by tensor ops
// in experiments/proto_compact.py build_round_queues of the port): a dead tile
// writes "no hit" and returns; a live tile stages its one block's 25 x 256
// feature floats in shared memory once (ch::stage_block), and each thread
// gathers its slot's ray through queue_rid (no o_q / d_q copy; queue_rid == n
// is a padding slot) and tests it in exact f32 (ch::test_block; lexicographic
// (t, tri), as ops/closest_hit.trace_plain).  It writes one int64 key per slot,
// (float bits of t) << 32 | tri, which orders (t, tri) lexicographically for
// t >= 0, so the per-ray combine is one scatter-min.
// One thread per slot, RT threads per CUDA block (32..1024).
// What bounds it on an H100: FP32 operations, about 45 per (ray, triangle) pair
// tested, at 67 TFLOP/s; slots, rays and keys (8 + 24 + 8 bytes per slot) and
// the features (read once per live tile, from L2) are small beside them.  The
// design: a queue tile shares one block, so each staging serves up to RT rays
// and no ray tests a block its own slab test failed; the price is the queue
// build and a host sync per round outside the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

constexpr int MAX_RT = 1024;

__device__ __forceinline__ long long hit_key(float t, int tri) {
  return (static_cast<long long>(__float_as_uint(t)) << 32) | static_cast<unsigned>(tri);
}

__global__ void __launch_bounds__(MAX_RT)
pair_compact_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                    ch::Feats f, const long long* __restrict__ queue_rid,
                    const int* __restrict__ tile_blk, const int* __restrict__ tile_live,
                    long long* __restrict__ out_key, unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float feat[ch::FEAT_ROWS * ch::TRI_TILE];

  const long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the whole CUDA block leaves together: no barrier is reached by part of it
  if (!tile_live[blockIdx.x]) {
    out_key[slot] = hit_key(ch::MAX_DIST, 0);
    return;
  }
  const int j = tile_blk[blockIdx.x];
  ch::stage_block(f, j, feat);
  __syncthreads();

  const long long rid = queue_rid[slot];
  float best_t = ch::MAX_DIST;
  int best_i = 0;
  unsigned long long pairs = 0;
  if (rid >= 0 && rid < n_rays) {
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = ray_o[3 * rid + k];
      d[k] = ray_d[3 * rid + k];
    }
    const ch::Ray r = ch::make_ray(o, d);
    ch::test_block(r, feat, j * f.tile, f.tile, best_t, best_i);
    pairs = f.tile;
  }
  out_key[slot] = hit_key(best_t, best_i);  // MAX_DIST, 0 when nothing was hit

  if (stats != nullptr) {
    for (int off = 16; off > 0; off >>= 1) pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(&stats[0], pairs);
    if (threadIdx.x == 0) atomicAdd(&stats[1], 1ull);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*): `tiles` CUDA blocks of
// `rt` threads, one per queue slot.  queue_rid [tiles * rt] (n_rays on a
// padding slot), tile_blk and tile_live [tiles]; out_key [tiles * rt].
// `stats` may be null, else it receives [pairs tested, block stagings]
// (added).  Returns the cudaError_t of the launch (0 on success).
extern "C" int pair_compact_launch(const float* ray_o, const float* ray_d, int n_rays,
                                   const float* edges, const float* plane, const float* normal_d,
                                   const float* bounds, int tp, int tile, int nb,
                                   const long long* queue_rid, const int* tile_blk,
                                   const int* tile_live, int tiles, int rt, long long* out_key,
                                   unsigned long long* stats, void* stream) {
  if (tiles <= 0) return 0;
  if (rt < 32 || rt > MAX_RT || rt % 32 != 0 || tile <= 0 || tile > ch::TRI_TILE || nb <= 0 ||
      tile * nb != tp)
    return (int)cudaErrorInvalidValue;
  const ch::Feats f{edges, plane, normal_d, bounds, tp, tile, nb, 1};
  pair_compact_kernel<<<tiles, rt, 0, static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, f, queue_rid, tile_blk, tile_live, out_key, stats);
  return (int)cudaGetLastError();
}
