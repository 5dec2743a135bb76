// Pair-compaction closest hit, one round, for Hopper (sm_90a).
//
// Replaces the prototype Pallas kernel
//   experiments/proto_compact.py  _pair_kernel  (driven by trace_compact; also
//   launched by experiments/bench_pieces2.py and experiments/profile_compact2.py)
// Each round of the prototype groups the (ray, block) pairs that its rays still
// need by block, into queues padded to tiles of RT slots; one grid step tests
// one queue tile against its block with a split-bf16 matmul, writes one packed
// (t | row) key per slot, and XLA folds the keys into each ray's best with a
// scatter-min.  Here the queues are the same (built by tensor ops in
// experiments/proto_compact.py build_round_queues of the port), and the fold is
// inside the kernel.  Each tile of rt slots is cut into sub-tiles of sub slots
// (sub_width: min(SUB, rt) when that divides rt; SUB = 128, which ran 4-6 %
// faster than 256 on an H100, and 64 slower), one CUDA block each:
//   1. exit: the queue writes a block's real slots first and its padding after,
//      so a sub-tile whose tile is dead or whose first slot is padding holds no
//      real slot and returns at once, all its threads together, before any
//      barrier;
//   2. staging: one thread issues a TMA bulk copy (cp.async.bulk, completion on
//      an mbarrier) of the tile's block of packed features (TriFeatures.packed:
//      256 triangles x 28 floats, 28,672 contiguous bytes), and the copy lands
//      while every thread gathers its slot's ray (queue_rid == n is padding)
//      into shared memory;
//   3. test: the sub-tile's A real slots (a prefix of it) are paired (slots a
//      and a + P, P = ceil(A / 2)), the block's triangles are cut into
//      C = sub / P chunks, and the P x C (slot pair, chunk) items are spread
//      over the threads, neighbouring threads on neighbouring pairs of one
//      chunk, so one broadcast read of a triangle's features feeds two pair
//      tests; the pair test is ch::test_packed's, term for term, exact f32;
//   4. fold: each slot's best hit is a 64-bit key (float bits of t) << 32 | tri
//      in shared memory, lowered with atomicMin by each item that found one,
//      then one global atomicMin per real slot that found a hit lowers its
//      ray's best_key.  Exact in any order: the keys order (t, tri)
//      lexicographically, since t > MIN_HIT_DIST > 0.  Padding slots and dead
//      sub-tiles write nothing.  No item reads best_key, so the work and the
//      counts do not depend on the order in which CUDA blocks run.
// What bounds it on an H100: FP32 operations, about 45 per (ray, triangle) pair
// the closest hit needs, at 67 TFLOP/s; rays, slots, keys and one staging of a
// block per sub-tile (from L2) are small beside them.  What holds it instead is
// instruction issue in the pair test (two slots per item halve its shared
// reads) and, per round, a launch whose tail rounds hold few real slots.  The
// price of the design is outside the kernel: the slab test and sort of every
// ray against every block, a queue build and a host sync per round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

constexpr int MAX_RT = 1024;
constexpr int SUB = 128;                        // slots per sub-tile, at most
constexpr int BUF4 = ch::TRI_TILE * ch::PACK4;  // float4s of one staged block

// Dynamic shared memory of a CUDA block of `sub` threads: the feature buffer,
// then per slot two float4s and a float of its ray and its key, then the
// mbarrier.
__host__ __device__ constexpr size_t smem_bytes(int sub) {
  return BUF4 * 16 + sub * (32 + 8 + 4) + 8;
}

__global__ void __launch_bounds__(SUB, 6)
pair_compact_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                    const float4* __restrict__ packed, int tile,
                    const long long* __restrict__ queue_rid, const int* __restrict__ tile_blk,
                    const int* __restrict__ tile_live, int per_tile,
                    unsigned long long* __restrict__ best_key,
                    unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(128) float4 smem[];
  const int sub = blockDim.x, r = threadIdx.x;
  const int g = blockIdx.x / per_tile;
  const long long slot0 = static_cast<long long>(blockIdx.x) * sub;
  // 1. every thread reads the same two words: the CUDA block leaves together
  if (!tile_live[g]) return;
  const long long first = queue_rid[slot0];
  if (first < 0 || first >= n_rays) return;

  float4* buf = smem;                           // [BUF4] the block's packed features
  float4* q0 = smem + BUF4;                     // [sub] r6[0..3] (r6[0..2] = d)
  float4* q1 = q0 + sub;                        // [sub] r6[4..5], o[0..1]
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(q1 + sub);  // [sub]
  float* oz = reinterpret_cast<float*>(keys + sub);                            // [sub] o[2]
  uint64_t* bar = reinterpret_cast<uint64_t*>(oz + sub);

  // 2. the copy first, so that it lands while the rays are gathered
  const int j = tile_blk[g];
  if (r == 0) {
    ch::init_bar(bar);
    ch::bulk_copy(buf, packed + static_cast<size_t>(j) * tile * ch::PACK4,
                  static_cast<uint32_t>(tile) * ch::PACK4 * 16, bar);
  }
  const long long rid = queue_rid[slot0 + r];
  const bool real = rid >= 0 && rid < n_rays;
  if (real) {
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = ray_o[3 * rid + k];
      d[k] = ray_d[3 * rid + k];
    }
    const ch::Ray ray = ch::make_ray(o, d);
    q0[r] = make_float4(ray.r6[0], ray.r6[1], ray.r6[2], ray.r6[3]);
    q1[r] = make_float4(ray.r6[4], ray.r6[5], ray.o[0], ray.o[1]);
    oz[r] = ray.o[2];
  }
  const unsigned long long no_hit = ch::hit_key(ch::MAX_DIST, 0);
  keys[r] = no_hit;
  // the real slots are the first n_real (build_round_queues writes them first)
  const int n_real = __syncthreads_count(real);
  ch::wait_parity(bar, 0);

  // 3. (slot pair, chunk) items: slots a and a + P, C chunks of `span`
  // triangles; at most one item per thread
  const int npair = (n_real + 1) / 2;
  const int chunks = max(1, sub / npair);
  const int span = (tile + chunks - 1) / chunks;
  if (r < npair * chunks) {
    const int a = r % npair, lo = (r / npair) * span, hi = min(lo + span, tile);
    const bool two = a + npair < n_real;
    const int slot[2] = {a, two ? a + npair : a};
    float r6[2][6], ro[2][3], best_t[2] = {ch::MAX_DIST, ch::MAX_DIST};
    int best_i[2] = {0, 0};
    bool found[2] = {false, false};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 x0 = q0[slot[k]], x1 = q1[slot[k]];
      const float v[9] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w, oz[slot[k]]};
#pragma unroll
      for (int m = 0; m < 6; ++m) r6[k][m] = v[m];
#pragma unroll
      for (int m = 0; m < 3; ++m) ro[k][m] = v[6 + m];
    }
    ch::test_two(buf, j * tile, lo, hi, r6, ro, best_t, best_i, found);
    if (found[0]) atomicMin(&keys[slot[0]], ch::hit_key(best_t[0], best_i[0]));
    if (two && found[1]) atomicMin(&keys[slot[1]], ch::hit_key(best_t[1], best_i[1]));
  }
  __syncthreads();

  // 4. one global fold per real slot that found a hit
  if (real && keys[r] != no_hit) atomicMin(&best_key[rid], keys[r]);
  if (stats != nullptr && r == 0) {
    atomicAdd(&stats[0], static_cast<unsigned long long>(n_real) * tile);
    atomicAdd(&stats[1], 1ull);
  }
}

// Slots per sub-tile for tiles of rt slots: the largest multiple of 32 that
// divides rt, at most SUB (min(SUB, rt) for rt <= SUB or a multiple of SUB).
int sub_width(int rt) {
  for (int s = SUB; s > 32; s -= 32)
    if (rt % s == 0) return s;
  return 32;
}

bool bad_rt(int rt) { return rt < 32 || rt > MAX_RT || rt % 32 != 0; }

}  // namespace

// The launch geometry for `tiles` tiles of `rt` slots: out = [CUDA blocks,
// threads each, dynamic shared memory bytes each, CUDA blocks resident per SM
// (the occupancy API)].  Returns the cudaError_t of the query.
extern "C" int pair_compact_plan(int rt, int tiles, int* out) {
  if (bad_rt(rt) || tiles < 0) return (int)cudaErrorInvalidValue;
  const int sub = sub_width(rt);
  out[0] = tiles * (rt / sub);
  out[1] = sub;
  out[2] = (int)smem_bytes(sub);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], pair_compact_kernel, sub,
                                                            smem_bytes(sub));
}

// Launch on `stream` (a cudaStream_t passed as void*): tiles * (rt / sub)
// CUDA blocks of sub = sub_width(rt) threads, one per queue slot.  Rays
// [n_rays, 3]; `packed` [tp, 28] (TriFeatures.packed, 16-byte aligned);
// queue_rid [tiles * rt] (n_rays on a padding slot; each block's real slots
// first), tile_blk and tile_live [tiles].  best_key [n_rays + 1] is lowered in
// place (row n_rays is never written).  `stats` may be null, else it receives
// [pairs tested, block stagings (one per sub-tile that runs)] (added).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pair_compact_launch(const float* ray_o, const float* ray_d, int n_rays,
                                   const float* packed, int tp, int tile, int nb,
                                   const long long* queue_rid, const int* tile_blk,
                                   const int* tile_live, int tiles, int rt, long long* best_key,
                                   unsigned long long* stats, void* stream) {
  if (tiles <= 0 || n_rays <= 0) return 0;
  if (bad_rt(rt) || tile <= 0 || tile > ch::TRI_TILE || nb <= 0 || tile * nb != tp ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int sub = sub_width(rt);
  pair_compact_kernel<<<tiles * (rt / sub), sub, smem_bytes(sub),
                        static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, reinterpret_cast<const float4*>(packed), tile, queue_rid, tile_blk,
      tile_live, rt / sub, reinterpret_cast<unsigned long long*>(best_key), stats);
  return (int)cudaGetLastError();
}
