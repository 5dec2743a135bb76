// Grouped-pair closest hit for Hopper (sm_90a).
//
// Replaces the prototype Pallas kernel
//   experiments/proto_grouped.py  _grouped_kernel  (driven by trace_grouped)
// On the TPU an XLA-built schedule -- per tile of 1024 coherent rays, every
// triangle block that some ray of the tile may hit, front to back -- became a
// flat (tile, block) pair list walked by a sequential grid, one split-bf16
// matmul per pair, the best hit carried between grid steps as packed
// (t | row) keys.  The same schedule (built by tensor ops in
// experiments/proto_grouped.py build_schedule of the port) is walked here by
// SUB-ray sub-tiles: each tile of rt rays is cut into rt / sub CUDA blocks of
// sub = min(SUB, the largest power of two dividing rt) threads, one per ray,
// and each walks its tile's whole list.  Per pair:
//   1. stop: once none of the sub-tile's rays has a best t at or beyond the
//      pair's lod (the least entry distance of the tile's rays into its block;
//      lod only grows along a list) the sub-tile is done (__syncthreads_and);
//   2. cull: a ray takes part only if its own margined slab entry into the
//      block (ch::block_entry) is <= its best t: a block it enters beyond its
//      best t holds no nearer hit, so the result does not change;
//   3. compaction: the rays that take part are listed in shared memory (warp
//      ballots and a prefix over the warps; the warps' counts alternate
//      between two halves by pair parity, so a pair that no ray takes part in
//      ends at the stop barrier, with no list, test or further barrier);
//   4. test: the A listed rays are paired (rays a and a + P, P = ceil(A / 2)),
//      the block's triangles are cut into C = sub / P chunks, and the P x C
//      (ray pair, chunk) items are spread over all threads, neighbouring
//      threads on neighbouring pairs of one chunk, so a triangle's features
//      are one broadcast read for the warp that feeds two pair tests; the
//      pair test is ch::test_packed's, term for term;
//   5. fold: each ray's best hit is a 64-bit key (float bits of t) << 32 | tri
//      in shared memory, lowered with atomicMin by each item that improved it:
//      exact whatever the order (lexicographic (t, tri); t > MIN_HIT_DIST > 0,
//      so its bits order as unsigned integers).
// The block's packed features (TriFeatures.packed: 256 triangles x 28 floats,
// 28,672 contiguous bytes) arrive by a TMA bulk copy (cp.async.bulk, completion
// on an mbarrier) into one of two shared buffers, issued by one thread for the
// next pair while this pair is culled, compacted and tested.
// What bounds it on an H100: FP32 operations, about 45 per (ray, triangle) pair
// the closest hit needs, at 67 TFLOP/s; rays, the schedule and the features
// (read once per staging, from L2) are small beside them.  What holds it
// instead is instruction issue in the pair test (two rays per item halve the
// shared-memory reads per test) and, on long lists, the cull and barriers of
// pairs that few rays take part in.  The price of the design: a ray's state lives in shared memory,
// about 68 KB per CUDA block (two feature buffers, the rays' features and
// keys), so at most three CUDA blocks of 256 threads share an SM; a pair that
// rays take part in costs three block barriers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

constexpr int MAX_RT = 1024;
constexpr int SUB = 256;                            // rays per sub-tile, at most
constexpr int BUF4 = ch::TRI_TILE * ch::PACK4;      // float4s of one staged block
constexpr int BUF_BYTES = BUF4 * 16;                // 28,672

// Dynamic shared memory of a CUDA block of `sub` threads: two feature
// buffers, then per ray two float4s and a float of features, a key and a
// list slot, then the mbarriers and two halves of the warps' counts.
__host__ __device__ constexpr size_t smem_bytes(int sub) {
  return 2 * BUF_BYTES + sub * (32 + 4 + 8 + 4) + 2 * 8 + 2 * (sub / 32) * 4;
}

__global__ void __launch_bounds__(SUB, 3)
grouped_pairs_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                     int rt, const float4* __restrict__ packed, const float* __restrict__ bounds,
                     int tile, const int* __restrict__ offsets, const int* __restrict__ blk,
                     const float* __restrict__ lod, float* __restrict__ out_t,
                     int* __restrict__ out_tri, unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(128) float4 smem[];
  const int sub = blockDim.x;
  float4* buf = smem;                          // [2][BUF4]
  float4* q0 = smem + 2 * BUF4;                // [sub] r6[0..3] (r6[0..2] = d)
  float4* q1 = q0 + sub;                       // [sub] r6[4..5], o[0..1]
  float* oz = reinterpret_cast<float*>(q1 + sub);                              // [sub] o[2]
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(oz + sub);  // [sub]
  uint64_t* bar = reinterpret_cast<uint64_t*>(keys + sub);                     // [2]
  int* list = reinterpret_cast<int*>(bar + 2);                                 // [sub]
  int* wcnt = list + sub;                                                      // [2][sub / 32]

  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * sub + r;
  const bool active = i < n_rays;
  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = active ? ray_o[3 * i + k] : 0.0f;
    d[k] = active ? ray_d[3 * i + k] : (k == 2 ? 1.0f : 0.0f);
  }
  const ch::Ray ray = ch::make_ray(o, d);
  q0[r] = make_float4(ray.r6[0], ray.r6[1], ray.r6[2], ray.r6[3]);
  q1[r] = make_float4(ray.r6[4], ray.r6[5], ray.o[0], ray.o[1]);
  oz[r] = ray.o[2];
  keys[r] = ch::hit_key(ch::MAX_DIST, 0);
  if (r == 0) {
    ch::init_bar(bar);
    ch::init_bar(bar + 1);
  }
  __syncthreads();

  const int g = blockIdx.x / (rt / sub);
  const int first = offsets[g], len = offsets[g + 1] - first;
  const uint32_t bytes = static_cast<uint32_t>(tile) * ch::PACK4 * 16;
  if (r == 0 && len > 0)
    ch::bulk_copy(buf, packed + static_cast<size_t>(blk[first]) * tile * ch::PACK4, bytes, bar);

  unsigned long long pairs = 0, stagings = 0;
  int step = 0;
  for (; step < len; ++step) {
    const int s = first + step, j = blk[s];
    const float best = __uint_as_float(static_cast<unsigned>(keys[r] >> 32));
    const bool want = active && ch::block_entry(ray, bounds, j) <= best;
    const unsigned ball = __ballot_sync(0xffffffffu, want);
    int* cnt = wcnt + (step & 1) * (sub / 32);  // alternate halves: no barrier closes a step
    if (lane == 0) cnt[warp] = __popc(ball);
    // every thread reaches this barrier; it also ends the previous pair's
    // reads of the buffer that the next copy overwrites
    if (__syncthreads_and(!active || best < lod[s])) break;
    if (r == 0) {
      ++stagings;
      if (step + 1 < len)
        ch::bulk_copy(buf + ((step + 1) & 1) * BUF4,
                  packed + static_cast<size_t>(blk[s + 1]) * tile * ch::PACK4, bytes,
                  bar + ((step + 1) & 1));
    }
    int base = 0, n_list = 0;
    for (int w = 0; w < sub / 32; ++w) {
      const int c = cnt[w];
      base += w < warp ? c : 0;
      n_list += c;
    }
    if (n_list == 0) {  // no ray tests this block: its copy must land before the buffer is reused
      if (r == 0) ch::wait_parity(bar + (step & 1), (step >> 1) & 1);
      continue;
    }
    if (want) {
      list[base + __popc(ball & ((1u << lane) - 1u))] = r;
      pairs += tile;
    }
    __syncthreads();
    ch::wait_parity(bar + (step & 1), (step >> 1) & 1);

    // (ray pair, chunk) items: rays a and a + P of the list (P = half the
    // list, rounded up), C chunks of L triangles; at most one item per thread
    const int npair = (n_list + 1) / 2;
    const int chunks = max(1, sub / npair);
    const int span = (tile + chunks - 1) / chunks;
    if (r < npair * chunks) {
      const int a = r % npair, lo = (r / npair) * span, hi = min(lo + span, tile);
      const bool two = a + npair < n_list;
      const int slot[2] = {list[a], two ? list[a + npair] : list[a]};
      float r6[2][6], ro[2][3], best_t[2];
      int best_i[2];
      bool found[2] = {false, false};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 x0 = q0[slot[k]], x1 = q1[slot[k]];
        const float v[9] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w, oz[slot[k]]};
#pragma unroll
        for (int m = 0; m < 6; ++m) r6[k][m] = v[m];
#pragma unroll
        for (int m = 0; m < 3; ++m) ro[k][m] = v[6 + m];
        const unsigned long long key = keys[slot[k]];
        best_t[k] = __uint_as_float(static_cast<unsigned>(key >> 32));
        best_i[k] = static_cast<int>(key & 0xffffffffu);
      }
      ch::test_two(buf + (step & 1) * BUF4, j * tile, lo, hi, r6, ro, best_t, best_i, found);
      if (found[0]) atomicMin(&keys[slot[0]], ch::hit_key(best_t[0], best_i[0]));
      if (two && found[1]) atomicMin(&keys[slot[1]], ch::hit_key(best_t[1], best_i[1]));
    }
    __syncthreads();
  }
  // a copy still in flight (the pair the sub-tile stopped at) must land
  // before the CUDA block's shared memory is given back
  if (r == 0 && step < len) ch::wait_parity(bar + (step & 1), (step >> 1) & 1);

  if (active) {
    const unsigned long long key = keys[r];
    const float t = __uint_as_float(static_cast<unsigned>(key >> 32));
    const bool hit = t < ch::MISS_T;
    out_t[i] = hit ? t : ch::MAX_DIST;
    out_tri[i] = hit ? static_cast<int>(key & 0xffffffffu) : 0;
  }
  if (stats != nullptr) {
    for (int off = 16; off > 0; off >>= 1) pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    if (lane == 0 && pairs) atomicAdd(&stats[0], pairs);
    if (r == 0 && stagings) atomicAdd(&stats[1], stagings);
  }
}

// Sub-tile width for tiles of rt rays: the largest power of two dividing rt,
// at most SUB.
int sub_width(int rt) { return (rt & -rt) < SUB ? (rt & -rt) : SUB; }

// Lets the kernel take its dynamic shared memory (above the 48 KB default).
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(grouped_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(SUB));
}

}  // namespace

// The launch geometry for tiles of `rt` rays: out = [CUDA blocks, threads
// each, dynamic shared memory bytes each, CUDA blocks resident per SM (the
// occupancy API)].  Returns the cudaError_t of the queries.
extern "C" int grouped_pairs_plan(int rt, int tiles, int* out) {
  if (rt < 32 || rt > MAX_RT || rt % 32 != 0 || tiles < 0) return (int)cudaErrorInvalidValue;
  const int sub = sub_width(rt);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  out[0] = tiles * (rt / sub);
  out[1] = sub;
  out[2] = (int)smem_bytes(sub);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], grouped_pairs_kernel, sub,
                                                            smem_bytes(sub));
}

// Launch on `stream` (a cudaStream_t passed as void*): tiles * (rt / sub)
// CUDA blocks of sub = min(SUB, the largest power of two dividing rt) threads
// over rays [tiles * rt, 3] (only the first n_rays are read).  `packed`
// [tp, 28] (TriFeatures.packed, 16-byte aligned), `bounds` [nb, 8];
// `offsets` [tiles + 1], `blk` and `lod` [offsets[tiles]...] are the
// schedule.  `stats` may be null, else it receives [pairs tested, block
// stagings] (added).  Returns the cudaError_t of the launch (0 on success).
extern "C" int grouped_pairs_launch(const float* ray_o, const float* ray_d, int n_rays, int rt,
                                    const float* packed, const float* bounds, int tp, int tile,
                                    int nb, const int* offsets, const int* blk, const float* lod,
                                    int tiles, float* out_t, int* out_tri,
                                    unsigned long long* stats, void* stream) {
  if (n_rays <= 0) return 0;
  if (rt < 32 || rt > MAX_RT || rt % 32 != 0 || (long long)tiles * rt < n_rays ||
      tile <= 0 || tile > ch::TRI_TILE || nb <= 0 || tile * nb != tp ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int sub = sub_width(rt);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  grouped_pairs_kernel<<<tiles * (rt / sub), sub, smem_bytes(sub),
                         static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, rt, reinterpret_cast<const float4*>(packed), bounds, tile, offsets,
      blk, lod, out_t, out_tri, stats);
  return (int)cudaGetLastError();
}
