// Closest hit by block queues, one persistent launch per trace, for Hopper
// (sm_90a).
//
// Replaces the two multi-block Pallas kernels of the JAX package on the render
// path:
//   ensem3a_openclraytracer_tpu/ops/pairs.py  _tile_loop_kernel   (2-64 blocks)
//   ensem3a_openclraytracer_tpu/ops/pairs.py  _tile_stream_kernel (> 64 blocks)
// Those walk an XLA-built [ray tile x block] schedule.  Here the schedule is
// built on the card, round by round, inside one cooperative launch: the grid
// is every CUDA block that fits on the card at once (the occupancy API's count
// per SM x the SMs), and grid-wide syncs separate the pieces of a round.
//
// The rounds (select, scan, fill, test) are csrc/pairs.cuh's, where they
// are described; csrc/fused_queue.cu runs the same rounds for a sample's traces.
// The loop ends once no ray is live; a last pass writes (t, tri, hit) with the
// miss rule of ops/closest_hit.trace_plain.  The wrapper reads nothing back.
//
// The arithmetic per (ray, triangle) pair is ch::test_packed's, term for term,
// and the slab test is ch::block_entry, so the result can be held against
// trace_plain.
// What bounds it on an H100: FP32 operations, about 45 per (ray, triangle)
// pair the closest hit needs, at 67 TFLOP/s; the rays, outputs, features and
// queues are small beside them.  The design's answers: every staging serves up
// to CHUNK rays that all need that block, with no barrier per block visit; the
// staging is overlapped with the previous item's tests; one launch and no host
// sync per trace.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairs.cuh"

namespace {

using bq::THREADS;

// Blocks each live ray takes per round (ops/pairs.K).  The kernel stays a
// template of it, built once, so its device name is pairs_kernel<8>.
constexpr int PICKS = 8;

struct Params {
  bq::Queues q;
  float* out_t;
  long long* out_tri;
  unsigned char* out_hit;
  unsigned long long* stats;  // [4] pairs tested, stagings, rounds, slab tests; or null
};

template <int K>
__global__ void __launch_bounds__(THREADS) pairs_kernel(Params p) {
  extern __shared__ __align__(16) float4 smem[];  // two staging buffers, or select's bounds
  __shared__ int4 s_work;
  __shared__ unsigned long long s_scan[THREADS];
  bq::cg::grid_group grid = bq::cg::this_grid();

  bq::init_trace(p.q, p.q.n);
  grid.sync();
  bq::Tally tally;
  bq::trace_rounds<K, false>(p.q, grid, smem, &s_work, s_scan, tally);
  bq::write_hits(p.q, p.q.n, p.out_t, p.out_tri, p.out_hit);
  if (p.stats != nullptr) bq::add_tally(p.stats, tally);
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = bq::grid_size(pairs_kernel<PICKS>, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  Params args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pairs_kernel<PICKS>),
                                    dim3(per_sm * sms), dim3(THREADS), argv, bq::SMEM_BYTES,
                                    stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Bytes of scratch that pairs_launch needs for n rays and nb blocks.
extern "C" long long pairs_scratch_bytes(int n, int nb) {
  size_t at = 0;
  bq::queue_layout(n, nb, PICKS, at);
  return static_cast<long long>(at);
}

// The launch's grid: out[0] CUDA blocks per SM (the occupancy API's count),
// out[1] SMs, out[2] registers per thread, out[3] threads per CUDA block,
// out[4] dynamic shared memory per CUDA block.  Returns a cudaError_t.
extern "C" int pairs_grid(int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = bq::grid_size(pairs_kernel<PICKS>, &out[0], &out[1]);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pairs_kernel<PICKS>);
  out[2] = attr.numRegs;
  out[3] = THREADS;
  out[4] = bq::SMEM_BYTES;
  return static_cast<int>(err);
}

// The slices of a round of `items` (block, chunk) work items on a grid of
// `grid` CUDA blocks (bq::slices, which ops/pairs.slices mirrors).
extern "C" int pairs_slices(int items, int grid) { return bq::slices(items, grid); }

// The select lanes a ray in a round of n_live rays on nb blocks over
// grid_threads threads (bq::select_lanes, which ops/pairs.select_lanes
// mirrors).
extern "C" int pairs_select_lanes(int n_live, int nb, int grid_threads) {
  return bq::select_lanes(n_live, nb, grid_threads);
}

// One cooperative launch on `stream` (a cudaStream_t passed as void*).
// packed [tp, 28] f32 and bounds [nb, 8] f32, both 16-byte aligned; scratch
// of pairs_scratch_bytes(n, nb) bytes, 16-byte aligned, in any state.
// Writes out_t [n] f32, out_tri [n] int64, out_hit [n] bool; `stats` may be
// null, else it receives [pairs tested, block stagings, rounds, slab tests]
// (added).  Returns the cudaError_t of the launch.
extern "C" int pairs_launch(const float* ray_o, const float* ray_d, int n, const float* packed,
                            const float* bounds, int tp, int tile, int nb, void* scratch,
                            float* out_t, long long* out_tri, unsigned char* out_hit,
                            unsigned long long* stats, void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile > ch::TRI_TILE || nb <= 0 || tile * nb != tp)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t at = 0;
  const bq::QueueLayout l = bq::queue_layout(n, nb, PICKS, at);
  Params p;
  p.q = bq::queues_at(static_cast<char*>(scratch), l, n, nb, tile);
  p.q.ray_o = ray_o;
  p.q.ray_d = ray_d;
  p.q.packed = reinterpret_cast<const float4*>(packed);
  p.q.bounds = bounds;
  p.out_t = out_t;
  p.out_tri = out_tri;
  p.out_hit = out_hit;
  p.stats = stats;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch(p, st));
}
