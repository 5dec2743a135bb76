// Block-culled closest-hit kernel for Hopper (sm_90a).
//
// Replaces three Pallas kernels of the JAX package, one per scene size:
//   ensem3a_openclraytracer_tpu/ops/intersect_mxu.py  _mxu_kernel        (1 block)
//   ensem3a_openclraytracer_tpu/ops/pairs.py          _tile_loop_kernel  (2-64 blocks)
//   ensem3a_openclraytracer_tpu/ops/pairs.py          _tile_stream_kernel (> 64 blocks)
// Those kernels needed a VMEM-resident or HBM-streamed operand and an XLA-built
// [rays x blocks] visit schedule; here a CUDA block of rays builds its own visit
// list and only one 256-triangle block lives in shared memory at a time, so one
// kernel covers every size.  It computes what trace_plain (ops/closest_hit.py)
// computes, in exact f32 (no bf16 split, no packed keys, no matmul):
//   w_e = sum_k edges[e][k] * [d, d x o][k]  (e = AB, BC, CA)
//   inside = all w >= 0 or all w <= 0;  t = ([o,1] . plane) / (d . n)
//   hit = inside && d.n != 0 && t > MIN_HIT_DIST; closest (t, tri) in
//   lexicographic order, so ties keep the lowest triangle index whatever
//   the visit order.  t >= 0.999 * MAX_DIST is a miss (t = MAX_DIST, tri = 0).
//
// Design (one thread per ray, RAYS rays per CUDA block, rays pre-sorted by
// ops/closest_hit.coherent_order so a block's rays are neighbours):
//   1. Cull: every thread slab-tests its ray against every triangle block's
//      AABB, grown by the scene-scale epsilon in block_bounds column 6 so
//      rounding never culls a real hit.  A warp min-reduction and a shared
//      64-bit atomicMin keep, per triangle block, the least entry distance
//      of any ray: key = (entry bits << 32) | block.  Inverted (padding-only)
//      boxes are rejected explicitly; 1/d is clamped so inf * 0 never occurs.
//   2. Bitonic sort of the keys in shared memory: the front-to-back visit list.
//   3. Visit: stage the block's 25 x 256 feature floats (25.6 KB) in shared
//      memory, every thread whose own slab test passes with entry <= best t
//      tests its ray against the 256 triangles (broadcast reads, no bank
//      conflicts).  The block stops once every ray's best t is below the next
//      block's entry distance.
// What bounds it on an H100: FP32 operations, about 51 per (ray, triangle)
// pair tested (three 6-term and two 3/4-term dot products, one divide), at
// 67 TFLOP/s; the bytes (rays in, t/tri out, features read once per block
// visit from L2) are small beside them.  The design keeps the pairs tested
// few by culling per CUDA block and visiting front to back; staging is not
// yet overlapped with compute (a later step: cp.async / TMA double buffers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TRI_TILE = 256;
constexpr int RAYS = 128;
constexpr int FEAT_ROWS = 25;  // 18 edge rows, 4 plane rows, 3 normal rows
constexpr float MAX_DIST = 1000.0f;
constexpr float MIN_HIT_DIST = 1e-4f;
constexpr float MISS_T = MAX_DIST * 0.999f;
constexpr unsigned long long NO_KEY = ~0ull;

struct Ray {
  float o[3], d[3], inv[3], r6[6];
};

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

__global__ void __launch_bounds__(RAYS)
closest_hit_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                   const float* __restrict__ edges, const float* __restrict__ plane,
                   const float* __restrict__ normal_d, const float* __restrict__ bounds,
                   int tp, int tile, int nb, int cap,
                   float* __restrict__ out_t, int* __restrict__ out_tri,
                   unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* feat = reinterpret_cast<float*>(smem_raw);  // [FEAT_ROWS][TRI_TILE]
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(feat + FEAT_ROWS * TRI_TILE);  // [cap]
  __shared__ int n_live;

  const int i = blockIdx.x * RAYS + threadIdx.x;
  const bool active = i < n_rays;
  Ray r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = active ? ray_o[3 * i + k] : 0.0f;
    r.d[k] = active ? ray_d[3 * i + k] : (k == 2 ? 1.0f : 0.0f);
    float dk = r.d[k];
    if (fabsf(dk) < 1e-12f) dk = dk < 0.0f ? -1e-12f : 1e-12f;
    r.inv[k] = 1.0f / dk;
    r.r6[k] = r.d[k];
  }
  r.r6[3] = r.d[1] * r.o[2] - r.d[2] * r.o[1];  // d x o
  r.r6[4] = r.d[2] * r.o[0] - r.d[0] * r.o[2];
  r.r6[5] = r.d[0] * r.o[1] - r.d[1] * r.o[0];

  // 1. cull: per triangle block, the least entry distance of any ray
  for (int k = threadIdx.x; k < cap; k += RAYS) keys[k] = NO_KEY;
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < nb; ++j) {
    float e = active ? block_entry(r, bounds, j) : __int_as_float(0x7f800000);
    unsigned bits = e < __int_as_float(0x7f800000) ? __float_as_uint(e) : 0xffffffffu;
    bits = __reduce_min_sync(0xffffffffu, bits);
    if (lane == 0 && bits != 0xffffffffu)
      atomicMin(&keys[j], (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned>(j));
  }
  __syncthreads();

  // 2. bitonic sort of the visit list (ascending entry, then block index)
  for (int k = 2; k <= cap; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int idx = threadIdx.x; idx < cap; idx += RAYS) {
        int ixj = idx ^ jj;
        if (ixj > idx) {
          unsigned long long a = keys[idx], b = keys[ixj];
          bool up = (idx & k) == 0;
          if ((a > b) == up) {
            keys[idx] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int k = threadIdx.x; k < cap; k += RAYS)
    if (keys[k] != NO_KEY && (k + 1 == cap || keys[k + 1] == NO_KEY)) n_live = k + 1;
  __syncthreads();

  // 3. visit front to back
  float best_t = MAX_DIST;
  int best_i = 0;
  unsigned long long pairs = 0, stagings = 0;
  const int live = n_live;
  for (int v = 0; v < live; ++v) {
    const unsigned long long key = keys[v];
    const int j = static_cast<int>(key & 0xffffffffu);
    const float entry = __uint_as_float(static_cast<unsigned>(key >> 32));
    // also the barrier that keeps the previous block's features in use
    if (__syncthreads_and(!active || best_t < entry)) break;
    const int base = j * tile;
    for (int k = threadIdx.x; k < FEAT_ROWS * tile; k += RAYS) {
      const int row = k / tile, c = k - row * tile;
      const float* src = row < 18 ? edges + row * tp : row < 22 ? plane + (row - 18) * tp
                                                                  : normal_d + (row - 22) * tp;
      feat[row * TRI_TILE + c] = src[base + c];
    }
    ++stagings;
    __syncthreads();
    if (!active || !(block_entry(r, bounds, j) <= best_t)) continue;
    pairs += tile;
    for (int c = 0; c < tile; ++c) {
      const float* f = feat + c;
      float w[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float acc = f[(6 * e) * TRI_TILE] * r.r6[0];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc = acc + f[(6 * e + k) * TRI_TILE] * r.r6[k];
        w[e] = acc;
      }
      const bool inside = (w[0] >= 0.0f && w[1] >= 0.0f && w[2] >= 0.0f) ||
                          (w[0] <= 0.0f && w[1] <= 0.0f && w[2] <= 0.0f);
      const float den = f[22 * TRI_TILE] * r.d[0] + f[23 * TRI_TILE] * r.d[1] + f[24 * TRI_TILE] * r.d[2];
      if (!inside || den == 0.0f) continue;
      const float num = f[18 * TRI_TILE] * r.o[0] + f[19 * TRI_TILE] * r.o[1] +
                        f[20 * TRI_TILE] * r.o[2] + f[21 * TRI_TILE];
      const float t = num / den;
      const int g = base + c;
      if (t > MIN_HIT_DIST && (t < best_t || (t == best_t && g < best_i))) {
        best_t = t;
        best_i = g;
      }
    }
  }

  if (active) {
    const bool hit = best_t < MISS_T;
    out_t[i] = hit ? best_t : MAX_DIST;
    out_tri[i] = hit ? best_i : 0;
  }
  if (stats != nullptr) {
    for (int off = 16; off > 0; off >>= 1) pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    if (lane == 0 && pairs) atomicAdd(&stats[0], pairs);
    if (threadIdx.x == 0) atomicAdd(&stats[1], stagings);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*).  `stats` may be null,
// else it receives [pairs tested, block stagings] (added).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int closest_hit_launch(const float* ray_o, const float* ray_d, int n_rays,
                                  const float* edges, const float* plane, const float* normal_d,
                                  const float* bounds, int tp, int tile, int nb, float* out_t,
                                  int* out_tri, unsigned long long* stats, void* stream) {
  if (n_rays <= 0) return 0;
  if (tile <= 0 || tile > TRI_TILE || nb <= 0 || tile * nb != tp) return (int)cudaErrorInvalidValue;
  int cap = 1;
  while (cap < nb) cap <<= 1;
  const size_t smem = FEAT_ROWS * TRI_TILE * sizeof(float) + cap * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(closest_hit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rays + RAYS - 1) / RAYS;
  closest_hit_kernel<<<grid, RAYS, smem, static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, edges, plane, normal_d, bounds, tp, tile, nb, cap, out_t, out_tri,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}
