// Closest hit through an LBVH for Hopper (sm_90a): one thread per ray.
//
// Replaces no Pallas kernel.  It is the card's counterpart of the JAX
// package's ensem3a_openclraytracer_tpu/ops/traversal.py trace_bvh, a masked
// stack walk of the whole ray batch in one lax.while_loop (one device
// program per trace on the TPU).  In eager PyTorch that loop would be a host
// loop with a sync per round, so here each thread walks its own ray to the
// end, as the reference did (MathLib.cl:234-288): a stack of MAX_STACK node
// indices in local memory, the root in slot 0, one node popped per step.
// It computes what ops/traversal.trace_bvh_plain computes:
//   * a node is culled when its slab test gives tmax < tmin, tmax < 0 or
//     tmin > best_t (ops/geometry.ray_aabb, with its +-1e-12 direction nudge);
//   * a leaf's triangle is kept when Moller-Trumbore hits (ops/geometry
//     .moller_trumbore: |det| < 1e-7 misses, 0 <= u, v, u + v <= 1, t > 1e-7)
//     with t > MIN_HIT_DIST and t < best_t (strict: a tie keeps the first);
//   * an inner node pushes its right child, then its left, so the left pops
//     first; a push past MAX_STACK is dropped (counted in stats; an LBVH is
//     at most 63 deep, so 64 slots do not overflow on its trees);
//   * a miss is t = MAX_DIST, tri = 0, hit = t < MAX_DIST.
// The arithmetic is written op for op as the tensor ops round it: every
// product, sum and quotient rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn / __frcp_rn, which nvcc never contracts into an FMA), the dot
// products summed in index order, the reciprocal 1 / x as torch's
// Tensor.__rtruediv__ (reciprocal, then the exact product by 1).
// The tree comes as ops/traversal.nodes_to lays it out: one 32-byte row
// per node, (bmin.xyz, left) (bmax.xyz, right) with the integers' bits,
// read through the read-only path (one sector per step), and tri [M] on
// its own, read only at a leaf (left < 0, as every leaf of an LBVH has);
// the triangles' vertices come from v0/v1/v2 ([T, 3] f32).  BVHNodes'
// fields view the rows, so the tree is held once.  On an H100 the rows
// took 0.85x / 0.78x the time of five separate arrays on trees of 31k /
// 300k nodes (1.68x on a 71-node tree, where every node stays in L1;
// PERF.md).
// What bounds it on an H100: the data-dependent walk, not the FP32 rate
// (about 25 operations per slab test and 60 per triangle test): threads of
// a warp diverge as their rays take other paths, each step waits on a
// dependent load from L2 (a tree of 2T - 1 nodes of 36 bytes: 10.8 MB at
// 150k triangles, resident in the 50 MB L2) and the stack lives in local
// memory.  The kernel counts what the walk did (nodes popped, leaf tests,
// dropped pushes) for chip_smoke.py's bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_STACK = 64;  // ops/traversal.MAX_STACK
constexpr float MAX_DIST = 1000.0f;
constexpr float MIN_HIT_DIST = 1e-4f;
constexpr float MT_EPSILON = 1e-7f;
constexpr float TINY = 1e-12f;

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])), __fmul_rn(a[2], b[2]));
}

// torch.linalg.cross: (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)
__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  out[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  out[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// ops/geometry.moller_trumbore for one ray and triangle tri: true on a hit,
// with its distance in t.
__device__ __forceinline__ bool moller_trumbore(const float o[3], const float d[3],
                                                const float* __restrict__ v0,
                                                const float* __restrict__ v1,
                                                const float* __restrict__ v2, int tri, float& t) {
  float a[3], e1[3], e2[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = __ldg(v0 + 3 * tri + k);
    e1[k] = __fsub_rn(__ldg(v1 + 3 * tri + k), a[k]);
    e2[k] = __fsub_rn(__ldg(v2 + 3 * tri + k), a[k]);
    s[k] = __fsub_rn(o[k], a[k]);
  }
  float h[3], q[3];
  cross3(d, e2, h);
  const float det = dot3(e1, h);
  const bool parallel = fabsf(det) < MT_EPSILON;
  const float inv_det = __frcp_rn(parallel ? 1.0f : det);
  const float u = __fmul_rn(inv_det, dot3(s, h));
  cross3(s, e1, q);
  const float v = __fmul_rn(inv_det, dot3(d, q));
  t = __fmul_rn(inv_det, dot3(e2, q));
  return !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f &&
         t > MT_EPSILON;
}

__global__ void __launch_bounds__(THREADS)
bvh_trace_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                 const float4* __restrict__ rows, const int* __restrict__ node_tri,
                 const float* __restrict__ v0,
                 const float* __restrict__ v1, const float* __restrict__ v2,
                 float* __restrict__ out_t, long long* __restrict__ out_tri,
                 bool* __restrict__ out_hit, unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  unsigned popped = 0, leaf_tests = 0, dropped = 0;
  if (i < n_rays) {
    float o[3], d[3], inv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = ray_o[3 * i + k];
      d[k] = ray_d[3 * i + k];
      const float dk = fabsf(d[k]) < TINY ? (d[k] < 0.0f ? -TINY : TINY) : d[k];
      inv[k] = __frcp_rn(dk);
    }
    int stack[MAX_STACK];
    stack[0] = 0;
    int sp = 1;
    float best_t = MAX_DIST;
    int best_i = 0;
    while (sp > 0) {
      const int idx = stack[--sp];
      ++popped;
      const float4 a = __ldg(rows + 2 * idx), b = __ldg(rows + 2 * idx + 1);
      const float lo[3] = {a.x, a.y, a.z}, hi[3] = {b.x, b.y, b.z};
      const int left = __float_as_int(a.w), right = __float_as_int(b.w);
      float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float t1 = __fmul_rn(__fsub_rn(lo[k], o[k]), inv[k]);
        const float t2 = __fmul_rn(__fsub_rn(hi[k], o[k]), inv[k]);
        const float near = fminf(t1, t2), far = fmaxf(t1, t2);
        tmin = k == 0 ? near : fmaxf(tmin, near);
        tmax = k == 0 ? far : fminf(tmax, far);
      }
      if (!(tmax >= tmin && tmax >= 0.0f && tmin <= best_t)) continue;
      if (left < 0) {  // a leaf
        const int tri = __ldg(node_tri + idx);
        ++leaf_tests;
        float t;
        if (moller_trumbore(o, d, v0, v1, v2, tri, t) && t > MIN_HIT_DIST && t < best_t) {
          best_t = t;
          best_i = tri;
        }
      } else {  // right, then left: the left pops first
        if (sp < MAX_STACK) stack[sp++] = right; else ++dropped;
        if (sp < MAX_STACK) stack[sp++] = left; else ++dropped;
      }
    }
    out_t[i] = best_t;
    out_tri[i] = best_i;
    out_hit[i] = best_t < MAX_DIST;
  }
  if (stats != nullptr) {  // every thread of the warp reaches here
    popped = __reduce_add_sync(0xffffffffu, popped);
    leaf_tests = __reduce_add_sync(0xffffffffu, leaf_tests);
    dropped = __reduce_add_sync(0xffffffffu, dropped);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats + 0, static_cast<unsigned long long>(popped));
      atomicAdd(stats + 1, static_cast<unsigned long long>(leaf_tests));
      atomicAdd(stats + 2, static_cast<unsigned long long>(dropped));
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*): n_rays rays
// (ray_o, ray_d [n, 3] f32) through the tree of n_nodes nodes, its rows
// ([n_nodes, 8] f32, 16-byte aligned: (bmin.xyz, left, bmax.xyz, right))
// and tri ([n_nodes] int32), over n_tris triangles (v0, v1, v2 [n_tris, 3]
// f32).  Writes out_t (f32), out_tri (int64) and out_hit (bool) [n_rays].
// `stats` may be null, else it receives [nodes popped, leaf tests, dropped
// pushes] (int64, added).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int bvh_trace_launch(const float* ray_o, const float* ray_d, int n_rays,
                                const float* rows, const int* tri, int n_nodes, const float* v0,
                                const float* v1, const float* v2, int n_tris, float* out_t,
                                long long* out_tri, bool* out_hit, unsigned long long* stats,
                                void* stream) {
  if (n_rays <= 0) return 0;
  if (n_nodes <= 0 || n_tris <= 0 || n_nodes != (n_tris > 1 ? 2 * n_tris - 1 : 1))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int grid = (n_rays + THREADS - 1) / THREADS;
  bvh_trace_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, n_rays, reinterpret_cast<const float4*>(rows), tri, v0, v1, v2, out_t,
      out_tri, out_hit, stats);
  return (int)cudaGetLastError();
}
