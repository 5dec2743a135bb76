// Closest hit through an LBVH for Hopper (sm_90a): one thread per ray, both
// children of an accepted node tested at that node, the right one deferred
// with its entry distance.
//
// Replaces no Pallas kernel.  It is the card's counterpart of the JAX
// package's ensem3a_openclraytracer_tpu/ops/traversal.py:53 trace_bvh, a
// masked stack walk of the whole ray batch in one lax.while_loop (one device
// program per trace on the TPU).  In eager PyTorch that loop would be a host
// loop with a sync per round, so here each thread walks its own ray to the
// end, as the reference did (MathLib.cl:234-288).
//
// The contract: t, tri and hit bit-equal to ops/traversal.trace_bvh_plain,
// and its counts equal (nodes popped, leaf tests, dropped pushes, the most
// nodes one ray popped, the sum over warps of each warp's most).  Plain's
// walk:
//   * pops one node per step, left child before right (an inner node pushes
//     its right child, then its left); a push past MAX_STACK is dropped;
//   * culls a node when its slab test gives tmax < tmin, tmax < 0 or
//     tmin > best_t (ops/geometry.ray_aabb, with its +-1e-12 nudge);
//   * keeps a leaf's triangle when Moller-Trumbore hits (|det| < 1e-7
//     misses, 0 <= u, v, u + v <= 1, t > 1e-7) with t > MIN_HIT_DIST and
//     t < best_t (strict: at a tie the first triangle found stays);
//   * misses with t = MAX_DIST, tri = 0, hit = t < MAX_DIST.
// Near-child-first order would visit nodes in another order and fork from
// plain on rays whose two best candidates lie within ulps (Cornell's walls
// and shared edges), so this walk keeps plain's order and changes only
// when each test runs.
//
// What bounds it on an H100: the latency of the longest walks, not the FP32
// rate (25 operations per slab test, 60 per triangle test) nor the bytes
// (the walk's own work bounds it at 0.0015-0.0085 ms).  Measured on the
// walk this one replaced, which popped one node per step (PERF.md, step 0
// of the tree walk's redesign; H100 SXM, 700 W): five times the rays cost
// 1.22x the time; at 65,536 bounce rays on a 300,003-node tree one ray
// pops 729 nodes, 9.7x the mean, the SIMT efficiency is 0.41, and the launch (512 blocks, ~15.5 warps per SM) ends
// with its longest warp, ~0.29 us per popped node; flushing L2 between
// launches costs 1.06-1.14x.  Each of its steps was a chain of dependent
// latencies (a local-memory pop, the node's 32-byte row from L2, the slab
// test, two local-memory pushes), and every pushed child paid its own row
// load when it popped.
// The design: when an inner node is accepted, the rows of both its
// children are loaded back to back (one latency covers both) and both slab
// tests run at once.  The left child pops right after its parent in plain
// and nothing changes best_t in between, so its full test (tmax >= tmin,
// tmax >= 0, tmin <= best_t) is plain's, and the walk descends into it with
// no stack round trip.  The right child's first two conditions do not
// depend on best_t: when they pass it is pushed with its entry distance,
// and its pop makes plain's last test, tmin <= best_t with the best_t of
// that moment, with no row load.  A leaf's tri is read only when the leaf
// is accepted, then its vertices.  Each slab test counts as one node
// popped: the root, plus both children of each accepted inner node, which
// is plain's count.  The dependent row loads on a walk's chain drop from
// one per popped node to one per accepted inner node.
// The stack is two arrays in local memory, 12 bytes an entry: the entry
// distances, which every pop reads, and the links, read only when the
// entry passes.  A 262,144-ray Cornell launch is one wave at full
// occupancy, where fewer bytes per entry pay (more of the stack's lines
// fit in L1, and a pop that fails reads 4 bytes; which counts is not
// measured): inside Cornell's tree render, one 16-byte entry (links and
// distance) took 1.11x the time of the one-node-per-step walk (4-byte
// entries), 12 bytes in two arrays 0.99x.  Against that walk in one call
// (PERF.md; H100 SXM, 700 W) this one is 1.20-1.34x as fast on the
// outdoor trees alone, 1.26-1.35x inside their renders, 1.09x on Cornell
// alone (262,144 rays) and 1.01x inside its render.
// Where plain drops no push (every tree of accel: depth <= 63), t, tri, hit
// and the counts are plain's; a push past MAX_STACK is still dropped and
// counted.
// The arithmetic is written op for op as the tensor ops round it: every
// product, sum and quotient rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn / __frcp_rn, which nvcc never contracts into an FMA), the dot
// products summed in index order, the reciprocal 1 / x as torch's
// Tensor.__rtruediv__ (reciprocal, then the exact product by 1).
// The tree comes as ops/traversal.nodes_to lays it out: one 32-byte row
// per node, (bmin.xyz, left) (bmax.xyz, right) with the integers' bits,
// read through the read-only path, and tri [M] on its own (a leaf has
// left < 0, as every leaf of an LBVH has); the triangles' vertices come
// from v0/v1/v2 ([T, 3] f32).  BVHNodes' fields view the rows, so the
// tree is held once.
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

// ops/geometry.cross_rn: (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)
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

// What the walk needs of a node: its slab test (ops/geometry.ray_aabb on
// its row, lo = (bmin, left), hi = (bmax, right)) and, for when it is
// accepted, its children (a = left >= 0, b = right) or, for a leaf
// (a = left < 0), its own index b, whose tri is read when it is tested.
struct Box {
  float tmin, tmax;
  int a, b;
};

__device__ __forceinline__ Box test(const float4 lo, const float4 hi, int n, const float o[3],
                                    const float inv[3]) {
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
  Box x{0.0f, 0.0f, 0, 0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = __fmul_rn(__fsub_rn(l[k], o[k]), inv[k]);
    const float t2 = __fmul_rn(__fsub_rn(h[k], o[k]), inv[k]);
    const float near = fminf(t1, t2), far = fmaxf(t1, t2);
    x.tmin = k == 0 ? near : fmaxf(x.tmin, near);
    x.tmax = k == 0 ? far : fminf(x.tmax, far);
  }
  x.a = __float_as_int(lo.w);
  x.b = x.a < 0 ? n : __float_as_int(hi.w);
  return x;
}

__global__ void __launch_bounds__(THREADS)
bvh_trace_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int n_rays,
                 const float4* __restrict__ rows, const int* __restrict__ node_tri,
                 const float* __restrict__ v0, const float* __restrict__ v1,
                 const float* __restrict__ v2, float* __restrict__ out_t,
                 long long* __restrict__ out_tri, bool* __restrict__ out_hit,
                 unsigned long long* __restrict__ stats) {
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
    // the deferred right children: each one's links, (left, right) or
    // (left < 0, its own index) for a leaf, and its entry distance
    int2 links[MAX_STACK];
    float tmins[MAX_STACK];
    int sp = 0;
    float best_t = MAX_DIST;
    int best_i = 0;
    Box cur = test(__ldg(rows), __ldg(rows + 1), 0, o, inv);  // the root, popped first
    popped = 1;
    bool accepted = cur.tmax >= cur.tmin && cur.tmax >= 0.0f && cur.tmin <= best_t;
    while (accepted) {  // cur is accepted
      if (cur.a >= 0) {  // an inner node: test both children here
        const float4 la = __ldg(rows + 2 * cur.a), lb = __ldg(rows + 2 * cur.a + 1);
        const float4 ra = __ldg(rows + 2 * cur.b), rb = __ldg(rows + 2 * cur.b + 1);
        const Box l = test(la, lb, cur.a, o, inv), r = test(ra, rb, cur.b, o, inv);
        popped += 2;
        if (r.tmax >= r.tmin && r.tmax >= 0.0f) {  // deferred: tmin <= best_t at its pop
          if (sp < MAX_STACK) {
            links[sp] = make_int2(r.a, r.b);
            tmins[sp++] = r.tmin;
          } else {
            ++dropped;
          }
        }
        if (l.tmax >= l.tmin && l.tmax >= 0.0f && l.tmin <= best_t) {  // pops next in plain
          cur = l;
          continue;
        }
      } else {  // a leaf
        ++leaf_tests;
        const int tri = __ldg(node_tri + cur.b);
        float t;
        if (moller_trumbore(o, d, v0, v1, v2, tri, t) && t > MIN_HIT_DIST && t < best_t) {
          best_t = t;
          best_i = tri;
        }
      }
      accepted = false;  // pop the next right child that passes
      while (sp > 0) {
        --sp;
        if (tmins[sp] <= best_t) {
          const int2 e = links[sp];
          cur.a = e.x;
          cur.b = e.y;
          accepted = true;
          break;
        }
      }
    }
    out_t[i] = best_t;
    out_tri[i] = best_i;
    out_hit[i] = best_t < MAX_DIST;
  }
  if (stats != nullptr) {  // every thread of the warp reaches here
    const unsigned most = __reduce_max_sync(0xffffffffu, popped);
    popped = __reduce_add_sync(0xffffffffu, popped);
    leaf_tests = __reduce_add_sync(0xffffffffu, leaf_tests);
    dropped = __reduce_add_sync(0xffffffffu, dropped);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats + 0, static_cast<unsigned long long>(popped));
      atomicAdd(stats + 1, static_cast<unsigned long long>(leaf_tests));
      atomicAdd(stats + 2, static_cast<unsigned long long>(dropped));
      atomicMax(stats + 3, static_cast<unsigned long long>(most));
      atomicAdd(stats + 4, static_cast<unsigned long long>(most));
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
// pushes] (int64, added), the most nodes one ray popped (a max with what
// stats[3] holds) and the sum over warps of each warp's most (added).
// Returns the cudaError_t of the launch (0 on success).
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
