// Fused whole-sample kernel for Hopper (sm_90a): one Monte-Carlo sample per
// ray, the whole bounce loop in one launch.
//
// Replaces the JAX package's TPU kernel
//   ensem3a_openclraytracer_tpu/ops/fused.py  _make_kernel / kernel (sample_fused)
// and computes what ops/fused.sample_fused_plain computes: from the cached
// primary vertex, per bounce the emissive terminal, optional next-event
// estimation (one area-sampled light point and its shadow ray), Lambert /
// GGX / tint-glass sampling, the bounce trace, the escape record (the caller
// adds esc_thr * ibl(esc_dir)) and the in-loop sun shadow with its glass
// tint; record mode also writes the drawn uniforms and the winning triangles.
// The TPU kernel's answers to TPU limits are not carried over: no split-bf16
// products, no packed (t | row) keys, no one-hot attribute matmuls, no SMEM
// scalar-prefetch tables.  Instead:
//   * one thread per ray, its whole state (~40 floats) in registers across
//     the bounce loop; RAYS rays per CUDA block;
//   * every trace is csrc/closest_hit.cuh's exact f32 search (t >
//     MIN_HIT_DIST): on a one-block scene the block's 25.6 KB of features are
//     staged into shared memory once and stay there for every trace of every
//     bounce (the analogue of the TPU's VMEM-resident operand, and no barrier
//     at all); on more blocks each trace is the CUDA block's cull -> sort ->
//     front-to-back visit, which every thread calls, dead lanes included
//     (the render path sends multi-block scenes to csrc/fused_queue.cu; this
//     culled branch stays callable as ops/fused.sample_fused_blocks);
//   * the shading is csrc/shading.cuh's, shared with csrc/fused_queue.cu;
//   * the winner's attributes are one 32-byte row gather of the [Tp, 8] table;
//   * random numbers are explicit uniforms [mb+1, N, n_u] or the Philox stream
//     of csrc/philox.cuh: lane r at bounce b draws flat index (b N + r) n_u + k.
// What bounds it on an H100: FP32 operations, mostly the (ray, triangle)
// pairs of its traces (about 45 each) at 67 TFLOP/s; per ray it reads ~60
// bytes of primary state and writes 36, so bytes are small beside them.
// Dead lanes skip the work of a trace but never its barriers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"
#include "shading.cuh"

namespace {

using namespace shade;

constexpr int RAYS = 128;

struct Params {
  int n, max_bounce, sun_enabled, nee, record, n_u;
  const float* __restrict__ p;
  const float* __restrict__ nrm;
  const int* __restrict__ mtype;
  const float* __restrict__ color;
  const float* __restrict__ rough;
  const unsigned char* __restrict__ live;
  const float* __restrict__ in_dir;
  const float* __restrict__ sun_dir;    // [3]
  const float* __restrict__ sun_power;  // [1]
  ch::Feats f;
  const float* __restrict__ attrs;   // [tp, 8]
  Lights lights;
  const float* __restrict__ uniforms;  // [mb+1, n, n_u] or null
  const unsigned* __restrict__ key;    // [2] or null
  int sample;
  float* __restrict__ rad;
  float* __restrict__ esc_thr;
  float* __restrict__ esc_dir;
  float* __restrict__ u_rec;  // [mb+1, n, 2]
  int* __restrict__ tri_rec;  // [mb+1, n]
  int* __restrict__ sun_rec;  // [mb+1, n]
  unsigned long long* __restrict__ stats;  // [5]: pairs [0], stagings [1], slab tests [3]
};

// ptxas keeps the state in 72 registers and spills 48 bytes to L1; asking for
// six blocks per SM instead (80 registers, no spill) ran slower on an H100.
__global__ void __launch_bounds__(RAYS) fused_sample_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* feat = reinterpret_cast<float*>(smem_raw);  // [FEAT_ROWS][TRI_TILE]
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(feat + ch::FEAT_ROWS * ch::TRI_TILE);  // [cap]
  __shared__ int n_live;

  const int i = blockIdx.x * RAYS + threadIdx.x;
  const bool in_range = i < P.n;
  const bool resident = P.f.nb == 1;
  ch::Counts counts;
  if (resident) {  // one block: its features stay in shared memory
    ch::stage_block(P.f, 0, feat);
    ++counts.stagings;
    __syncthreads();
  }

  // The CUDA block's closest hit of (o, d) for the active lanes.
  auto trace = [&](const float o[3], const float d[3], bool active, float& t, int& tri) {
    const ch::Ray r = ch::make_ray(o, d);
    float bt = ch::MAX_DIST;
    int bi = 0;
    if (resident) {
      if (active) {
        ++counts.slabs;
        if (ch::block_entry(r, P.f.bounds, 0) <= bt) {
          counts.pairs += P.f.tile;
          ch::test_block(r, feat, 0, P.f.tile, bt, bi);
        }
      }
    } else {
      ch::trace_culled(P.f, r, active, feat, keys, &n_live, bt, bi, counts);
    }
    const bool hit = bt < ch::MISS_T;
    t = hit ? bt : ch::MAX_DIST;
    tri = hit ? bi : 0;
    return hit;
  };

  float p[3], n[3], color[3], in_d[3];
  float thr[3] = {1.0f, 1.0f, 1.0f}, rad[3] = {0.0f, 0.0f, 0.0f};
  float esc_thr[3] = {0.0f, 0.0f, 0.0f}, esc_dir[3] = {0.0f, 0.0f, 1.0f};
  int mtype = EMISSIVE;
  float rough = 0.0f;
  bool live = false, emit_ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = in_range ? P.p[3 * i + k] : 0.0f;
    n[k] = in_range ? P.nrm[3 * i + k] : (k == 2 ? 1.0f : 0.0f);
    color[k] = in_range ? P.color[3 * i + k] : 0.0f;
    in_d[k] = in_range ? P.in_dir[3 * i + k] : (k == 2 ? -1.0f : 0.0f);
  }
  if (in_range) {
    mtype = P.mtype[i];
    rough = P.rough[i];
    live = P.live[i] != 0;
  }
  const float sun_dir[3] = {P.sun_dir[0], P.sun_dir[1], P.sun_dir[2]};
  const float sun_power = P.sun_power[0];
  uint2 key = make_uint2(0u, 0u);
  if (P.key != nullptr) key = make_uint2(P.key[0], P.key[1]);
  const long long n_rays = P.n;

  for (int b = 0; b <= P.max_bounce; ++b) {
    const long long row = b * n_rays + i;  // this lane's (bounce, ray) slot
    // terminal: emissive vertex (power in the roughness slot); with NEE,
    // suppressed when the previous vertex sampled the light
    const bool emis = live && mtype == EMISSIVE;
    if (P.nee ? (emis && emit_ok) : emis) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rad[k] += thr[k] * rough;
    }
    live = live && !emis;

    float u[5] = {0.5f, 0.5f, 0.5f, 0.5f, 0.5f};
    if (in_range) draw(P.uniforms, key, P.sample, P.n_u, row, u);
    const float u1 = u[0], u2 = u[1];

    if (P.nee) {  // uniform over the launch: every thread traces
      const Lights& L = P.lights;  // read from the parameter bank, indexed in place
      int li;
      float ldir[3], dist2, dist, cos_s, cos_l;
      light_point(L, u, p, n, li, ldir, dist2, dist, cos_s, cos_l);
      const bool sampled = live && mtype != GLASS;
      const bool want = sampled && cos_s > 0.0f && cos_l > 1e-6f;
      float st;
      int stri;
      trace(p, ldir, in_range && want, st, stri);
      if (want && st >= dist * (1.0f - 1e-3f)) {
        float brdf[3];
        const float s = light_weight(L, li, mtype, color, rough, in_d, ldir, n, cos_s, cos_l,
                                     dist2, brdf);
#pragma unroll
        for (int k = 0; k < 3; ++k) rad[k] += thr[k] * brdf[k] * s;
      }
      if (live) emit_ok = !sampled;
    }

    float bdir[3];
    bounce(n, in_d, color, rough, mtype, live, u1, u2, bdir, thr);

    // bounce segment; record mode traces dead lanes too, as the TPU kernel
    float t;
    int tri;
    const bool hit = trace(p, bdir, in_range && (live || P.record), t, tri);
    const bool miss = live && !hit;
    if (miss) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        esc_thr[k] = thr[k];
        esc_dir[k] = bdir[k];
      }
    }
    if (P.sun_enabled) {  // uniform over the launch
      float st;
      int stri;
      const bool shit = trace(p, sun_dir, in_range && (miss || P.record), st, stri);
      if (miss) add_sun(P.attrs, shit, stri, mtype, thr, sun_power, rad);
      if (P.record && in_range) P.sun_rec[row] = shit ? stri : -1;
    }
    if (P.record && in_range) {
      P.u_rec[2 * row] = u1;
      P.u_rec[2 * row + 1] = u2;
      P.tri_rec[row] = hit ? tri : -1;
    }

    live = live && hit;
    if (live) {  // advance to the new vertex
      const float* at = P.attrs + N_ATTR * tri;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p[k] = p[k] + bdir[k] * t;
        n[k] = at[k];
        color[k] = at[4 + k];
        in_d[k] = bdir[k];
      }
      mtype = __float2int_rn(at[3]);
      rough = at[7];
    }
  }

  // a path whose last segment landed on a light still contributes
  if (live && mtype == EMISSIVE && (!P.nee || emit_ok)) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rad[k] += thr[k] * rough;
  }
  if (in_range) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      P.rad[3 * i + k] = rad[k];
      P.esc_thr[3 * i + k] = esc_thr[k];
      P.esc_dir[3 * i + k] = esc_dir[k];
    }
  }
  if (P.stats != nullptr) {
    unsigned long long pairs = counts.pairs, slabs = counts.slabs;
    for (int off = 16; off > 0; off >>= 1) {
      pairs += __shfl_down_sync(0xffffffffu, pairs, off);
      slabs += __shfl_down_sync(0xffffffffu, slabs, off);
    }
    if ((threadIdx.x & 31) == 0) {
      if (pairs) atomicAdd(&P.stats[0], pairs);
      if (slabs) atomicAdd(&P.stats[3], slabs);
    }
    if (threadIdx.x == 0) atomicAdd(&P.stats[1], counts.stagings);
  }
}

}  // namespace

// One sample for n rays on `stream` (a cudaStream_t passed as void*).  Either
// `uniforms` ([mb+1, n, 2 or 5 with nee]) or `key` (two uint32 words on the
// card) must be given.  `u_rec`, `tri_rec` (and `sun_rec` with sun) are
// needed with record, which excludes nee; nee needs the light columns.
// `stats` may be null, else it receives [pairs tested, block stagings, -, slab
// tests, -] (added; it makes no rounds and no grid syncs).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_sample_launch(
    int n, int max_bounce, int sun_enabled, int nee, int record, const float* p,
    const float* nrm, const int* mtype, const float* color, const float* rough,
    const unsigned char* live, const float* in_dir, const float* sun_dir,
    const float* sun_power, const float* edges, const float* plane, const float* normal_d,
    const float* bounds, int tp, int tile, int nb, const float* attrs, const float* light_v0,
    const float* light_v1, const float* light_v2, const float* light_n,
    const float* light_power, const float* light_area, int n_lights, const float* uniforms,
    const unsigned* key, int sample, float* rad, float* esc_thr, float* esc_dir, float* u_rec,
    int* tri_rec, int* sun_rec, unsigned long long* stats, void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile > ch::TRI_TILE || nb <= 0 || tile * nb != tp || max_bounce < 0)
    return (int)cudaErrorInvalidValue;
  const bool lights_ok = n_lights > 0 && light_v0 != nullptr && light_v1 != nullptr &&
                         light_v2 != nullptr && light_n != nullptr && light_power != nullptr &&
                         light_area != nullptr;
  if ((uniforms == nullptr && key == nullptr) || (nee && !lights_ok) ||
      (record && (nee || u_rec == nullptr || tri_rec == nullptr ||
                  (sun_enabled && sun_rec == nullptr))))
    return (int)cudaErrorInvalidValue;
  int cap = 1;
  while (cap < nb) cap <<= 1;
  Params P;
  P.n = n;
  P.max_bounce = max_bounce;
  P.sun_enabled = sun_enabled;
  P.nee = nee;
  P.record = record;
  P.n_u = nee ? 5 : 2;
  P.p = p;
  P.nrm = nrm;
  P.mtype = mtype;
  P.color = color;
  P.rough = rough;
  P.live = live;
  P.in_dir = in_dir;
  P.sun_dir = sun_dir;
  P.sun_power = sun_power;
  P.f = ch::Feats{edges, plane, normal_d, bounds, tp, tile, nb, cap};
  P.attrs = attrs;
  P.lights = Lights{light_v0, light_v1, light_v2, light_n, light_power, light_area, n_lights};
  P.uniforms = uniforms;
  P.key = key;
  P.sample = sample;
  P.rad = rad;
  P.esc_thr = esc_thr;
  P.esc_dir = esc_dir;
  P.u_rec = u_rec;
  P.tri_rec = tri_rec;
  P.sun_rec = sun_rec;
  P.stats = stats;
  const size_t smem = ch::FEAT_ROWS * ch::TRI_TILE * sizeof(float) + cap * sizeof(unsigned long long);
  static size_t smem_allowed = 48 * 1024;  // raised once, to the largest size asked
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int grid = (n + RAYS - 1) / RAYS;
  fused_sample_kernel<<<grid, RAYS, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
