// Fused sample kernels for Hopper (sm_90a) on a one-block scene: the whole
// bounce loop of a Monte-Carlo sample in one launch (fused_sample_launch),
// and a whole render, every sample of every ray with the IBL of each escape
// and the sum over samples, in one launch (fused_render_launch).
//
// Replaces the JAX package's TPU kernel
//   ensem3a_openclraytracer_tpu/ops/fused.py  _make_kernel / kernel (sample_fused)
// in its one-block role (csrc/fused_queue.cu takes scenes of more blocks).
// fused_sample_launch computes what ops/fused.sample_fused_plain computes:
// from the cached primary vertex, per bounce the emissive terminal, optional
// next-event estimation (one area-sampled light point and its shadow ray),
// Lambert / GGX / tint-glass sampling, the bounce trace, the escape record and
// the in-loop sun shadow with its glass tint; record mode also writes the
// drawn uniforms and the winning triangles.  fused_render_launch computes what
// ops/fused.render_fused_plain computes: for samples [s0, s0 + ns) the sum of
// rad + esc_thr * ibl(esc_dir) * ibl_power, in that order, per ray.
// The TPU kernel's answers to TPU limits are not carried over: no split-bf16
// products, no packed (t | row) keys, no one-hot attribute matmuls, no SMEM
// scalar-prefetch tables.  Instead:
//   * one thread per ray, its whole state (~40 floats) in registers across
//     the bounce loop; RAYS rays per CUDA block;
//   * every trace is exact f32 (t > MIN_HIT_DIST, the answer of trace_plain):
//     the block's packed features (TriFeatures.packed, 25.6 KB at most) are
//     staged into shared memory once per CUDA block and stay there for every
//     trace (the analogue of the TPU's VMEM-resident operand, with no barrier
//     in a trace), and each triangle is tested with ch::test_packed: six
//     16-byte broadcast reads and one 4-byte read per (ray, triangle) pair,
//     not 25 scalar reads;
//   * the shading and the IBL lookup are csrc/shading.cuh's;
//   * the winner's attributes are one 32-byte row gather of the [Tp, 8] table;
//   * random numbers are explicit uniforms [mb+1, N, n_u] per sample or the
//     Philox stream of csrc/philox.cuh: lane r at bounce b of sample s draws
//     flat index (b N + r) n_u + k of stream (key, s), so a whole-render launch
//     draws the numbers that one launch per sample draws.
// The whole-render launch is persistent: a grid of one resident wave (the
// occupancy API's CUDA blocks per SM x SMs) takes work items (a tile of RAYS
// lanes, a chunk of samples) from a device counter, so no partial last wave
// idles the card.  A chunk's sum goes to partial [chunks, N, 3]; the CUDA
// block that finishes a tile's last chunk adds the chunks in chunk order into
// out: deterministic, no float atomics.  One chunk writes out directly.
// What bounds it on an H100: FP32 operations, mostly the (ray, triangle)
// pairs of its traces (about 45 each) at 67 TFLOP/s; per ray it reads ~60
// bytes of primary state (per sample, from L1/L2) and writes 12-36, so bytes
// are small beside them.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "closest_hit.cuh"
#include "shading.cuh"

namespace {

using namespace shade;

constexpr int RAYS = 128;
// Work items per resident CUDA block the whole-render launch aims at: enough
// that the last items to finish are a small share of the launch.
constexpr int ITEMS_PER_SLOT = 16;

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
  const float4* __restrict__ packed;    // [tile, 7] float4 (one block)
  const float* __restrict__ bounds;     // [1, 8]
  int tile;
  const float* __restrict__ attrs;   // [tp, 8]
  Lights lights;
  const float* __restrict__ uniforms;  // [mb+1, n, n_u] per sample ([ns, ...] to render), or null
  const unsigned* __restrict__ key;    // [2] or null
  int sample;                          // the sample, or the render's first sample s0
  // one sample
  float* __restrict__ rad;
  float* __restrict__ esc_thr;
  float* __restrict__ esc_dir;
  float* __restrict__ u_rec;  // [mb+1, n, 2]
  int* __restrict__ tri_rec;  // [mb+1, n]
  int* __restrict__ sun_rec;  // [mb+1, n]
  // a render
  int ns, chunks, per;              // samples, sample chunks, samples per chunk
  const float* __restrict__ ibl;    // [ibl_h, ibl_w, 3]
  int ibl_h, ibl_w, ibl_bilinear;
  const float* __restrict__ ibl_power;  // [1]
  float* __restrict__ partial;  // [chunks, n, 3] when chunks > 1
  int* __restrict__ ctrl;       // [1 + tiles]: the item counter, then chunks done per tile
  float* __restrict__ out;      // [n, 3]
  unsigned long long* __restrict__ stats;  // [5]: pairs [0], stagings [1], slab tests [3]
};

// One sample of lane i (in_range false: a dead lane that only idles along):
// rad, and the escape's throughput and direction (0 and +z when the path did
// not escape).  Returns whether it escaped.  RENDER compiles record mode out.
template <bool RENDER>
__device__ __forceinline__ bool sample_lane(const Params& P, const float4* feat, int i,
                                            bool in_range, const float* uniforms, int sample,
                                            ch::Counts& counts, float rad[3], float esc_thr[3],
                                            float esc_dir[3]) {
  const bool record = !RENDER && P.record;
  // The closest hit of (o, d) on the resident block for an active lane.
  auto trace = [&](const float o[3], const float d[3], bool active, float& t, int& tri) {
    const ch::Ray r[1] = {ch::make_ray(o, d)};
    bool act[1] = {false};
    float bt[1] = {ch::MAX_DIST};
    int bi[1] = {0};
    if (active) {
      ++counts.slabs;
      act[0] = ch::block_entry(r[0], P.bounds, 0) <= ch::MAX_DIST;
      if (act[0]) {
        counts.pairs += P.tile;
        ch::test_packed(feat, 0, P.tile, r, act, bt, bi);
      }
    }
    const bool hit = bt[0] < ch::MISS_T;
    t = hit ? bt[0] : ch::MAX_DIST;
    tri = hit ? bi[0] : 0;
    return hit;
  };

  float p[3], n[3], color[3], in_d[3];
  float thr[3] = {1.0f, 1.0f, 1.0f};
  bool escaped = false;
  int mtype = EMISSIVE;
  float rough = 0.0f;
  bool live = false, emit_ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rad[k] = 0.0f;
    esc_thr[k] = 0.0f;
    esc_dir[k] = k == 2 ? 1.0f : 0.0f;
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
    if (in_range) draw(uniforms, key, sample, P.n_u, row, u);
    const float u1 = u[0], u2 = u[1];

    if (P.nee) {
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
    const bool hit = trace(p, bdir, in_range && (live || record), t, tri);
    const bool miss = live && !hit;
    if (miss) {
      escaped = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        esc_thr[k] = thr[k];
        esc_dir[k] = bdir[k];
      }
    }
    if (P.sun_enabled) {
      float st;
      int stri;
      const bool shit = trace(p, sun_dir, in_range && (miss || record), st, stri);
      if (miss) add_sun(P.attrs, shit, stri, mtype, thr, sun_power, rad);
      if (record && in_range) P.sun_rec[row] = shit ? stri : -1;
    }
    if (record && in_range) {
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
  return escaped;
}

// The CUDA block's counts into stats: pairs tested [0], one staging per CUDA
// block [1], slab tests [3].
__device__ __forceinline__ void add_stats(unsigned long long* stats, const ch::Counts& counts) {
  if (stats == nullptr) return;
  unsigned long long pairs = counts.pairs, slabs = counts.slabs;
  for (int off = 16; off > 0; off >>= 1) {
    pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    slabs += __shfl_down_sync(0xffffffffu, slabs, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (pairs) atomicAdd(&stats[0], pairs);
    if (slabs) atomicAdd(&stats[3], slabs);
  }
  if (threadIdx.x == 0) atomicAdd(&stats[1], 1ull);
}

// One sample: lane blockIdx.x * RAYS + threadIdx.x.
__global__ void __launch_bounds__(RAYS) fused_sample_kernel(const Params P) {
  __shared__ float4 feat[ch::PACKED_BUF4];
  ch::stage_packed(P.packed, P.tile, feat);
  __syncthreads();
  const int i = blockIdx.x * RAYS + threadIdx.x;
  const bool in_range = i < P.n;
  ch::Counts counts;
  float rad[3], esc_thr[3], esc_dir[3];
  sample_lane<false>(P, feat, i, in_range, P.uniforms, P.sample, counts, rad, esc_thr, esc_dir);
  if (in_range) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      P.rad[3 * i + k] = rad[k];
      P.esc_thr[3 * i + k] = esc_thr[k];
      P.esc_dir[3 * i + k] = esc_dir[k];
    }
  }
  add_stats(P.stats, counts);
}

// A whole render: persistent CUDA blocks take (tile, chunk) items, chunk-major,
// from the device counter ctrl[0].
__global__ void __launch_bounds__(RAYS) fused_render_kernel(const Params P) {
  __shared__ float4 feat[ch::PACKED_BUF4];
  __shared__ int s_item, s_last;
  ch::stage_packed(P.packed, P.tile, feat);
  ch::Counts counts;
  const int tiles = (P.n + RAYS - 1) / RAYS;
  const int items = tiles * P.chunks;
  const long long per_sample = static_cast<long long>(P.max_bounce + 1) * P.n * P.n_u;
  for (;;) {
    __syncthreads();  // the features are staged; every thread has read s_item and s_last
    if (threadIdx.x == 0) s_item = atomicAdd(P.ctrl, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= items) break;
    const int chunk = item / tiles, tile = item - chunk * tiles;
    const int i = tile * RAYS + threadIdx.x;
    const bool in_range = i < P.n;
    const int s_hi = min(P.ns, (chunk + 1) * P.per);
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int s = chunk * P.per; s < s_hi; ++s) {
      const float* u = P.uniforms != nullptr ? P.uniforms + s * per_sample : nullptr;
      float rad[3], esc_thr[3], esc_dir[3];
      const bool esc =
          sample_lane<true>(P, feat, i, in_range, u, P.sample + s, counts, rad, esc_thr, esc_dir);
      // acc + rad + esc_thr * ibl(esc_dir) * ibl_power, in the host's order;
      // a path that never escaped adds esc_thr = 0 times its lookup: nothing
      float e[3] = {0.0f, 0.0f, 0.0f};
      if (esc && in_range) ibl(P.ibl, P.ibl_h, P.ibl_w, P.ibl_bilinear != 0, P.ibl_power[0],
                               esc_dir, e);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float a = __fadd_rn(acc[k], rad[k]);
        acc[k] = esc ? __fadd_rn(a, __fmul_rn(esc_thr[k], e[k])) : a;
      }
    }
    if (P.chunks == 1) {
      if (in_range) {
#pragma unroll
        for (int k = 0; k < 3; ++k) P.out[3 * i + k] = acc[k];
      }
      continue;
    }
    if (in_range) {
      float* dst = P.partial + (static_cast<long long>(chunk) * P.n + i) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[k] = acc[k];
    }
    __threadfence();  // this chunk's sums are visible before the tile's count moves
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(P.ctrl + 1 + tile, 1) == P.chunks - 1;
    __syncthreads();
    if (s_last && in_range) {  // the tile's last chunk: add the chunks in order
      float sum[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) sum[k] = __ldcg(P.partial + 3 * i + k);
      for (int c = 1; c < P.chunks; ++c) {
        const float* src = P.partial + (static_cast<long long>(c) * P.n + i) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) sum[k] = __fadd_rn(sum[k], __ldcg(src + k));
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) P.out[3 * i + k] = sum[k];
    }
  }
  add_stats(P.stats, counts);
}

// The checked common arguments of both launches; returns a cudaError_t.
int fill_params(Params& P, int n, int max_bounce, int sun_enabled, int nee, int record,
                const float* p, const float* nrm, const int* mtype, const float* color,
                const float* rough, const unsigned char* live, const float* in_dir,
                const float* sun_dir, const float* sun_power, const float* packed,
                const float* bounds, int tp, int tile, int nb, const float* attrs,
                const float* light_v0, const float* light_v1, const float* light_v2,
                const float* light_n, const float* light_power, const float* light_area,
                int n_lights, const float* uniforms, const unsigned* key, int sample,
                unsigned long long* stats) {
  if (nb != 1 || tile <= 0 || tile > ch::TRI_TILE || tile != tp || max_bounce < 0 ||
      packed == nullptr || bounds == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool lights_ok = n_lights > 0 && light_v0 != nullptr && light_v1 != nullptr &&
                         light_v2 != nullptr && light_n != nullptr && light_power != nullptr &&
                         light_area != nullptr;
  if ((uniforms == nullptr && key == nullptr) || (nee && !lights_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  P = Params{};
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
  P.packed = reinterpret_cast<const float4*>(packed);
  P.bounds = bounds;
  P.tile = tile;
  P.attrs = attrs;
  P.lights = Lights{light_v0, light_v1, light_v2, light_n, light_power, light_area, n_lights};
  P.uniforms = uniforms;
  P.key = key;
  P.sample = sample;
  P.stats = stats;
  return 0;
}

}  // namespace

// One sample for n rays on `stream` (a cudaStream_t passed as void*).  The
// features are one block's: packed [tp, 28] f32 (16-byte aligned) and bounds
// [1, 8], with tile == tp <= 256 and nb == 1.  Either `uniforms` ([mb+1, n, 2
// or 5 with nee]) or `key` (two uint32 words on the card) must be given.
// `u_rec`, `tri_rec` (and `sun_rec` with sun) are needed with record, which
// excludes nee; nee needs the light columns.  `stats` may be null, else it
// receives [pairs tested, block stagings, -, slab tests, -] (added; it makes
// no rounds and no grid syncs).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fused_sample_launch(
    int n, int max_bounce, int sun_enabled, int nee, int record, const float* p,
    const float* nrm, const int* mtype, const float* color, const float* rough,
    const unsigned char* live, const float* in_dir, const float* sun_dir,
    const float* sun_power, const float* packed, const float* bounds, int tp, int tile, int nb,
    const float* attrs, const float* light_v0, const float* light_v1, const float* light_v2,
    const float* light_n, const float* light_power, const float* light_area, int n_lights,
    const float* uniforms, const unsigned* key, int sample, float* rad, float* esc_thr,
    float* esc_dir, float* u_rec, int* tri_rec, int* sun_rec, unsigned long long* stats,
    void* stream) {
  if (n <= 0) return 0;
  Params P;
  const int err = fill_params(P, n, max_bounce, sun_enabled, nee, record, p, nrm, mtype, color,
                              rough, live, in_dir, sun_dir, sun_power, packed, bounds, tp, tile,
                              nb, attrs, light_v0, light_v1, light_v2, light_n, light_power,
                              light_area, n_lights, uniforms, key, sample, stats);
  if (err != 0) return err;
  if (record && (nee || u_rec == nullptr || tri_rec == nullptr ||
                 (sun_enabled && sun_rec == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  P.rad = rad;
  P.esc_thr = esc_thr;
  P.esc_dir = esc_dir;
  P.u_rec = u_rec;
  P.tri_rec = tri_rec;
  P.sun_rec = sun_rec;
  fused_sample_kernel<<<(n + RAYS - 1) / RAYS, RAYS, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The whole-render launch's plan for n rays and ns samples on the current
// card: out[0] sample chunks, out[1] samples per chunk, out[2] CUDA blocks of
// the grid, out[3] resident CUDA blocks per SM (the occupancy API's count),
// out[4] SMs, out[5] registers per thread, out[6] threads per CUDA block,
// out[7] static shared memory per CUDA block, out[8] local memory (spills and
// stack) bytes per thread, out[9] work items.  Chunks are as many as give
// about ITEMS_PER_SLOT items per resident CUDA block, at most ns.  Returns a
// cudaError_t.
extern "C" int fused_render_plan(int n, int ns, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_render_kernel, RAYS, 0);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_render_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (std::max(n, 1) + RAYS - 1) / RAYS, slots = per_sm * sms;
  ns = std::max(ns, 1);
  int chunks = std::min(ns, std::max(1, (ITEMS_PER_SLOT * slots + tiles - 1) / tiles));
  const int per = (ns + chunks - 1) / chunks;
  chunks = (ns + per - 1) / per;  // no empty chunk
  out[0] = chunks;
  out[1] = per;
  out[2] = std::min(tiles * chunks, slots);
  out[3] = per_sm;
  out[4] = sms;
  out[5] = attr.numRegs;
  out[6] = RAYS;
  out[7] = static_cast<int>(attr.sharedSizeBytes);
  out[8] = static_cast<int>(attr.localSizeBytes);
  out[9] = tiles * chunks;
  return 0;
}

// Samples [s0, s0 + ns) for n rays in one launch on `stream`: out [n, 3] gets
// the sum over the samples of rad + esc_thr * ibl(esc_dir) * ibl_power.
// Arguments as fused_sample_launch's, except: `uniforms`, when given, is [ns,
// mb+1, n, 2 or 5]; `key`'s stream is drawn for samples s0 .. s0 + ns - 1; no
// record; the IBL image `ibl` [ibl_h, ibl_w, 3] f32 with `ibl_power` [1] and
// the lookup's filter; `chunks`, `per` and `grid` from fused_render_plan(n,
// ns) (out[0], out[1], out[2]), taken as given; `partial` [chunks, n, 3] f32
// scratch (null when chunks == 1) and `ctrl` [1 + ceil(n / 128)] int32 zeros.
// Returns the cudaError_t of the launch.
extern "C" int fused_render_launch(
    int n, int max_bounce, int sun_enabled, int nee, const float* p, const float* nrm,
    const int* mtype, const float* color, const float* rough, const unsigned char* live,
    const float* in_dir, const float* sun_dir, const float* sun_power, const float* packed,
    const float* bounds, int tp, int tile, int nb, const float* attrs, const float* light_v0,
    const float* light_v1, const float* light_v2, const float* light_n,
    const float* light_power, const float* light_area, int n_lights, const float* uniforms,
    const unsigned* key, int s0, int ns, const float* ibl, int ibl_h, int ibl_w,
    int ibl_bilinear, const float* ibl_power, int chunks, int per, int grid, float* partial,
    int* ctrl, float* out, unsigned long long* stats, void* stream) {
  if (n <= 0 || ns <= 0) return 0;
  Params P;
  const int err = fill_params(P, n, max_bounce, sun_enabled, nee, 0, p, nrm, mtype, color,
                              rough, live, in_dir, sun_dir, sun_power, packed, bounds, tp, tile,
                              nb, attrs, light_v0, light_v1, light_v2, light_n, light_power,
                              light_area, n_lights, uniforms, key, s0, stats);
  if (err != 0) return err;
  if (chunks < 1 || per < 1 || (chunks - 1) * per >= ns || chunks * per < ns || grid < 1 ||
      ctrl == nullptr || out == nullptr || (chunks > 1 && partial == nullptr) ||
      ibl == nullptr || ibl_power == nullptr || ibl_h <= 0 || ibl_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  P.ns = ns;
  P.chunks = chunks;
  P.per = per;
  P.ibl = ibl;
  P.ibl_h = ibl_h;
  P.ibl_w = ibl_w;
  P.ibl_bilinear = ibl_bilinear;
  P.ibl_power = ibl_power;
  P.partial = partial;
  P.ctrl = ctrl;
  P.out = out;
  fused_render_kernel<<<grid, RAYS, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
