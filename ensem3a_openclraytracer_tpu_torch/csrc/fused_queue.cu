// Fused whole-sample kernel for scenes of more than one triangle block, for
// Hopper (sm_90a): one cooperative launch per sample, every trace through the
// block queues of csrc/pairs.cuh.
//
// Replaces, on multi-block scenes, the JAX package's TPU kernel
//   ensem3a_openclraytracer_tpu/ops/fused.py  _make_kernel / kernel (sample_fused)
// and computes what ops/fused.sample_fused_plain computes, as
// csrc/fused_sample.cu does on one block: per bounce the emissive terminal,
// optional next-event estimation (NEE), Lambert / GGX / tint-glass sampling,
// the bounce trace, the escape record and the sun shadow with its glass tint;
// record mode also writes the drawn uniforms and the winning triangles, and
// traces dead lanes too, as the TPU kernel does.  Random numbers are explicit
// uniforms [mb+1, N, n_u] or the Philox stream of csrc/philox.cuh: lane r at
// bounce b draws flat index (b N + r) n_u + k, r the lane's place in the batch.
//
// csrc/fused_sample.cu keeps a ray's state in registers and traces with its
// own CUDA block's cull -> sort -> visit, so each CUDA block waits at every
// staged triangle block for its slowest ray, and rays of other CUDA blocks
// that need the same block stage it again.  Here the state lives in device
// memory between the traces ([3, N] vectors, ~30 words a lane), and a trace
// is the rounds of csrc/pairs.cuh over the rays of the whole grid: each
// staging of a triangle block serves up to CHUNK queued rays that all need
// it, with no barrier per visit, and the next block is staged by cp.async
// while this one is tested.
//
// The grid is every CUDA block that fits at once (the occupancy API's count
// per SM x the SMs).  Threads grid-stride over the lanes, so one thread reads
// and writes a lane's state in every phase.  Per bounce, with grid syncs
// between the phases:
//   shade    the previous bounce's sun term, the emissive terminal, the draws,
//            the NEE light point and its contribution should it be visible,
//            the bounce sample; lists the bounce ray (slot = lane) and the NEE
//            shadow ray (slot N + lane) for the trace;
//   trace    the rounds on both rays at once (neither depends on the other);
//   resolve  NEE visibility, the escape and bounce records; lists the sun ray
//            (slot = lane) of each escaping lane (of every lane in record
//            mode); advances to the new vertex;
//   trace    the rounds on the sun rays (with sun only).
// A last pass adds the last sun term and the final emissive term, then either
// writes the outputs (one sample: rad, esc_thr, esc_dir) or, given a running
// sum acc, looks up the sky of each escape (shade::ibl) and adds the sample
// into acc in the host's order, as csrc/fused_sample.cu's whole-render launch
// does; a render is then one launch a sample with nothing between them.
// Every trace's (t, tri) equals trace_plain's bit for bit, whatever order the
// work ran in: the fold is the exact 64-bit atomicMin of (t bits) << 32 | tri.
// The wrapper reads nothing back.
// What bounds it on an H100: FP32 operations, about 45 per (ray, triangle)
// pair that its traces need, at 67 TFLOP/s; per lane and bounce the state
// moves ~250 bytes, small beside them.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "pairs.cuh"
#include "shading.cuh"

namespace {

using bq::THREADS;
using namespace shade;

constexpr int K = 8;  // blocks each live ray takes per round (ops/pairs.K)
constexpr unsigned FULL = 0xffffffffu;
// per-lane flags
constexpr int LIVE = 1, EMIT_OK = 2, WANT = 4, MISS = 8, ESCAPED = 16;

// The lane state between the phases: [3, n] vectors and [n] scalars.
struct State {
  float *p, *n, *color, *in_d, *thr, *rad, *esc_thr, *esc_dir, *nee_c;
  float *rough, *nee_dist;
  int *mtype, *flags;
};

struct Params {
  bq::Queues q;  // the trace's rays are ray_o / ray_d below
  float* ray_o;  // [slots, 3]: slot i the bounce or sun ray of lane i, n + i its NEE ray
  float* ray_d;
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
  const float* __restrict__ attrs;      // [tp, 8]
  Lights lights;
  const float* __restrict__ uniforms;  // [mb+1, n, n_u] or null
  const unsigned* __restrict__ key;    // [2] or null
  int sample;
  float* rad;
  float* esc_thr;
  float* esc_dir;
  float* acc;                            // [n, 3] running sum, or null (then rad, esc_*)
  const float* __restrict__ ibl;         // [ibl_h, ibl_w, 3], with acc
  int ibl_h, ibl_w, ibl_bilinear;
  const float* __restrict__ ibl_power;  // [1], with acc
  float* u_rec;   // [mb+1, n, 2]
  int* tri_rec;   // [mb+1, n]
  int* sun_rec;   // [mb+1, n]
  unsigned long long* stats;  // [S_LANES + max_bounce + 1] (see below) or null
  State s;
};

// The slots of stats (ops/fused.QUEUE_STATS names them): pairs tested,
// stagings, rounds and slab tests (bq::add_tally), grid syncs, segments
// traced, the sum over CUDA blocks of thread 0's cycles inside grid syncs
// and from entry to exit, CUDA block 0's cycles by phase, the rounds that
// ran with more than one triangle slice and the work items run (added by the
// scan), the rounds whose select ran with more than one lane a ray (the three
// slots of bq::Queues split), the NEE shadow rays listed, the (ray, sub-tile)
// entries of the queued pairs whose sub-tile holds a triangle and those the
// test phase's cull kept (bq::add_tally), the lanes whose sky the launch
// looked up (with acc only), the sum over CUDA blocks of thread 0's cycles
// inside the rounds' selects, then the segments of each bounce.
constexpr int S_SYNCS = 4, S_SEGMENTS = 5, S_SYNC_CYCLES = 6, S_KERNEL_CYCLES = 7, S_PHASE = 8;
enum Phase { SHADE, BOUNCE_TRACE, RESOLVE, SUN_TRACE, FINISH, N_PHASES };
constexpr int S_SPLIT = S_PHASE + N_PHASES;
constexpr int S_NEE_RAYS = S_SPLIT + 3;
constexpr int S_SUBTILES = S_NEE_RAYS + 1;
constexpr int S_LOOKUPS = S_SUBTILES + 2;
constexpr int S_SELECT_CYCLES = S_LOOKUPS + 1;
constexpr int S_LANES = S_SELECT_CYCLES + 1;

// The NEE shadow rays this CUDA block listed (with stats), in shared memory
// as bq::sync_cycles is, so the count holds no register.
__shared__ unsigned nee_listed;

// Thread 0's clock (32 bits: a launch lasts far less than 2^32 cycles) in
// shared memory, so that timing holds no register through the kernel: its
// entry, and on CUDA block 0 the last mark and the cycles of each phase.
struct Clock {
  unsigned entry, last, phase[N_PHASES];
};

// On CUDA block 0's thread 0: the cycles since the last mark (or entry) to
// phase ph.
__device__ __forceinline__ void mark(Clock& c, int ph) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const unsigned now = static_cast<unsigned>(clock());
  c.phase[ph] += now - c.last;
  c.last = now;
}

__device__ __forceinline__ void ld3(const float* a, int n, int i, float v[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = a[k * n + i];
}

__device__ __forceinline__ void st3(float* a, int n, int i, const float v[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k * n + i] = v[k];
}

// Lists ray (o, d) in slot `slot` for the next trace where `take`: no hit and
// no cursor yet, and a place in live list 0.  Every lane of the warp calls it.
// Returns the warp's rays listed.
__device__ __forceinline__ int list_ray(const Params& P, bool take, int slot, const float o[3],
                                        const float d[3]) {
  const unsigned m = __ballot_sync(FULL, take);
  if (m == 0) return 0;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int first = 0;
  if (lane == leader) first = atomicAdd(&P.q.ctrl->live[0], __popc(m));
  first = __shfl_sync(FULL, first, leader);
  if (!take) return __popc(m);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    P.ray_o[3 * slot + k] = o[k];
    P.ray_d[3 * slot + k] = d[k];
  }
  P.q.best[slot] = bq::hit_key(ch::MAX_DIST, 0);
  P.q.cursor[slot] = bq::NONE;
  P.q.live[first + __popc(m & ((1u << lane) - 1u))] = slot;
  return __popc(m);
}

// The traced hit of a listed slot, with the miss rule of trace_plain.
__device__ __forceinline__ bool slot_hit(const Params& P, int slot, float& t, int& tri) {
  const unsigned long long key = __ldcg(P.q.best + slot);
  const float bt = bq::key_t(key);
  const bool hit = bt < ch::MISS_T;
  t = hit ? bt : ch::MAX_DIST;
  tri = hit ? static_cast<int>(key & 0xffffffffu) : 0;
  return hit;
}

// Bounce b's sun term of lane i: the sun's light if the lane escaped, and
// the sun record (its shadow ray was traced if it escaped or in record mode).
__device__ __forceinline__ void sun_term(const Params& P, int i, int b, int flags, int mtype,
                                         const float thr[3], float sun_power, float rad[3]) {
  const bool miss = flags & MISS;
  if (!miss && !P.record) return;
  float st;
  int stri;
  const bool shit = slot_hit(P, i, st, stri);
  if (miss) add_sun(P.attrs, shit, stri, mtype, thr, sun_power, rad);
  if (P.record) P.sun_rec[static_cast<long long>(b) * P.n + i] = shit ? stri : -1;
}

// Phase shade of bounce b for lane i (see the header).
__device__ __forceinline__ void shade_lane(const Params& P, int i, bool in, int b, uint2 key,
                                           float sun_power) {
  const int n = P.n;
  const State& S = P.s;
  float p[3] = {0.0f, 0.0f, 0.0f}, nn[3] = {0.0f, 0.0f, 1.0f}, color[3] = {0.0f, 0.0f, 0.0f},
        in_d[3] = {0.0f, 0.0f, -1.0f};
  float thr[3] = {1.0f, 1.0f, 1.0f}, rad[3] = {0.0f, 0.0f, 0.0f};
  int mtype = EMISSIVE, flags = EMIT_OK;
  float rough = 0.0f;
  if (in) {
    if (b == 0) {  // the cached primary vertex
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p[k] = P.p[3 * i + k];
        nn[k] = P.nrm[3 * i + k];
        color[k] = P.color[3 * i + k];
        in_d[k] = P.in_dir[3 * i + k];
      }
      mtype = P.mtype[i];
      rough = P.rough[i];
      if (P.live[i] != 0) flags |= LIVE;
      st3(S.p, n, i, p);
      st3(S.n, n, i, nn);
      st3(S.color, n, i, color);
      st3(S.in_d, n, i, in_d);
      S.mtype[i] = mtype;
      S.rough[i] = rough;
    } else {
      ld3(S.p, n, i, p);
      ld3(S.n, n, i, nn);
      ld3(S.color, n, i, color);
      ld3(S.in_d, n, i, in_d);
      ld3(S.thr, n, i, thr);
      ld3(S.rad, n, i, rad);
      mtype = S.mtype[i];
      rough = S.rough[i];
      flags = S.flags[i];
      if (P.sun_enabled) sun_term(P, i, b - 1, flags, mtype, thr, sun_power, rad);
    }
  }
  bool live = flags & LIVE, emit_ok = flags & EMIT_OK;
  const long long row = static_cast<long long>(b) * n + i;  // this lane's (bounce, ray) slot

  // terminal: emissive vertex (power in the roughness slot); with NEE,
  // suppressed when the previous vertex sampled the light
  const bool emis = live && mtype == EMISSIVE;
  if (P.nee ? (emis && emit_ok) : emis) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rad[k] += thr[k] * rough;
  }
  live = live && !emis;

  float u[5] = {0.5f, 0.5f, 0.5f, 0.5f, 0.5f};
  if (in) draw(P.uniforms, key, P.sample, P.n_u, row, u);

  bool want = false;
  if (P.nee) {  // uniform over the launch
    int li;
    float ldir[3], dist2, dist, cos_s, cos_l;
    light_point(P.lights, u, p, nn, li, ldir, dist2, dist, cos_s, cos_l);
    const bool sampled = live && mtype != GLASS;
    want = in && sampled && cos_s > 0.0f && cos_l > 1e-6f;
    if (want) {  // its contribution, added in resolve if the point is visible
      float brdf[3], c[3];
      const float s = light_weight(P.lights, li, mtype, color, rough, in_d, ldir, nn, cos_s,
                                   cos_l, dist2, brdf);
#pragma unroll
      for (int k = 0; k < 3; ++k) c[k] = thr[k] * brdf[k] * s;
      st3(S.nee_c, n, i, c);
      S.nee_dist[i] = dist;
    }
    if (live) emit_ok = !sampled;
    const int listed = list_ray(P, want, n + i, p, ldir);
    if (P.stats != nullptr && (threadIdx.x & 31) == 0 && listed != 0)
      atomicAdd(&nee_listed, static_cast<unsigned>(listed));
  }

  float bdir[3];
  bounce(nn, in_d, color, rough, mtype, live, u[0], u[1], bdir, thr);
  // record mode traces dead lanes too, as the TPU kernel
  list_ray(P, in && (live || P.record), i, p, bdir);
  if (!in) return;
  if (P.record) {
    P.u_rec[2 * row] = u[0];
    P.u_rec[2 * row + 1] = u[1];
  }
  st3(S.thr, n, i, thr);
  st3(S.rad, n, i, rad);
  S.flags[i] = (flags & ESCAPED) | (live ? LIVE : 0) | (emit_ok ? EMIT_OK : 0) | (want ? WANT : 0);
}

// Phase resolve of bounce b for lane i (see the header).
__device__ __forceinline__ void resolve_lane(const Params& P, int i, bool in, int b,
                                             const float sun_dir[3]) {
  const int n = P.n;
  const State& S = P.s;
  int flags = 0;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
    flags = S.flags[i];
    ld3(S.p, n, i, p);
  }
  bool live = flags & LIVE;
  float t = ch::MAX_DIST;
  int tri = 0;
  bool hit = false;
  if (in && (live || P.record)) hit = slot_hit(P, i, t, tri);
  if (flags & WANT) {  // NEE: the light point's contribution if nothing is in the way
    float st;
    int stri;
    slot_hit(P, n + i, st, stri);
    if (st >= S.nee_dist[i] * (1.0f - 1e-3f)) {
      float rad[3], c[3];
      ld3(S.rad, n, i, rad);
      ld3(S.nee_c, n, i, c);
#pragma unroll
      for (int k = 0; k < 3; ++k) rad[k] += c[k];
      st3(S.rad, n, i, rad);
    }
  }
  const bool miss = live && !hit;
  float bdir[3] = {0.0f, 0.0f, 1.0f};
  if (in && (live || P.record)) {  // the bounce ray this thread listed
#pragma unroll
    for (int k = 0; k < 3; ++k) bdir[k] = P.ray_d[3 * i + k];
  }
  if (miss) {
    float thr[3];
    ld3(S.thr, n, i, thr);
    st3(S.esc_thr, n, i, thr);
    st3(S.esc_dir, n, i, bdir);
    flags |= ESCAPED;
  }
  if (in && P.record) P.tri_rec[static_cast<long long>(b) * n + i] = hit ? tri : -1;
  if (P.sun_enabled) list_ray(P, in && (miss || P.record), i, p, sun_dir);
  if (!in) return;

  live = live && hit;
  if (live) {  // advance to the new vertex
    const float* at = P.attrs + N_ATTR * tri;
    float nn[3], color[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = p[k] + bdir[k] * t;
      nn[k] = at[k];
      color[k] = at[4 + k];
    }
    st3(S.p, n, i, p);
    st3(S.n, n, i, nn);
    st3(S.color, n, i, color);
    st3(S.in_d, n, i, bdir);
    S.mtype[i] = __float2int_rn(at[3]);
    S.rough[i] = at[7];
  }
  S.flags[i] = (flags & (EMIT_OK | ESCAPED)) | (live ? LIVE : 0) | (miss ? MISS : 0);
}

// The last sun term, the final emissive term and the outputs of lane i: with
// acc, acc + rad + esc_thr * ibl(esc_dir) * ibl_power in the host's order
// (csrc/fused_sample.cu's whole-render launch), a lane that never escaped
// adding rad alone; else rad, esc_thr and esc_dir.  True where it looked up
// the sky.
__device__ __forceinline__ bool finish_lane(const Params& P, int i, float sun_power) {
  const int n = P.n;
  const State& S = P.s;
  float thr[3], rad[3];
  ld3(S.thr, n, i, thr);
  ld3(S.rad, n, i, rad);
  const int flags = S.flags[i], mtype = S.mtype[i];
  if (P.sun_enabled) sun_term(P, i, P.max_bounce, flags, mtype, thr, sun_power, rad);
  // a path whose last segment landed on a light still contributes
  if ((flags & LIVE) && mtype == EMISSIVE && (!P.nee || (flags & EMIT_OK))) {
    const float rough = S.rough[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) rad[k] += thr[k] * rough;
  }
  const bool esc = flags & ESCAPED;
  float esc_thr[3] = {0.0f, 0.0f, 0.0f}, esc_dir[3] = {0.0f, 0.0f, 1.0f};
  if (esc) {
    ld3(S.esc_thr, n, i, esc_thr);
    ld3(S.esc_dir, n, i, esc_dir);
  }
  if (P.acc != nullptr) {  // uniform over the launch
    float e[3] = {0.0f, 0.0f, 0.0f};
    if (esc) ibl(P.ibl, P.ibl_h, P.ibl_w, P.ibl_bilinear != 0, P.ibl_power[0], esc_dir, e);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = __fadd_rn(P.acc[3 * i + k], rad[k]);
      P.acc[3 * i + k] = esc ? __fadd_rn(a, __fmul_rn(esc_thr[k], e[k])) : a;
    }
    return esc;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    P.rad[3 * i + k] = rad[k];
    P.esc_thr[3 * i + k] = esc_thr[k];
    P.esc_dir[3 * i + k] = esc_dir[k];
  }
  return false;
}

// Four CUDA blocks an SM, the grid's occupancy: with the bound ptxas keeps
// every value in registers (without it, it chose 96 and spilled 112 bytes).
__global__ void __launch_bounds__(THREADS, 4) fused_queue_kernel(Params P) {
  extern __shared__ __align__(16) float4 smem[];  // staging buffers and lists, or select's bounds
  __shared__ int4 s_work;
  __shared__ unsigned long long s_scan[THREADS];
  __shared__ Clock s_clock;
  bq::cg::grid_group grid = bq::cg::this_grid();
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int stride = gridDim.x * THREADS;
  const int n = P.n;

  if (threadIdx.x == 0) {
    s_clock = Clock{};
    s_clock.entry = s_clock.last = static_cast<unsigned>(clock());
    bq::sync_cycles = 0;
    bq::select_cycles = 0;
    bq::test_counts = bq::TestCounts{};
    nee_listed = 0;
  }
  for (int j = gtid; j < P.q.nb; j += stride) P.q.cnt[j] = 0;
  if (gtid == 0) {
    P.q.ctrl->live[0] = 0;
    P.q.ctrl->live[1] = 0;
  }
  // the rays listed for the trace that follows (read by the thread that
  // clears the count at the trace's end): segments, and bounce b's
  auto count_listed = [&](int b) {
    if (gtid != 0 || P.stats == nullptr) return;
    const unsigned long long listed = static_cast<unsigned>(__ldcg(&P.q.ctrl->live[0]));
    if (listed == 0) return;
    atomicAdd(&P.stats[S_SEGMENTS], listed);
    atomicAdd(&P.stats[S_LANES + b], listed);
  };
  const float sun_dir[3] = {P.sun_dir[0], P.sun_dir[1], P.sun_dir[2]};
  const float sun_power = P.sun_power[0];
  uint2 key = make_uint2(0u, 0u);
  if (P.key != nullptr) key = make_uint2(P.key[0], P.key[1]);
  bq::Tally tally;
  bq::sync<true>(grid, tally);

  // every thread of a warp takes part in each pass (the listing is warp-wide)
  for (int b = 0; b <= P.max_bounce; ++b) {
    for (int base = blockIdx.x * THREADS; base < n; base += stride)
      shade_lane(P, base + threadIdx.x, base + threadIdx.x < n, b, key, sun_power);
    bq::sync<true>(grid, tally);
    mark(s_clock, SHADE);
    count_listed(b);
    bq::trace_rounds<K, true, true>(P.q, grid, smem, &s_work, s_scan, tally);
    bq::sync<true>(grid, tally);  // every thread has read the last live count before the next listing
    mark(s_clock, BOUNCE_TRACE);
    for (int base = blockIdx.x * THREADS; base < n; base += stride)
      resolve_lane(P, base + threadIdx.x, base + threadIdx.x < n, b, sun_dir);
    if (P.sun_enabled) {  // uniform over the launch
      bq::sync<true>(grid, tally);
      mark(s_clock, RESOLVE);
      count_listed(b);
      bq::trace_rounds<K, true, true>(P.q, grid, smem, &s_work, s_scan, tally);
      bq::sync<true>(grid, tally);
      mark(s_clock, SUN_TRACE);
    } else {
      mark(s_clock, RESOLVE);
    }
  }
  unsigned lookups = 0;
  for (int i = gtid; i < n; i += stride) lookups += finish_lane(P, i, sun_power) ? 1u : 0u;
  if (P.stats != nullptr) {
    mark(s_clock, FINISH);
    bq::add_tally(P.stats, tally, P.stats + S_SUBTILES);
    lookups = __reduce_add_sync(FULL, lookups);
    if ((threadIdx.x & 31) == 0 && lookups != 0)
      atomicAdd(&P.stats[S_LOOKUPS], static_cast<unsigned long long>(lookups));
    if (threadIdx.x == 0) {
      if (nee_listed != 0)
        atomicAdd(&P.stats[S_NEE_RAYS], static_cast<unsigned long long>(nee_listed));
      atomicAdd(&P.stats[S_SYNC_CYCLES], static_cast<unsigned long long>(bq::sync_cycles));
      atomicAdd(&P.stats[S_SELECT_CYCLES], static_cast<unsigned long long>(bq::select_cycles));
      atomicAdd(&P.stats[S_KERNEL_CYCLES],
                static_cast<unsigned long long>(static_cast<unsigned>(clock()) - s_clock.entry));
    }
    if (gtid == 0) {
      atomicAdd(&P.stats[S_SYNCS], static_cast<unsigned long long>(tally.syncs));
      for (int ph = 0; ph < N_PHASES; ++ph)
        atomicAdd(&P.stats[S_PHASE + ph], static_cast<unsigned long long>(s_clock.phase[ph]));
    }
  }
}

struct Layout {
  bq::QueueLayout q;
  size_t ray_o, ray_d, p, nrm, color, in_d, thr, rad, esc_thr, esc_dir, nee_c, rough, nee_dist,
      mtype, flags, total;
};

// Scratch of n lanes on nb blocks: the queues and rays of slots (2n with NEE,
// whose shadow rays share the bounce trace, else n), then the lane state.
Layout layout(long long n, long long nb, bool nee) {
  Layout l{};
  const long long slots = nee ? 2 * n : n;
  size_t at = 0;
  l.q = bq::queue_layout(slots, nb, K, at);
  l.ray_o = bq::take(at, 12 * slots);
  l.ray_d = bq::take(at, 12 * slots);
  for (size_t* v : {&l.p, &l.nrm, &l.color, &l.in_d, &l.thr, &l.rad, &l.esc_thr, &l.esc_dir})
    *v = bq::take(at, 12 * n);
  l.nee_c = bq::take(at, nee ? 12 * n : 0);
  for (size_t* v : {&l.rough, &l.nee_dist, &l.mtype, &l.flags}) *v = bq::take(at, 4 * n);
  l.total = at;
  return l;
}

}  // namespace

// Bytes of scratch that fused_queue_launch needs for n rays on nb blocks.
extern "C" long long fused_queue_scratch_bytes(int n, int nb, int nee) {
  return static_cast<long long>(layout(n, nb, nee != 0).total);
}

// The launch's grid: out[0] CUDA blocks per SM (the occupancy API's count),
// out[1] SMs, out[2] registers per thread, out[3] threads per CUDA block,
// out[4] dynamic shared memory per CUDA block, out[5] local memory (spill
// and stack) bytes per thread.  Returns a cudaError_t.
extern "C" int fused_queue_grid(int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = bq::grid_size(fused_queue_kernel, &out[0], &out[1]);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_queue_kernel);
  out[2] = attr.numRegs;
  out[3] = THREADS;
  out[4] = bq::SMEM_BYTES;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

// Triangles per sub-tile of the test phase's cull (bq::SUB); a library
// without this entry point takes no sub-tile boxes.
extern "C" int fused_queue_sub_tile() { return bq::SUB; }

// Most blocks whose bounds the select keeps in shared memory for a whole
// round (bq::SEL_BLOCKS).
extern "C" int fused_queue_sel_blocks() { return bq::SEL_BLOCKS; }

// One sample for n rays in one cooperative launch on `stream` (a
// cudaStream_t passed as void*).  Arguments as fused_sample_launch's, except
// the features: packed [tp, 28] f32, bounds [nb, 8] f32 and sub_bounds
// [nb * bq::SUBS, 8] f32 (the sub-tile boxes), each 16-byte aligned; scratch
// of fused_queue_scratch_bytes(n, nb, nee) bytes, 16-byte aligned, in any
// state; and `acc`: null, and the sample goes to rad, esc_thr
// and esc_dir (and the records), or an [n, 3] f32 running sum that the sample
// is added into, its sky looked up in the IBL image `ibl` [ibl_h, ibl_w, 3]
// f32 with `ibl_power` [1] and the lookup's filter (no record; rad, esc_thr
// and esc_dir unused).  `stats` may be null, else it receives its
// max_bounce + 22 slots (see S_LANES; added).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int fused_queue_launch(
    int n, int max_bounce, int sun_enabled, int nee, int record, const float* p,
    const float* nrm, const int* mtype, const float* color, const float* rough,
    const unsigned char* live, const float* in_dir, const float* sun_dir,
    const float* sun_power, const float* packed, const float* bounds, const float* sub_bounds,
    int tp, int tile, int nb,
    const float* attrs, const float* light_v0, const float* light_v1, const float* light_v2,
    const float* light_n, const float* light_power, const float* light_area, int n_lights,
    const float* uniforms, const unsigned* key, int sample, void* scratch, float* acc,
    const float* ibl, int ibl_h, int ibl_w, int ibl_bilinear, const float* ibl_power, float* rad,
    float* esc_thr, float* esc_dir, float* u_rec, int* tri_rec, int* sun_rec,
    unsigned long long* stats, void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || tile > ch::TRI_TILE || nb <= 0 || tile * nb != tp || max_bounce < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool lights_ok = n_lights > 0 && light_v0 != nullptr && light_v1 != nullptr &&
                         light_v2 != nullptr && light_n != nullptr && light_power != nullptr &&
                         light_area != nullptr;
  if ((uniforms == nullptr && key == nullptr) || (nee && !lights_ok) ||
      (record && (nee || u_rec == nullptr || tri_rec == nullptr ||
                  (sun_enabled && sun_rec == nullptr))) ||
      (acc != nullptr &&
       (record || ibl == nullptr || ibl_power == nullptr || ibl_h <= 0 || ibl_w <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n, nb, nee != 0);
  char* s = static_cast<char*>(scratch);
  Params P;
  P.q = bq::queues_at(s, l.q, nee ? 2 * n : n, nb, tile);
  P.ray_o = reinterpret_cast<float*>(s + l.ray_o);
  P.ray_d = reinterpret_cast<float*>(s + l.ray_d);
  P.q.ray_o = P.ray_o;
  P.q.ray_d = P.ray_d;
  P.q.packed = reinterpret_cast<const float4*>(packed);
  P.q.bounds = bounds;
  P.q.sub_bounds = sub_bounds;
  P.q.split = stats == nullptr ? nullptr : stats + S_SPLIT;
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
  P.attrs = attrs;
  P.lights = Lights{light_v0, light_v1, light_v2, light_n, light_power, light_area, n_lights};
  P.uniforms = uniforms;
  P.key = key;
  P.sample = sample;
  P.rad = rad;
  P.esc_thr = esc_thr;
  P.esc_dir = esc_dir;
  P.acc = acc;
  P.ibl = ibl;
  P.ibl_h = ibl_h;
  P.ibl_w = ibl_w;
  P.ibl_bilinear = ibl_bilinear;
  P.ibl_power = ibl_power;
  P.u_rec = u_rec;
  P.tri_rec = tri_rec;
  P.sun_rec = sun_rec;
  P.stats = stats;
  auto f = [s](size_t off) { return reinterpret_cast<float*>(s + off); };
  P.s = State{f(l.p),      f(l.nrm),     f(l.color), f(l.in_d),     f(l.thr),
              f(l.rad),    f(l.esc_thr), f(l.esc_dir), f(l.nee_c),  f(l.rough),
              f(l.nee_dist), reinterpret_cast<int*>(s + l.mtype), reinterpret_cast<int*>(s + l.flags)};
  int per_sm = 0, sms = 0;
  cudaError_t err = bq::grid_size(fused_queue_kernel, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* argv[] = {&P};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_queue_kernel),
                                    dim3(per_sm * sms), dim3(THREADS), argv, bq::SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
