// The rounds of the block-queue closest hit, shared by csrc/pairs.cu (one
// trace per launch) and csrc/fused_queue.cu (every trace of a sample in one
// launch).  They run on a ray list held in device memory, inside a cooperative
// launch whose grid-wide syncs separate the pieces of a round:
//
//   select  each live ray is slab-tested against every triangle block's
//           margined box (ch::block_entry; the bounds staged in shared
//           memory, in chunks above what fits), keeping in registers the K
//           least keys (entry bits << 32) | block that lie above its cursor
//           (the last key it queued) with entry <= its best t: the next K
//           blocks of its front-to-back walk, with no [N, B] matrix and no
//           sort.  Each chosen (ray, block) pair takes a slot in its block's
//           queue from a per-block counter.  A ray with more than K such
//           blocks stays live for the next round.  A round whose rays fill
//           the grid gives each ray one thread (warp-aggregated atomicAdd per
//           pick); a smaller round gives each a group of G lanes
//           (select_lanes), spread over every CUDA block: each lane tests
//           every G-th box of each staged chunk and keeps its own K least
//           across the chunks, the group merges them by K warp minima, and
//           each pick's lane queues it.  Up to AGG_BLOCKS blocks the CUDA
//           block's picks of one triangle block share one atomicAdd, counted
//           in shared memory beside the resident bounds; above, the picks of
//           one warp do (__match_any_sync).  The picks, cursor, sel_t, counts
//           and live list are the same for any G and any chunking; only the
//           order of a block's queue slots may differ.
//   scan    one CUDA block turns the per-block counts into queue offsets and
//           work items of up to CHUNK queued rays (an exclusive scan).
//   fill    each pair writes its ray into its block's queue.
//   test    CUDA blocks take work items (block, up to CHUNK rays, triangle
//           slice) from a device-side counter.  A round whose (block, chunk)
//           items are too few to fill the grid gives each to S CUDA blocks
//           (slices(), chosen by the scan), each staging and testing only
//           its tile / S triangles, so one warp no longer walks a whole
//           256-triangle tile while the grid waits at the next sync; a round
//           that fills the grid keeps S = 1.  The next item's triangles and
//           its block's sub-tile boxes are staged with cp.async into the
//           second of two shared-memory buffers while this one is tested.
//           A queued ray is tested only against the sub-tiles of SUB
//           triangles of its slice whose margined box (sub_bounds,
//           ch::block_entry) it enters no farther than the best t its
//           select read this round (sel_t): a farther sub-tile cannot hold
//           a nearer hit, and the select's t, unlike the live best, makes
//           the counts the same in every run.  The kept (ray, sub-tile)
//           entries are listed by sub-tile in shared memory, and each
//           thread takes two rays of one sub-tile at a time
//           (ch::test_range), so a warp's lanes read the same triangle at
//           once and each read feeds two pair tests.  A ray's best hit is
//           folded with a 64-bit atomicMin on (float bits of t) << 32 |
//           tri, which orders (t, tri) lexicographically for t > 0: the
//           fold is exact whatever order the items and slices run in.
// trace_rounds loops until no ray is live.  The arithmetic per (ray,
// triangle) pair is ch::test_packed's, term for term, and the slab test is
// ch::block_entry, so the result equals ops/closest_hit.trace_plain's.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace bq {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int RPT = 2;                  // rays per thread in the test phase's cull and tests
constexpr int CHUNK = THREADS * RPT;    // queued rays per work item
constexpr int PACK4 = ch::PACK4;        // float4s per triangle in the packed features [tp, 28]
// Triangles per sub-tile of the test phase's cull (ops/pairs.SUB): a warp,
// and the triangles of one slice at S = 8.
constexpr int SUB = 32;
constexpr int SUBS = ch::TRI_TILE / SUB;  // sub-tiles a block
static_assert(SUBS * SUB == ch::TRI_TILE, "a block is whole sub-tiles");
// One staged item: the block's triangles in ch's packed layout, then its
// SUBS sub-tile boxes (two float4s each).
constexpr int BUF4 = ch::PACKED_BUF4 + 2 * SUBS;
// The select's share of shared memory (bounds, a grouped select's counts):
// the two staging buffers without their boxes, 51,200 bytes.
constexpr int SEL_BYTES = 2 * ch::PACKED_BUF4 * 16;
// Two staging buffers, then the test phase's entry lists: per sub-tile the
// byte slots of the item's rays that keep it, the item's rays and the
// entries listed per sub-tile.
constexpr int LISTS = 2 * BUF4 * 16;
constexpr int SMEM_BYTES = LISTS + SUBS * CHUNK + 4 * CHUNK + 4 * SUBS;  // 54,816 bytes
constexpr int SEL_BLOCKS = SEL_BYTES / 32;  // bounds rows (two float4s each) per select chunk
// The most blocks whose bounds (32 bytes) and a grouped select's pick counts
// and first slots (8 bytes) share the select's shared memory: the most for
// which a grouped select counts its picks there (ops/pairs.AGG_BLOCKS); above,
// its warps take their slots from the global counts.
constexpr int AGG_BLOCKS = SEL_BYTES / 40;
static_assert(AGG_BLOCKS <= SEL_BLOCKS, "shared counts sit beside one chunk of every bound");
constexpr unsigned long long NONE = ~0ull;  // cursor of a ray that queued nothing yet
constexpr unsigned NO_BLOCK = 0xffffffffu;
// The most CUDA blocks that share one (block, chunk) item: 8 triangles a
// slice of a 256-triangle tile (ops/pairs.S_MAX; the sweep is in PERF.md).
constexpr int S_MAX = 32;
// The most select lanes a ray: a warp, within which the group's reductions
// stay (ops/pairs.G_MAX).
constexpr int G_MAX = 32;

struct Ctrl {
  int live[2];  // live rays of the round that reads list r & 1, and of the next
  int work;     // the work-item counter of the test phase
  int items;    // work items of this round, S per (block, chunk)
  int lg;       // log2 of this round's slices S
};

// The slices S of a round of `items` (block, chunk) work items on a grid of
// `grid` CUDA blocks: the largest power of two up to S_MAX with items x S <=
// grid; 1 when the items alone fill the grid, or when there are none
// (ops/pairs.slices).
__host__ __device__ __forceinline__ int slices(int items, int grid) {
  int s = 1;
  while (items > 0 && 2 * s <= S_MAX && items <= grid / (2 * s)) s *= 2;
  return s;
}

// The lanes G that select gives each live ray in a round of n_live rays on nb
// triangle blocks over grid_threads threads: the largest power of two with G
// <= G_MAX, G <= nb and n_live x G <= grid_threads, so one pass of the grid's
// groups takes every ray; 1 when none is larger or when no ray is live
// (ops/pairs.select_lanes).
__host__ __device__ __forceinline__ int select_lanes(int n_live, int nb, int grid_threads) {
  int g = 1;
  while (n_live > 0 && 2 * g <= G_MAX && 2 * g <= nb && n_live <= grid_threads / (2 * g))
    g *= 2;
  return g;
}

// The rays and the queues of one trace.  n is the capacity of the ray slots
// (each live list holds up to n slot indices).
struct Queues {
  const float* ray_o;    // [n, 3]
  const float* ray_d;    // [n, 3]
  const float4* packed;      // [tp, 7] float4: ch::FEAT_ROWS rows per triangle, padded to 28
  const float* bounds;       // [nb, 8]
  const float* sub_bounds;   // [nb * SUBS, 8]
  int n, nb, tile;
  unsigned long long* split;   // [3] rounds with S > 1, work items run and rounds whose select
                               // ran with G > 1 (added), or null
  unsigned long long* best;    // [n] (t bits << 32) | tri
  unsigned long long* cursor;  // [n] the last key queued, NONE before the first
  float* sel_t;                // [n] the best t each live ray's select read this round
  int2* pairs;                 // [n, K] (block, slot in its queue) of each live ray's picks
  int* live;                   // [2, n] live ray lists, alternating by round
  int* queue;                  // [n * K] rays grouped by block
  int* cnt;                    // [nb] pairs queued per block this round
  int* qoff;                   // [nb] each block's first queue slot
  int* qcnt;                   // [nb] each block's queued rays
  int* item_off;               // [nb + 1] each block's first work item
  Ctrl* ctrl;
};

// What a thread's share of the rounds counted; rounds and grid syncs are the
// same in every thread.
struct Tally {
  unsigned long long stagings = 0, slabs = 0;
  int rounds = 0, syncs = 0;
};

// What this CUDA block's test phases counted, on thread 0 alone and in
// shared memory (as sync_cycles), so that counting holds no register
// through the rounds: (ray, triangle) pairs tested, the (ray, sub-tile)
// entries of the queued pairs whose sub-tile holds a triangle, and those of
// them that the cull kept.  The kernel zeroes it.
struct TestCounts {
  unsigned long long pairs, offered, tested;
};
__shared__ TestCounts test_counts;

// Thread 0's clock cycles inside this CUDA block's timed grid syncs.  Kept in
// shared memory, 32 bits (a launch lasts far less than 2^32 cycles), so that
// timing holds no register through the rounds.  The kernel zeroes it.
__shared__ unsigned sync_cycles;
// As sync_cycles, thread 0's cycles inside the timed rounds' selects: from
// the round's start, bound staging included, to the end of the grid sync
// that ends the select, so that a block with few rays or none counts the
// wait for the slowest: each block's sum is the selects' wall time.  The
// start is subtracted and the end added, so no register holds it.
__shared__ unsigned select_cycles;

// A grid-wide sync, counted, and with TIMED timed on thread 0.
template <bool TIMED = false>
__device__ __forceinline__ void sync(cg::grid_group& grid, Tally& tally) {
  unsigned t0 = 0;
  if (TIMED && threadIdx.x == 0) t0 = static_cast<unsigned>(clock());
  grid.sync();
  if (TIMED && threadIdx.x == 0) sync_cycles += static_cast<unsigned>(clock()) - t0;
  ++tally.syncs;
}

// Cross-block data written during the launch is read with __ldcg (L2, never a
// stale L1 line).
__device__ __forceinline__ float key_t(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

// (float bits of t) << 32 | tri: ordered as (t, tri) for t >= 0
__device__ __forceinline__ unsigned long long hit_key(float t, int tri) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) | static_cast<unsigned>(tri);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ray i of the list.  FRESH: the rays were written during this launch, so
// they are read through L2.
template <bool FRESH>
__device__ __forceinline__ ch::Ray load_ray(const Queues& p, int i) {
  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = FRESH ? __ldcg(p.ray_o + 3 * i + k) : p.ray_o[3 * i + k];
    d[k] = FRESH ? __ldcg(p.ray_d + 3 * i + k) : p.ray_d[3 * i + k];
  }
  return ch::make_ray(o, d);
}

// Blocks [c0, c1)'s bounds into sb (two float4s each), between barriers.
__device__ __forceinline__ void stage_bounds(const Queues& p, float4* sb, int c0, int c1) {
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(p.bounds) + 2 * c0;
  for (int k = threadIdx.x; k < 2 * (c1 - c0); k += THREADS) sb[k] = src[k];
  __syncthreads();
}

// Blocks j = j0, j0 + step, ... below c1 of the chunk staged in b from block
// c0: each that the ray enters no farther than best_t, with a key above its
// cursor, counts in qual and joins the sorted K least keys in sel.
template <int K>
__device__ __forceinline__ void slab_keys(const ch::Ray& r, const float* b, int c0, int c1,
                                          int j0, int step, float best_t,
                                          unsigned long long cur, unsigned long long (&sel)[K],
                                          int& qual) {
  for (int j = j0; j < c1; j += step) {
    const float e = ch::block_entry(r, b, j - c0);
    if (!(e <= best_t)) continue;  // beyond the best hit, or missed (+inf)
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(e)) << 32) | static_cast<unsigned>(j);
    if (cur != NONE && key <= cur) continue;  // queued in an earlier round
    ++qual;
    if (key < sel[K - 1]) {  // insert into the sorted K least
      sel[K - 1] = key;
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        const unsigned long long lo = min(sel[s - 1], sel[s]), hi = max(sel[s - 1], sel[s]);
        sel[s - 1] = lo;
        sel[s] = hi;
      }
    }
  }
}

// This lane's slot in block blk's queue (blk NO_BLOCK: no pick, the slot
// unused): the warp's lanes that pick one block share one atomicAdd on p.cnt.
__device__ __forceinline__ int warp_slot(const Queues& p, unsigned blk, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, blk);
  const int leader = __ffs(peers) - 1;
  int first = 0;
  if (lane == leader && blk != NO_BLOCK) first = atomicAdd(p.cnt + blk, __popc(peers));
  first = __shfl_sync(0xffffffffu, first, leader);
  return first + __popc(peers & ((1u << lane) - 1u));
}

// Select with one thread per live ray, the rays packed from CUDA block 0 on.
template <int K, bool FRESH>
__device__ void select_threads(const Queues& p, int n_live, const int* live_in, int* live_out,
                               int* n_live_out, float4* sb, unsigned long long& slabs) {
  const int lane = threadIdx.x & 31;
  const bool resident = p.nb <= SEL_BLOCKS;
  if (resident) stage_bounds(p, sb, 0, p.nb);
  const float* b = reinterpret_cast<const float*>(sb);
  for (int base = blockIdx.x * THREADS; base < n_live; base += gridDim.x * THREADS) {
    const int q = base + threadIdx.x;
    const bool has = q < n_live;
    const int i = has ? __ldcg(live_in + q) : 0;
    const ch::Ray r = load_ray<FRESH>(p, i);
    const float best_t = has ? key_t(__ldcg(p.best + i)) : -1.0f;
    if (has) p.sel_t[i] = best_t;
    const unsigned long long cur = has ? __ldcg(p.cursor + i) : NONE;
    unsigned long long sel[K];
#pragma unroll
    for (int s = 0; s < K; ++s) sel[s] = NONE;
    int qual = 0;  // blocks above the cursor with entry <= best t
    for (int c0 = 0; c0 < p.nb; c0 += SEL_BLOCKS) {
      const int c1 = min(p.nb, c0 + SEL_BLOCKS);
      if (!resident) stage_bounds(p, sb, c0, c1);
      if (has) slab_keys<K>(r, b, c0, c1, c0, 1, best_t, cur, sel, qual);
    }
    if (has) slabs += p.nb;

    // queue the picks: per pick, lanes that chose the same block share one atomicAdd
    const int nsel = min(qual, K);
    unsigned long long last = NONE;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const unsigned blk = s < nsel ? static_cast<unsigned>(sel[s] & 0xffffffffu) : NO_BLOCK;
      const int slot = warp_slot(p, blk, lane);
      if (has && s <= nsel)  // the picks, then a terminator when fewer than K
        p.pairs[static_cast<long long>(q) * K + s] =
            make_int2(blk == NO_BLOCK ? -1 : static_cast<int>(blk), slot);
      if (s == nsel - 1) last = sel[s];
    }
    if (has && nsel > 0) p.cursor[i] = last;

    // a ray with more qualifying blocks than it picked stays live
    const bool more = has && qual > K;
    const unsigned m = __ballot_sync(0xffffffffu, more);
    int out = 0;
    if (lane == 0 && m) out = atomicAdd(n_live_out, __popc(m));
    out = __shfl_sync(0xffffffffu, out, 0);
    if (more) live_out[out + __popc(m & ((1u << lane) - 1u))] = i;
  }
}

// Select with a group of g lanes per live ray (g a power of two, 2 to G_MAX,
// n_live x g <= the grid's threads: select_lanes).  The live list is cut into
// one run of consecutive rays per CUDA block, so the groups spread over every
// CUDA block and a block's rays are neighbours in the list.  The bounds are
// staged in chunks of SEL_BLOCKS (one chunk up to that many blocks); each lane
// tests the boxes j = l mod g of every chunk and keeps its K least across
// them.  Up to AGG_BLOCKS blocks the CUDA block first counts its picks per
// triangle block in shared memory, beside the resident bounds, then takes
// each block's slots with one atomicAdd; above, each warp takes its slots from
// the global counts, its lanes that queue one block sharing one atomicAdd.
template <int K, bool FRESH>
__device__ void select_groups(const Queues& p, int g, int n_live, const int* live_in,
                              int* live_out, int* n_live_out, float4* sb,
                              unsigned long long& slabs) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, l = threadIdx.x & (g - 1);
  const unsigned group = g == 32 ? FULL : ((1u << g) - 1u) << (lane & ~(g - 1));
  const int run = (n_live + gridDim.x - 1) / gridDim.x;  // <= THREADS / g
  const int t = threadIdx.x / g;
  const int q = blockIdx.x * run + t;
  const bool has = t < run && q < n_live;
  const bool shared_counts = p.nb <= AGG_BLOCKS;  // the bounds then are one chunk
  int* s_cnt = reinterpret_cast<int*>(sb + 2 * p.nb);  // [nb] picks, then [nb] first slots
  if (shared_counts)
    for (int j = threadIdx.x; j < p.nb; j += THREADS) s_cnt[j] = 0;
  const int i = has ? __ldcg(live_in + q) : 0;
  const ch::Ray r = load_ray<FRESH>(p, i);
  const float best_t = has ? key_t(__ldcg(p.best + i)) : -1.0f;
  if (has && l == 0) p.sel_t[i] = best_t;
  const unsigned long long cur = has ? __ldcg(p.cursor + i) : NONE;
  unsigned long long sel[K];  // this lane's K least, sorted
#pragma unroll
  for (int s = 0; s < K; ++s) sel[s] = NONE;
  int qual = 0;
  const float* b = reinterpret_cast<const float*>(sb);
  for (int c0 = 0; c0 < p.nb; c0 += SEL_BLOCKS) {
    const int c1 = min(p.nb, c0 + SEL_BLOCKS);
    stage_bounds(p, sb, c0, c1);  // its barriers order the zeroing too
    if (has) slab_keys<K>(r, b, c0, c1, c0 + l, g, best_t, cur, sel, qual);
  }
  if (has && l == 0) slabs += p.nb;
  qual = static_cast<int>(__reduce_add_sync(group, static_cast<unsigned>(qual)));
  const int nsel = min(qual, K);

  // the group's K least: per pick, the least of the lanes' heads (a 64-bit
  // minimum as two 32-bit ones), popped by the lane that holds it; every lane
  // learns every pick
  const int steps = static_cast<int>(__reduce_max_sync(FULL, static_cast<unsigned>(nsel)));
  unsigned blk[K] = {};
  unsigned long long last = NONE;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s >= steps) break;  // no group of the warp has more picks
    const unsigned hi = static_cast<unsigned>(sel[0] >> 32);
    const unsigned mh = __reduce_min_sync(group, hi);
    const unsigned ml = __reduce_min_sync(group, hi == mh ? static_cast<unsigned>(sel[0]) : ~0u);
    const unsigned long long m = (static_cast<unsigned long long>(mh) << 32) | ml;
    if (sel[0] == m) {  // keys are distinct (each holds its block)
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) sel[k] = sel[k + 1];
      sel[K - 1] = NONE;
    }
    blk[s] = ml;
    if (s == nsel - 1) last = m;
  }

  // lane s mod g queues pick s
  int2* row = p.pairs + static_cast<long long>(q) * K;
  if (shared_counts) {  // every pick's shared atomicAdd in flight at once
    int slot[K];
#pragma unroll
    for (int s = 0; s < K; ++s)
      if (s < nsel && (s & (g - 1)) == l) slot[s] = atomicAdd(s_cnt + blk[s], 1);
    __syncthreads();  // the CUDA block's first slot in each block's queue
    for (int j = threadIdx.x; j < p.nb; j += THREADS) {
      const int c = s_cnt[j];
      if (c > 0) s_cnt[p.nb + j] = atomicAdd(p.cnt + j, c);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < K; ++s)
      if (s < nsel && (s & (g - 1)) == l)
        row[s] = make_int2(static_cast<int>(blk[s]), slot[s] + s_cnt[p.nb + blk[s]]);
  } else {  // pass k: each lane its pick l + k g, a warp's picks of one block one atomicAdd
    for (int k = 0; k * g < steps; ++k) {
      const int s = l + k * g;
      unsigned bk = NO_BLOCK;
#pragma unroll
      for (int u = 0; u < K; ++u)
        if (u == s && u < nsel) bk = blk[u];
      const int slot = warp_slot(p, bk, lane);
      if (bk != NO_BLOCK) row[s] = make_int2(static_cast<int>(bk), slot);
    }
  }
  if (has && nsel < K && (nsel & (g - 1)) == l) row[nsel] = make_int2(-1, 0);  // terminator
  if (has && nsel > 0 && l == 0) p.cursor[i] = last;

  // a ray with more qualifying blocks than it picked stays live
  const bool more = has && l == 0 && qual > K;
  const unsigned mk = __ballot_sync(FULL, more);
  int out = 0;
  if (lane == 0 && mk) out = atomicAdd(n_live_out, __popc(mk));
  out = __shfl_sync(FULL, out, 0);
  if (more) live_out[out + __popc(mk & ((1u << lane) - 1u))] = i;
}

// Scan (one CUDA block): queue offsets and work items from the per-block
// counts, which it zeroes for the next round, and the round's slices.
__device__ void scan_round(const Queues& p, unsigned long long* s_scan) {
  const int tid = threadIdx.x;
  const int per = (p.nb + THREADS - 1) / THREADS;
  const int lo = min(p.nb, tid * per), hi = min(p.nb, lo + per);
  // (queued pairs << 32) | work items: both sums stay below 2^31
  auto packed = [](unsigned c) {
    return (static_cast<unsigned long long>(c) << 32) | ((c + CHUNK - 1) / CHUNK);
  };
  unsigned long long sum = 0;
  for (int j = lo; j < hi; ++j) sum += packed(static_cast<unsigned>(__ldcg(p.cnt + j)));
  s_scan[tid] = sum;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {  // inclusive scan over the threads
    const unsigned long long v = tid >= off ? s_scan[tid - off] : 0ull;
    __syncthreads();
    s_scan[tid] += v;
    __syncthreads();
  }
  unsigned long long run = s_scan[tid] - sum;
  for (int j = lo; j < hi; ++j) {
    const unsigned c = static_cast<unsigned>(__ldcg(p.cnt + j));
    p.qoff[j] = static_cast<int>(run >> 32);
    p.item_off[j] = static_cast<int>(run & 0xffffffffu);
    p.qcnt[j] = static_cast<int>(c);
    p.cnt[j] = 0;
    run += packed(c);
  }
  if (tid == THREADS - 1) {
    const int items = static_cast<int>(s_scan[tid] & 0xffffffffu);
    const int s = slices(items, gridDim.x);
    p.item_off[p.nb] = items;
    p.ctrl->items = items * s;
    p.ctrl->lg = __ffs(s) - 1;
    p.ctrl->work = 0;
    if (p.split != nullptr) {
      if (s > 1) atomicAdd(&p.split[0], 1ull);
      atomicAdd(&p.split[1], static_cast<unsigned long long>(items * s));
    }
  }
}

// Fill: each live ray writes itself into the queues of its picks.
template <int K>
__device__ void fill_round(const Queues& p, int n_live, const int* live_in) {
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < n_live; q += gridDim.x * THREADS) {
    const int i = __ldcg(live_in + q);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int2 pb = __ldcg(p.pairs + static_cast<long long>(q) * K + s);
      if (pb.x < 0) break;
      p.queue[__ldcg(p.qoff + pb.x) + pb.y] = i;
    }
  }
}

// The next work item: (slice, block, first queue slot, rays) of item
// (block, chunk) x S + slice; slice -1 when none is left.  Every lane of
// one warp calls it: the search for the last block whose first item is <=
// the chunk reads 32 of the blocks' first items at a time, so it takes one
// dependent read for up to 32 blocks and two for up to 1,024.
__device__ int4 next_item(const Queues& p, int items, int lg) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int item = 0;
  if (lane == 0) item = atomicAdd(&p.ctrl->work, 1);
  item = __shfl_sync(FULL, item, 0);
  if (item >= items) return make_int4(-1, 0, 0, 0);
  const int chunk = item >> lg;
  int lo = 0, hi = p.nb;  // item_off[lo] <= chunk < item_off[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5, j = lo + lane * step;
    const unsigned le = __ballot_sync(FULL, j < hi && __ldcg(p.item_off + j) <= chunk);
    lo += (31 - __clz(le)) * step;  // item_off rises with j: le is lanes 0 to k
    hi = min(hi, lo + step);
  }
  const int s = (chunk - __ldcg(p.item_off + lo)) * CHUNK;
  return make_int4(item & ((1 << lg) - 1), lo, __ldcg(p.qoff + lo) + s,
                   min(CHUNK, __ldcg(p.qcnt + lo) - s));
}

// Triangles [lo, lo + cnt) of block blk into f4 in ch's packed layout, from
// its first slot, and the block's sub-tile boxes after them.
__device__ __forceinline__ void stage_slice(const Queues& p, int blk, int lo, int cnt, float4* f4) {
  const float4* src = p.packed + (static_cast<long long>(blk) * p.tile + lo) * PACK4;
  for (int k = threadIdx.x; k < 6 * cnt; k += THREADS) {
    const int c = k / 6;
    cp_async16(f4 + k, src + c * PACK4 + (k - 6 * c));
  }
  float* fz = reinterpret_cast<float*>(f4 + 6 * ch::TRI_TILE);
  for (int c = threadIdx.x; c < cnt; c += THREADS) cp_async4(fz + c, src + c * PACK4 + 6);
  const float4* boxes = reinterpret_cast<const float4*>(p.sub_bounds) + 2 * SUBS * blk;
  for (int k = threadIdx.x; k < 2 * SUBS; k += THREADS)
    cp_async16(f4 + ch::PACKED_BUF4 + k, boxes + k);
}

// Test: work items from the device-side counter, the next item's triangles
// staged while this one's are tested.  Slice k of S tests the block's
// triangles [k w, (k + 1) w), w = tile / S rounded up; slice 0 counts the
// staging, so stagings stay one per (block, chunk).  Each thread culls its
// RPT rays against the slice's sub-tiles and lists the kept entries by
// sub-tile (a ballot and one shared atomicAdd a warp and sub-tile); the
// threads then take the listed entries two rays of one sub-tile at a time.
// An entry counts where its sub-tile starts, so once per (ray, block) pair
// whatever S; its pairs count in every slice that tests them.
template <bool FRESH>
__device__ void test_round(const Queues& p, float4* smem, int4* s_work,
                           unsigned long long& stagings) {
  constexpr unsigned FULL = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  const int items = __ldcg(&p.ctrl->items), lg = __ldcg(&p.ctrl->lg);
  const int width = (p.tile + (1 << lg) - 1) >> lg;
  unsigned char* s_list = reinterpret_cast<unsigned char*>(smem) + LISTS;  // [SUBS][CHUNK]
  int* s_ray = reinterpret_cast<int*>(s_list + SUBS * CHUNK);  // [CHUNK] the item's rays
  int* s_cnt = s_ray + CHUNK;                                   // [SUBS] entries listed
  // the triangles of slice k: [k w, k w + count)
  auto count = [&](int k) { return max(0, min(width, p.tile - k * width)); };
  if (tid < 32) {
    const int4 it = next_item(p, items, lg);
    if (tid == 0) *s_work = it;
  }
  __syncthreads();
  int4 cur = *s_work;
  if (cur.x >= 0) stage_slice(p, cur.y, cur.x * width, count(cur.x), smem);
  cp_async_commit();
  int buf = 0;
  while (cur.x >= 0) {
    __syncthreads();  // every thread has read *s_work and is done with the other buffer and the lists
    if (tid < 32) {
      const int4 it = next_item(p, items, lg);
      if (tid == 0) *s_work = it;
    }
    if (tid < SUBS) s_cnt[tid] = 0;
    __syncthreads();
    const int4 nxt = *s_work;
    if (nxt.x >= 0) stage_slice(p, nxt.y, nxt.x * width, count(nxt.x), smem + (buf ^ 1) * BUF4);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // item cur's triangles and boxes are in buffer buf
    if (tid == 0 && cur.x == 0) ++stagings;
    const float4* f4 = smem + buf * BUF4;
    const float* boxes = reinterpret_cast<const float*>(f4 + ch::PACKED_BUF4);
    const int lo = cur.x * width, hi = lo + count(cur.x);
    const int s0 = lo / SUB, s1 = hi > lo ? (hi + SUB - 1) / SUB : s0;  // the sub-tiles it meets

    // the cull: slot tid + k THREADS keeps the sub-tiles it enters no farther
    // than its select's best t
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int slot = tid + k * THREADS;
      const bool act = slot < cur.w;
      const int ray = act ? __ldcg(p.queue + cur.z + slot) : 0;
      if (act) s_ray[slot] = ray;
      const ch::Ray r = load_ray<FRESH>(p, ray);
      const float sel = act ? __ldcg(p.sel_t + ray) : -1.0f;
      for (int s = s0; s < s1; ++s) {
        const bool keep = act && ch::block_entry(r, boxes, s) <= sel;
        const unsigned m = __ballot_sync(FULL, keep);
        if (m == 0) continue;
        int at = 0;
        if (lane == 0) at = atomicAdd(s_cnt + s, __popc(m));
        at = __shfl_sync(FULL, at, 0);
        if (keep)
          s_list[s * CHUNK + at + __popc(m & ((1u << lane) - 1u))] =
              static_cast<unsigned char>(slot);
      }
    }
    __syncthreads();  // the lists are whole
    if (tid == 0) {
      for (int s = s0; s < s1; ++s) {
        const unsigned long long c = static_cast<unsigned>(s_cnt[s]);
        test_counts.pairs += c * static_cast<unsigned>(min(hi, SUB * (s + 1)) - max(lo, SUB * s));
        if (SUB * s >= lo) {
          test_counts.tested += c;
          if (boxes[8 * s] <= boxes[8 * s + 3]) test_counts.offered += static_cast<unsigned>(cur.w);
        }
      }
    }

    // the tests: unit u is two listed rays of one sub-tile, sub-tile s's
    // units following those of the sub-tiles before it
    int s = s0, first = 0, c = s0 < s1 ? s_cnt[s0] : 0;
    for (int u = tid;; u += THREADS) {
      while (s < s1 && u - first >= (c + 1) >> 1) {
        first += (c + 1) >> 1;
        ++s;
        c = s < s1 ? s_cnt[s] : 0;
      }
      if (s >= s1) break;
      const int j = 2 * (u - first);
      int ray[RPT];
      bool act[RPT];
      ch::Ray r[RPT];
      float best_t[RPT];
      int best_i[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        act[k] = j + k < c;
        ray[k] = s_ray[s_list[s * CHUNK + (act[k] ? j + k : j)]];
        r[k] = load_ray<FRESH>(p, ray[k]);
        best_t[k] = ch::MAX_DIST;
        best_i[k] = 0;
      }
      ch::test_range(f4, cur.y * p.tile + lo, max(lo, SUB * s) - lo, min(hi, SUB * s + SUB) - lo,
                     r, act, best_t, best_i);
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (act[k] && best_t[k] < ch::MAX_DIST) atomicMin(p.best + ray[k], hit_key(best_t[k], best_i[k]));
    }
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Every ray of slots [0, n) live, with no hit and no cursor; the per-block
// counts zeroed.
__device__ __forceinline__ void init_trace(const Queues& p, int n) {
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int stride = gridDim.x * THREADS;
  for (int i = gtid; i < n; i += stride) {
    p.best[i] = hit_key(ch::MAX_DIST, 0);
    p.cursor[i] = NONE;
    p.live[i] = i;
  }
  for (int j = gtid; j < p.nb; j += stride) p.cnt[j] = 0;
  if (gtid == 0) {
    p.ctrl->live[0] = n;
    p.ctrl->live[1] = 0;
  }
}

// The rounds, from ctrl->live[0] rays listed in live list 0 (their best and
// cursor set, the per-block counts zero, ctrl->live[1] zero) until no ray is
// live; every thread of the grid calls it after a grid sync.  TIMED times
// its grid syncs (sync_cycles) and its selects (select_cycles).  On return both
// live counts and the per-block counts are zero again, and every block has
// passed the last round's sync: the hits in best are final.
template <int K, bool FRESH, bool TIMED = false>
__device__ void trace_rounds(const Queues& p, cg::grid_group& grid, float4* smem, int4* s_work,
                             unsigned long long* s_scan, Tally& tally) {
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  for (int round = 0;; ++round) {
    const int cur = round & 1;
    const int n_live = __ldcg(&p.ctrl->live[cur]);
    if (n_live == 0) break;  // the same value in every thread: no sync is left waiting
    ++tally.rounds;
    const int* live_in = p.live + cur * p.n;
    if (TIMED && threadIdx.x == 0) select_cycles -= static_cast<unsigned>(clock());
    int* live_out = p.live + (cur ^ 1) * p.n;  // select: each live ray's next K blocks
    const int g = select_lanes(n_live, p.nb, gridDim.x * THREADS);
    if (g == 1) {
      select_threads<K, FRESH>(p, n_live, live_in, live_out, &p.ctrl->live[cur ^ 1], smem,
                               tally.slabs);
    } else {
      if (gtid == 0 && p.split != nullptr) atomicAdd(&p.split[2], 1ull);
      select_groups<K, FRESH>(p, g, n_live, live_in, live_out, &p.ctrl->live[cur ^ 1], smem,
                              tally.slabs);
    }
    sync<TIMED>(grid, tally);
    if (TIMED && threadIdx.x == 0) select_cycles += static_cast<unsigned>(clock());
    if (blockIdx.x == 0) scan_round(p, s_scan);
    sync<TIMED>(grid, tally);
    fill_round<K>(p, n_live, live_in);
    sync<TIMED>(grid, tally);
    test_round<FRESH>(p, smem, s_work, tally.stagings);
    if (gtid == 0) p.ctrl->live[cur] = 0;  // list cur takes the round after next's survivors
    sync<TIMED>(grid, tally);
  }
}

// (t, tri, hit) of slots [0, n) with the miss rule of ops/closest_hit.trace_plain.
__device__ __forceinline__ void write_hits(const Queues& p, int n, float* out_t, long long* out_tri,
                                           unsigned char* out_hit) {
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  for (int i = gtid; i < n; i += gridDim.x * THREADS) {
    const unsigned long long key = __ldcg(p.best + i);
    const float t = key_t(key);
    const bool hit = t < ch::MISS_T;
    out_t[i] = hit ? t : ch::MAX_DIST;
    out_tri[i] = hit ? static_cast<long long>(key & 0xffffffffu) : 0;
    out_hit[i] = hit;
  }
}

// Each thread's tally added to stats [pairs tested, stagings, rounds, slab
// tests] (rounds from one thread only, pairs from this CUDA block's
// test_counts), and where `sub` is given, the sub-tile entries offered and
// tested into sub[0] and sub[1].
__device__ __forceinline__ void add_tally(unsigned long long* stats, Tally t,
                                          unsigned long long* sub = nullptr) {
  const unsigned long long stagings = warp_sum(t.stagings), slabs = warp_sum(t.slabs);
  if ((threadIdx.x & 31) == 0) {
    if (stagings) atomicAdd(&stats[1], stagings);
    if (slabs) atomicAdd(&stats[3], slabs);
  }
  if (threadIdx.x == 0) {
    if (test_counts.pairs) atomicAdd(&stats[0], test_counts.pairs);
    if (sub != nullptr && test_counts.offered) atomicAdd(&sub[0], test_counts.offered);
    if (sub != nullptr && test_counts.tested) atomicAdd(&sub[1], test_counts.tested);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&stats[2], static_cast<unsigned long long>(t.rounds));
}

// The occupancy API's CUDA blocks per SM and the SMs for a cooperative launch
// of `kern` with THREADS threads and SMEM_BYTES of dynamic shared memory.
template <class Kernel>
cudaError_t grid_size(Kernel kern, int* blocks_per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, THREADS, SMEM_BYTES);
  if (err == cudaSuccess && *blocks_per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  return err;
}

// Scratch layout of the queues for n ray slots, nb blocks and K picks, from
// byte `at` on; each array 16-byte aligned.  Returns the end.
struct QueueLayout {
  size_t best, cursor, sel_t, pairs, live, queue, cnt, qoff, qcnt, item_off, ctrl;
};

inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) & ~static_cast<size_t>(15);
  return here;
}

inline QueueLayout queue_layout(long long n, long long nb, long long k, size_t& at) {
  QueueLayout l{};
  l.best = take(at, 8 * n);
  l.cursor = take(at, 8 * n);
  l.sel_t = take(at, 4 * n);
  l.pairs = take(at, 8 * n * k);
  l.live = take(at, 4 * 2 * n);
  l.queue = take(at, 4 * n * k);
  l.cnt = take(at, 4 * nb);
  l.qoff = take(at, 4 * nb);
  l.qcnt = take(at, 4 * nb);
  l.item_off = take(at, 4 * (nb + 1));
  l.ctrl = take(at, sizeof(Ctrl));
  return l;
}

// The queues of n slots in scratch laid out by l (rays, features, bounds and
// sub-tile boxes set by the caller).
inline Queues queues_at(char* s, const QueueLayout& l, int n, int nb, int tile) {
  Queues q{};
  q.n = n;
  q.nb = nb;
  q.tile = tile;
  q.best = reinterpret_cast<unsigned long long*>(s + l.best);
  q.cursor = reinterpret_cast<unsigned long long*>(s + l.cursor);
  q.sel_t = reinterpret_cast<float*>(s + l.sel_t);
  q.pairs = reinterpret_cast<int2*>(s + l.pairs);
  q.live = reinterpret_cast<int*>(s + l.live);
  q.queue = reinterpret_cast<int*>(s + l.queue);
  q.cnt = reinterpret_cast<int*>(s + l.cnt);
  q.qoff = reinterpret_cast<int*>(s + l.qoff);
  q.qcnt = reinterpret_cast<int*>(s + l.qcnt);
  q.item_off = reinterpret_cast<int*>(s + l.item_off);
  q.ctrl = reinterpret_cast<Ctrl*>(s + l.ctrl);
  return q;
}

}  // namespace bq
