"""2b's block-queue rounds (``csrc/fused_queue.cu`` over ``csrc/pairs.cuh``)
piece by piece, and select split into its steps, from copies of ``csrc/``
with clock stamps patched in.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.pieces_fused_queue \\
        [LABEL=DIR[:g1] ...] [--res R] [--scene outdoor|closedbox|outdoor600k]

This checkout's ``csrc/`` comes first, as ``this``; each ``DIR`` is another
copy of ``csrc/`` (see ``ab_fused_queue``).  A source with one select per
round (``select_round``) or with one thread and grouped selects
(``select_threads``, ``select_groups``) is patched, a grouped select whose
bounds stay resident or one that stages them in chunks; ``:g1`` makes a
grouped source take with ``select_groups`` at G = 1 the rounds that
``select_lanes`` leaves to one thread a ray where the round's rays fit in the
grid's threads (in a source whose groups keep every bound resident, only
where the scene has at most ``AGG_BLOCKS`` blocks; the one-thread select then
runs only above).  One sample at ``R``^2 (default 256), 4 bounces, three
times: of outdoor_1300 with sun (``outdoor15k.render``'s shape), of the
benchmark's closed box with NEE and no sun (``closedbox15k.nee``'s), or of
the benchmark's ``outdoor600k`` scene with sun (``outdoor600k.render``'s:
2,344 blocks, the bounds staged in two chunks).

Per round and CUDA block, thread 0's cycles of each piece: select, scan,
fill, test and the grid syncs between them.  Per warp (lane 0) the cycles of
select's steps, the CUDA block's slowest warp kept: ``stage`` (the bounds
into shared memory; in a one-thread select that stages chunks, inside
``slab``), ``slab`` (the slab tests with the K-insert), ``picks``
(the picks, their merge, their atomics and the queue rows) and ``append``
(the live-list append).  Printed: per repetition the sums over rounds of
the slowest CUDA block, in us on the clock that block 0's cycles give over
the rounds' wall time, and the select's by the rounds' G; per round of the
last repetition, the same; then the
instrumented ms a sample (CUDA events).  In a source whose test phase culls
by sub-tile, per warp (lane 0) also the cycles of the test phase's steps
over its work items, the CUDA block's slowest warp kept: ``wait`` (at the
item's first barrier, for the slowest warp's tests of the item before),
``next`` (thread 0 fetching the next item), ``stage`` (its staging issued,
this item's awaited), ``cull`` (the slab tests and the lists) and ``units``
(this warp's tests); and thread 0's cycles in ``next_item``, the mean over
CUDA blocks: ``atomic`` (the work counter) and ``search`` (the item's block
and its reads).  The copies, and every number as
JSON, are written under ``build/pieces/``.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

R, G, W = 128, 1024, 24  # rounds, CUDA blocks and words a (round, block) kept
REPS = 3
STEPS = ["slab", "picks", "append", "stage"]
# the test phase's steps a work item, where the source culls by sub-tile
TEST_STEPS = ["wait", "next", "stage", "cull", "units"]
ROOT = Path(__file__).resolve().parents[2]

DECL = f'''
constexpr int DBG_R = {R}, DBG_G = {G}, DBG_W = {W};
__device__ unsigned g_piece[DBG_R * DBG_G * DBG_W];
__device__ unsigned long long g_wall[DBG_R * 2];
__shared__ unsigned dbg_t[9];
__shared__ unsigned dbg_sel[4];
__shared__ unsigned dbg_tst[5];
__shared__ unsigned dbg_nx[2];
__shared__ int dbg_round;
__shared__ unsigned long long dbg_w0;
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }}
__device__ __forceinline__ unsigned dclk() {{ return static_cast<unsigned>(clock()); }}
#define DBG_MARK(k) if (threadIdx.x == 0) dbg_t[k] = dclk()
'''

# the round's pieces, from the select call (SELECT_CALL) to the round's last sync
ROUND = '''    ++tally.rounds;
    if (threadIdx.x == 0 && blockIdx.x == 0) dbg_w0 = gtime();
    DBG_MARK(0);
    const int* live_in = p.live + cur * p.n;
SELECT_CALL
    DBG_MARK(1);
    sync<TIMED>(grid, tally);
    DBG_MARK(2);
    if (blockIdx.x == 0) scan_round(p, s_scan);
    DBG_MARK(3);
    sync<TIMED>(grid, tally);
    DBG_MARK(4);
    fill_round<K>(p, n_live, live_in);
    DBG_MARK(5);
    sync<TIMED>(grid, tally);
    DBG_MARK(6);
TEST_CALL
    DBG_MARK(7);
    const int dbg_work = __ldcg(&p.ctrl->items);
    if (gtid == 0) p.ctrl->live[cur] = 0;  // list cur takes the round after next's survivors
    sync<TIMED>(grid, tally);
    DBG_MARK(8);
    if (threadIdx.x == 0) {
      const int rr = dbg_round++;
      if (rr < DBG_R && blockIdx.x < DBG_G) {
        unsigned* o = g_piece + (static_cast<size_t>(rr) * DBG_G + blockIdx.x) * DBG_W;
        for (int k = 0; k < 8; ++k) o[k] = dbg_t[k + 1] - dbg_t[k];
        o[9] = static_cast<unsigned>(n_live);
        o[10] = static_cast<unsigned>(dbg_work);
        o[15] = static_cast<unsigned>(DBG_G_OF);
        for (int k = 0; k < 4; ++k) o[11 + k] = dbg_sel[k];
        for (int k = 0; k < 5; ++k) o[16 + k] = dbg_tst[k];
        for (int k = 0; k < 2; ++k) o[21 + k] = dbg_nx[k];
        if (blockIdx.x == 0) { g_wall[2 * rr] = dbg_w0; g_wall[2 * rr + 1] = gtime(); }
      }
      for (int k = 0; k < 4; ++k) dbg_sel[k] = 0;
      for (int k = 0; k < 5; ++k) dbg_tst[k] = 0;
      for (int k = 0; k < 2; ++k) dbg_nx[k] = 0;
    }'''

READ = '''
extern "C" int read_pieces(unsigned* piece, unsigned long long* wall) {
  cudaError_t e = cudaMemcpyFromSymbol(piece, bq::g_piece, sizeof(bq::g_piece));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(wall, bq::g_wall, sizeof(bq::g_wall));
  return static_cast<int>(e);
}
extern "C" int clear_pieces() {
  static unsigned zp[bq::DBG_R * bq::DBG_G * bq::DBG_W];
  static unsigned long long zw[bq::DBG_R * 2];
  cudaError_t e = cudaMemcpyToSymbol(bq::g_piece, zp, sizeof(zp));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bq::g_wall, zw, sizeof(zw));
  return static_cast<int>(e);
}
'''

ACC = "  unsigned dbg_acc[4] = {0u, 0u, 0u, 0u};\n  dbg_acc[3] = dclk() - dbg_s0;\n"
FLUSH = ("  if ((threadIdx.x & 31) == 0)\n"
         "    for (int k = 0; k < 4; ++k) atomicMax(&dbg_sel[k], dbg_acc[k]);\n")
ENDS = ("    const unsigned dbg_d = dclk();\n"
        "    dbg_acc[0] += dbg_b - dbg_a; dbg_acc[1] += dbg_c - dbg_b;"
        " dbg_acc[2] += dbg_d - dbg_c;\n")
# (anchor, text, where) inside one select function: "before"/"after" the
# anchor, or any other string: the anchor's replacement
STAGE = [("  const bool resident = p.nb <= SEL_BLOCKS;\n", "  const unsigned dbg_s0 = dclk();\n",
          "before"),
         ("  if (resident) stage_bounds(p, sb, 0, p.nb);\n", ACC, "after")]
THREAD_MARKS = STAGE + [
    ("    const unsigned long long cur = has ? __ldcg(p.cursor + i) : NONE;\n",
     "    const unsigned dbg_a = dclk();\n", "after"),
    ("    // queue the picks: per pick", "    const unsigned dbg_b = dclk();\n", "before"),
    ("    // a ray with more qualifying blocks than it picked stays live",
     "    const unsigned dbg_c = dclk();\n", "before"),
    ("    if (more) live_out[out + __popc(m & ((1u << lane) - 1u))] = i;\n  }\n", "",
     "    if (more) live_out[out + __popc(m & ((1u << lane) - 1u))] = i;\n" + ENDS + "  }\n"
     + FLUSH),
]
GROUP_ENDS = [
    ("  const unsigned long long cur = has ? __ldcg(p.cursor + i) : NONE;\n",
     "  const unsigned dbg_a = dclk();\n", "after"),
    ("  // the group's K least", "  const unsigned dbg_b = dclk();\n", "before"),
    ("  // a ray with more qualifying blocks than it picked stays live",
     "  const unsigned dbg_c = dclk();\n", "before"),
    ("  if (more) live_out[out + __popc(mk & ((1u << lane) - 1u))] = i;\n",
     ENDS.replace("    ", "  ") + FLUSH, "after"),
]
# a grouped select whose bounds stay resident: staged once before the rays load
GROUP_MARKS = [
    ("  int* s_cnt = ", "  const unsigned dbg_s0 = dclk();\n", "before"),
    ("  stage_bounds(p, sb, 0, p.nb);  // its barriers order the zeroing too\n", ACC, "after"),
] + GROUP_ENDS
# one that stages them in chunks between the slab tests: each staging's
# cycles move from slab to stage (the counts' zeroing and the rays' loads
# count as stage too)
CHUNK_STAGE = "    stage_bounds(p, sb, c0, c1);  // its barriers order the zeroing too\n"
CHUNK_GROUP_MARKS = [
    ("  int* s_cnt = ", "  const unsigned dbg_s0 = dclk();\n", "before"),
    ("  const unsigned long long cur = has ? __ldcg(p.cursor + i) : NONE;\n",
     "  unsigned dbg_acc[4] = {0u, 0u, 0u, 0u};\n  dbg_acc[3] = dclk() - dbg_s0;\n", "after"),
    (CHUNK_STAGE, "", "    const unsigned dbg_t0 = dclk();\n" + CHUNK_STAGE +
     "    const unsigned dbg_st = dclk() - dbg_t0;\n"
     "    dbg_acc[3] += dbg_st;\n    dbg_acc[0] -= dbg_st;\n"),
] + GROUP_ENDS
# per warp (lane 0), a work item's cycles: waiting at the loop's first barrier
# for the last warp's tests, fetching the next item, staging it and waiting
# for this one's staging, culling and listing, testing the units
TEST_MARKS = [
    ("  const int tid = threadIdx.x, lane = tid & 31;\n",
     "  unsigned dbg_acc[5] = {0u, 0u, 0u, 0u, 0u};\n", "after"),
    ("    const int4 nxt = *s_work;\n", "    const unsigned dbg_n = dclk();\n", "before"),
    ("    __syncthreads();  // every thread has read *s_work and is done with the other buffer and "
     "the lists\n", "", "    const unsigned dbg_a = dclk();\n"
     "    __syncthreads();  // every thread has read *s_work and is done with the other buffer and "
     "the lists\n    const unsigned dbg_b = dclk();\n"),
    ("    __syncthreads();  // item cur's triangles and boxes are in buffer buf\n",
     "    const unsigned dbg_c = dclk();\n", "after"),
    ("    __syncthreads();  // the lists are whole\n", "    const unsigned dbg_d = dclk();\n",
     "after"),
    ("    cur = nxt;\n    buf ^= 1;\n",
     "    dbg_acc[0] += dbg_b - dbg_a; dbg_acc[1] += dbg_n - dbg_b; dbg_acc[2] += dbg_c - dbg_n;\n"
     "    dbg_acc[3] += dbg_d - dbg_c; dbg_acc[4] += dclk() - dbg_d;\n", "before"),
    ("  cp_async_wait<0>();\n", "  if ((threadIdx.x & 31) == 0)\n"
     "    for (int k = 0; k < 5; ++k) atomicMax(&dbg_tst[k], dbg_acc[k]);\n", "after"),
]
# thread 0's cycles in next_item: the work counter's atomicAdd, then the
# search for the item's block and its reads
NEXT_MARKS = [
    ("  if (lane == 0) item = atomicAdd(&p.ctrl->work, 1);\n", "", "  const unsigned dbg_x0 = dclk();\n"
     "  if (lane == 0) item = atomicAdd(&p.ctrl->work, 1);\n"),
    ("  item = __shfl_sync(FULL, item, 0);\n", "  const unsigned dbg_x1 = dclk();\n", "after"),
    ("  const int s = (chunk - __ldcg(p.item_off + lo)) * CHUNK;\n", "", "  const int s = (chunk - "
     "__ldcg(p.item_off + lo)) * CHUNK;\n  const int dbg_q = __ldcg(p.qoff + lo), dbg_c = "
     "__ldcg(p.qcnt + lo);\n  asm volatile(\"\" ::\"r\"(dbg_q), \"r\"(dbg_c));  // the reads are in\n"
     "  if (threadIdx.x == 0) {\n    dbg_nx[0] += dbg_x1 - dbg_x0;\n"
     "    dbg_nx[1] += dclk() - dbg_x1;\n  }\n"),
]
# where the one-thread select leaves a round to select_groups at G = 1: in a
# source whose groups keep every bound resident, also above AGG_BLOCKS
G1 = ("    if (g == 1) {\n", "    if (g == 1 && n_live > gridDim.x * THREADS) {\n")
G1_RESIDENT = ("    if (g == 1) {\n",
               "    if (g == 1 && (p.nb > AGG_BLOCKS || n_live > gridDim.x * THREADS)) {\n")


def _in_fn(h: str, name: str, marks) -> str:
    start = re.search(rf"__device__ \w+ {name}\(", h).start()
    end = h.index("\n}\n", start) + 3
    body = h[start:end]
    for anchor, text, where in marks:
        if body.count(anchor) != 1:
            raise ValueError(f"{name}: anchor not found once: {anchor!r}")
        if where == "after":
            body = body.replace(anchor, anchor + text)
        elif where == "before":
            body = body.replace(anchor, text + anchor)
        else:
            body = body.replace(anchor, where)
    return h[:start] + body + h[end:]


def patch(h: str, g1: bool) -> str:
    """``pairs.cuh`` with the clock stamps (and the ``g1`` dispatch)."""
    h = h.replace("__shared__ unsigned sync_cycles;", "__shared__ unsigned sync_cycles;\n" + DECL)
    start = h.index("    ++tally.rounds;\n")
    call0 = h.index("    const int* live_in = p.live + cur * p.n;\n", start)
    call1 = h.index("    sync<TIMED>(grid, tally);\n", call0)
    end = h.index("    sync<TIMED>(grid, tally);\n  }\n}\n", call1) + len("    sync<TIMED>(grid, tally);")
    call = h[call0 + len("    const int* live_in = p.live + cur * p.n;\n"):call1].rstrip("\n")
    test = re.search(r"^    test_round<FRESH>\(.*\);$", h[call1:end], re.M).group(0)
    grouped = "select_groups" in call
    if g1:
        if not grouped or call.count(G1[0]) != 1:
            raise ValueError("g1 needs a source with select_groups")
        call = call.replace(*(G1 if CHUNK_STAGE in h else G1_RESIDENT))
    h = h[:start] + ROUND.replace("SELECT_CALL", call).replace("TEST_CALL", test).replace(
        "DBG_G_OF", "g" if grouped else "1") + h[end:]
    if "// the lists are whole" in h:  # a test phase that culls by sub-tile
        h = _in_fn(h, "test_round", TEST_MARKS)
    if "item = __shfl_sync(FULL, item, 0);" in h:  # a warp's next_item
        h = _in_fn(h, "next_item", NEXT_MARKS)
    if grouped:
        marks = CHUNK_GROUP_MARKS if CHUNK_STAGE in h else GROUP_MARKS
        return _in_fn(_in_fn(h, "select_threads", THREAD_MARKS), "select_groups", marks)
    return _in_fn(h, "select_round", THREAD_MARKS)


def patched(label: str, src: Path, g1: bool) -> Path:
    out = ROOT / "build" / "pieces" / label
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    (out / "pairs.cuh").write_text(patch((out / "pairs.cuh").read_text(), g1))
    f = (out / "fused_queue.cu").read_text()
    if "bq::sync_cycles = 0;" not in f:
        raise ValueError(f"{src}: no sync_cycles reset in fused_queue.cu")
    f = f.replace("bq::sync_cycles = 0;", "bq::sync_cycles = 0;\n    bq::dbg_round = 0;\n"
                  "    for (int k = 0; k < 4; ++k) bq::dbg_sel[k] = 0;\n"
                  "    for (int k = 0; k < 5; ++k) bq::dbg_tst[k] = 0;\n"
                  "    for (int k = 0; k < 2; ++k) bq::dbg_nx[k] = 0;") + READ
    (out / "fused_queue.cu").write_text(f)
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.experiments import ab_fused_queue as ab
    from ensem3a_openclraytracer_tpu_torch.experiments import common
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg

    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", help="LABEL=DIR[:g1], a copy of csrc/")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--scene", choices=("outdoor", "closedbox", "outdoor600k"), default="outdoor")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    srcs = [("this", Path(__file__).resolve().parents[1] / "csrc", False)]
    for s in a.sources:
        label, rest = s.split("=", 1)
        g1 = rest.endswith(":g1")
        srcs.append((label, Path(rest[:-3] if g1 else rest), g1))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    sun = a.scene != "closedbox"  # the closed box: NEE, no sun
    g, m, e, c = {"outdoor": lambda: tt.make_outdoor_scene(n_cubes=1300, device=dev),
                  "closedbox": lambda: common.closedbox(dev),
                  "outdoor600k": lambda: common.outdoor600k(dev)}[a.scene]()
    lights = None if sun else build_light_pack(g, m)
    args = cs.fused_inputs(g, m, e, c, a.res)
    key = rg.key_from_generator(torch.Generator(device=dev).manual_seed(3), dev)
    result, first = {}, None
    for label, src, g1 in srcs:
        lb = ab.build(f"pieces_{label}", patched(label, src, g1))
        q = lb["queue"]
        q.read_pieces.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        print(f"[{label}] ptxas {lb['ptxas']['fused_queue']}; grid {lb['grid']}", flush=True)
        grid = lb["grid"][0] * lb["grid"][1]
        reps = []
        for rep in range(REPS):
            q.clear_pieces()
            out = ab.sample(q, args, key, not sun, lights, sun=sun)
            torch.cuda.synchronize()
            first = out if first is None else first
            if not all(torch.equal(x, y) for x, y in zip(out, first)):
                raise SystemExit(f"{label}: outputs differ from this checkout's")
            piece = np.zeros(R * G * W, dtype=np.uint32)
            wall = np.zeros(R * 2, dtype=np.uint64)
            if q.read_pieces(piece.ctypes.data, wall.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            piece = piece.reshape(R, G, W)[:, :grid].astype(np.float64)
            wall = wall.reshape(R, 2).astype(np.float64)
            nr = int((wall[:, 1] > 0).sum())
            piece, wall = piece[:nr], wall[:nr]
            wall_us = (wall[:, 1] - wall[:, 0]) / 1e3
            ghz = piece[:, 0, :8].sum() / (wall_us.sum() * 1e3)  # block 0's cycles over the wall
            us = piece[:, :, :8] / (ghz * 1e3)  # [round, block, piece]
            st = piece[:, :, 11:15] / (ghz * 1e3)  # [round, block, step]
            tst = piece[:, :, 16:21] / (ghz * 1e3)  # [round, block, test step]
            nx = piece[:, :, 21:23] / (ghz * 1e3)  # [round, block, next_item step]
            rows = []
            for r in range(nr):
                mx, smx, tmx = us[r].max(axis=0), st[r].max(axis=0), tst[r].max(axis=0)
                nmean = nx[r].mean(axis=0)
                rows.append(dict(round=r, g=int(piece[r, 0, 15]), wall_us=wall_us[r],
                                 n_live=int(piece[r, 0, 9]), work_items=int(piece[r, 0, 10]),
                                 max_select=mx[0], scan0=us[r, 0, 2], max_fill=mx[4],
                                 max_test=mx[6], steps={k: smx[i] for i, k in enumerate(STEPS)},
                                 test_steps={k: tmx[i] for i, k in enumerate(TEST_STEPS)},
                                 next_steps=dict(atomic=nmean[0], search=nmean[1]),
                                 min_syncs=[float(v) for v in us[r].min(axis=0)[[1, 3, 5, 7]]]))
            tot = lambda k: float(sum(x[k] for x in rows))  # noqa: E731
            summary = dict(rounds=nr, ghz=ghz, wall_us=float(wall_us.sum()),
                           max_select_us=tot("max_select"), scan_us=tot("scan0"),
                           max_fill_us=tot("max_fill"), max_test_us=tot("max_test"),
                           steps_us={k: float(sum(x["steps"][k] for x in rows)) for k in STEPS},
                           test_steps_us={k: float(sum(x["test_steps"][k] for x in rows))
                                          for k in TEST_STEPS},
                           sync_latency_us=float(sum(sum(x["min_syncs"]) for x in rows)),
                           select_us_by_g={g: dict(rounds=len(xs), max_select_us=float(
                               sum(x["max_select"] for x in xs)), live=sum(x["n_live"] for x in xs))
                               for g in sorted({x["g"] for x in rows})
                               for xs in [[x for x in rows if x["g"] == g]]})
            print(f"[{label} rep {rep}] {json.dumps(summary)}", flush=True)
            reps.append(dict(summary=summary, rows=rows))
        for x in reps[-1]["rows"]:
            print(f"[{label}] round {x['round']}: G {x['g']}, wall {x['wall_us']:.1f} us, live "
                  f"{x['n_live']}, items {x['work_items']}; max select {x['max_select']:.1f} "
                  f"{ {k: round(v, 1) for k, v in x['steps'].items()} }, scan {x['scan0']:.1f}, "
                  f"max fill {x['max_fill']:.1f}, max test {x['max_test']:.1f} "
                  f"{ {k: round(v, 1) for k, v in x['test_steps'].items()} }, next_item's "
                  f"(mean of CUDA blocks) { {k: round(v, 1) for k, v in x['next_steps'].items()} }",
                  flush=True)
        ms = ab.in_turns({label: lambda: ab.sample(q, args, key, not sun, lights, sun=sun)}, 100, 2)
        print(f"[{label}] instrumented ms a sample {ms[label]} [{smi}]", flush=True)
        result[label] = reps
    out = ROOT / "build" / "pieces"
    (out / f"pieces_{a.scene}_{a.res}_{'_'.join(s[0] for s in srcs)}.json").write_text(
        json.dumps(result, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
