"""The block-queue kernels, 2b (``csrc/fused_queue.cu``) and #3
(``csrc/pairs.cu``), from other sources head to head with this checkout's,
timed in turns on the card.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.ab_fused_queue \\
        [LABEL=DIR ...] [--iters N] [--turns T] [--shapes NAME ...]

Each ``DIR`` is a copy of ``csrc/`` holding both sources and their headers,
such as a parent commit's::

    git archive <commit> ensem3a_openclraytracer_tpu_torch/csrc | tar -x -C build/parent

(``DIR`` is then ``build/parent/ensem3a_openclraytracer_tpu_torch/csrc``).
This checkout's ``csrc/`` comes first, as ``this``.  Every source is built
with ``_build``'s nvcc flags; its ptxas registers, stack and spills and its
launch grids are printed.  Both kernels keep their C interface across the
sources (a stats buffer of :data:`STATS_SLOTS` slots takes any version's
2b counters, printed raw), but for the sub-tile boxes after the block
bounds, which a library that exports ``pairs_sub_tile`` /
``fused_queue_sub_tile`` takes and an older one does not; ``pairs.cu``'s
entry points take no ``k``, so a source whose entry points do is not a
match, and ``fused_queue_launch`` takes a running sum and the sky after its
scratch, so a source whose entry point does not is not one either.

2b: one sample at each of :data:`SHAPES` (``cell`` is ``outdoor15k.render``'s:
outdoor_1300 at 256^2, 4 bounces, sun, the kernel's own Philox stream;
``closedbox`` is ``closedbox15k.nee``'s: the benchmark's closed box at
256^2, 4 bounces, NEE, no sun; ``outdoor_50000`` is ``outdoor600k.render``'s
2,344 blocks at 256^2, sun; the others are ``chip_smoke.py`` phase 5's),
each source's outputs held bit-equal to this checkout's, then ``iters``
samples timed with CUDA events per turn, the sources in order and then in
reverse, ``turns`` times; the median ms a sample.  #3: one trace of
``chip_smoke.role_rays`` (327,680 rays) on outdoor_1300 and outdoor_12500
and of the cell's 65,536 primary rays, its hits and three of its counts
(stagings, rounds, slab tests) held equal to this checkout's and its pairs
tested printed (a source whose test phase culls otherwise tests other
pairs), then timed the same way; at the :data:`GROUPS` shapes, which select
with groups of lanes, also against the plain version
(``ops/pairs.trace_pairs_plain``: the triangles that differ and its
counts).  The last line is one JSON object with every number.  Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

STATS_SLOTS = 64
# name -> (cubes, or None for the closed box, rays per side, NEE)
SHAPES = {"cell": (1300, 256, False), "closedbox": (None, 256, True),
          "outdoor_1000": (1000, 512, False),
          "outdoor_1000_nee": (1000, 512, True), "outdoor_1300": (1300, 512, False),
          "outdoor_12500": (12500, 256, False), "outdoor_50000": (50000, 256, False)}
TRACES = {"rays_1300": (1300, 512, 65536), "rays_12500": (12500, 512, 65536),
          "rays_cell": (1300, 256, 0)}  # name -> (cubes, rays per side, bounce rays)
# name -> cubes: the rays of tests/test_torch_cuda.py's
# test_pairs_kernel_groups_small_selects_exactly at half the grid's threads
# (group_rays)
GROUPS = {"groups_61": 1300, "groups_586": 12500}


def build(label: str, csrc: Path) -> dict:
    """The two libraries of ``csrc`` (built with ``_build``'s flags), typed
    as ``ops/fused`` and ``ops/pairs`` type theirs, and their ptxas lines."""
    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256()
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    procs = {}
    for name in ("fused_queue", "pairs"):
        out = _build.BUILD_DIR / f"ab_{label}_{name}-{h.hexdigest()[:12]}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(csrc / f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (out, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{text}")
        ptxas[name] = [ln.strip() for ln in text.splitlines()
                       if any(w in ln for w in ("registers", "stack frame", "Function properties"))]
        libs[name] = ctypes.CDLL(str(out))
    q = libs["fused_queue"]
    feat = fu._ARGTYPES_QUEUE_FEAT if takes_sub_tiles(q) else fu._ARGTYPES_FEAT
    q.fused_queue_launch.argtypes = (fu._ARGTYPES_HEAD + feat + fu._ARGTYPES_MID
                                     + [ctypes.c_void_p] * 2 + fu._ARGTYPES_SKY
                                     + fu._ARGTYPES_TAIL)
    q.fused_queue_launch.restype = ctypes.c_int
    q.fused_queue_scratch_bytes.argtypes = [ctypes.c_int] * 3
    q.fused_queue_scratch_bytes.restype = ctypes.c_longlong
    q.fused_queue_grid.argtypes = [ctypes.c_void_p]
    p = libs["pairs"]
    p.pairs_launch.argtypes = (pp._KERNEL_ARGTYPES if takes_sub_tiles(p) else
                               pp._KERNEL_ARGTYPES[:5] + pp._KERNEL_ARGTYPES[6:])
    p.pairs_launch.restype = ctypes.c_int
    p.pairs_scratch_bytes.argtypes = [ctypes.c_int] * 2
    p.pairs_scratch_bytes.restype = ctypes.c_longlong
    p.pairs_grid.argtypes = [ctypes.c_void_p]
    grid = (ctypes.c_int * 6)()
    q.fused_queue_grid(ctypes.addressof(grid))
    pgrid = (ctypes.c_int * 5)()
    p.pairs_grid(ctypes.addressof(pgrid))
    sub = p.pairs_sub_tile() if takes_sub_tiles(p) else None
    return dict(label=label, queue=q, pairs=p, ptxas=ptxas, grid=list(grid), pairs_grid=list(pgrid),
                sub=sub)


def takes_sub_tiles(lib) -> bool:
    """Whether a library of ``pairs.cu`` or ``fused_queue.cu`` takes the
    sub-tile boxes after the block bounds (it exports its sub-tile)."""
    return hasattr(lib, "pairs_sub_tile") or hasattr(lib, "fused_queue_sub_tile")


def sub_tiled(geom, feats, width):
    """``feats`` with the sub-tile boxes of a source built for sub-tiles of
    ``width`` triangles (None: a source without them)."""
    import numpy as np
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    if width is None or width == ch.SUB_TILE:
        return feats
    allv = np.stack([x.cpu().numpy() for x in (geom.v0, geom.v1, geom.v2)])
    boxes = ch.tri_boxes(allv, feats.edges.shape[-1], width)
    return feats._replace(sub_bounds=torch.as_tensor(boxes, device=feats.edges.device))


def sample(lib, args, key, nee, lights, stats=None, sun=True):
    """One 2b sample of ``lib`` on the engine's arguments, 4 bounces, as
    ``ops/fused.sample_fused_queue`` launches it."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu

    run = fu._Launch(*args, key, 0, max_bounce=4, sun_enabled=sun, uniforms=None, nee=nee,
                     lights=lights, record=False, stats=None)
    out, tail = run.tail(False)
    tail = tail[:6] + (None if stats is None else stats.data_ptr(),) + tail[7:]
    scratch = torch.empty((lib.fused_queue_scratch_bytes(run.n, run.nb, int(nee)),),
                          dtype=torch.uint8, device=run.dev)
    feat = (run.feat[:2] + (args[0].sub_bounds.data_ptr(),) + run.feat[2:]
            if takes_sub_tiles(lib) else run.feat)
    err = lib.fused_queue_launch(*run.head, *feat, *run.mid, scratch.data_ptr(), None,
                                 None, 0, 0, 0, None, *tail)  # no running sum
    if err != 0:
        raise RuntimeError(f"fused_queue launch failed: CUDA error {err}")
    return out


def trace(lib, feats, o, d, stats=None):
    """One ``pairs.cu`` trace of ``lib``, as ``ops/pairs.trace_pairs``
    launches it: ``(t, tri, hit)``."""
    import torch

    n, nb = o.shape[0], feats.block_bounds.shape[0]
    tp = feats.edges.shape[-1]
    dev = o.device
    out = (torch.empty(n, device=dev), torch.empty(n, dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    scratch = torch.empty((lib.pairs_scratch_bytes(n, nb),), dtype=torch.uint8, device=dev)
    bounds = (feats.block_bounds.data_ptr(),) + ((feats.sub_bounds.data_ptr(),)
                                                 if takes_sub_tiles(lib) else ())
    err = lib.pairs_launch(o.data_ptr(), d.data_ptr(), n, feats.packed.data_ptr(),
                           *bounds, tp, tp // nb, nb, scratch.data_ptr(),
                           *(x.data_ptr() for x in out),
                           None if stats is None else stats.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs launch failed: CUDA error {err}")
    return out


def group_rays(geom, cam, dev, threads: int):
    """The last ``threads // 2`` of the 128^2 camera rays and ``threads``
    rays leaving random primary rays' ends in random directions (numpy
    seed: the block count + 2), as the card test draws them."""
    import numpy as np
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
    from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays

    o, d = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, 128, 128)
    h = ch.trace_plain(geom.feats, o.contiguous(), d)
    rng = np.random.default_rng(geom.feats.block_bounds.shape[0] + 2)
    pick = torch.as_tensor(rng.integers(0, o.shape[0], threads), device=dev)
    bd = torch.as_tensor(rng.normal(size=(threads, 3)).astype(np.float32), device=dev)
    bd = torch.nn.functional.normalize(bd, dim=-1)
    bo = o[pick] + d[pick] * h.t[pick, None]
    o, d = torch.cat([o, bo]), torch.cat([d, bd])
    return o[-(threads // 2):].contiguous(), d[-(threads // 2):].contiguous()


def in_turns(fns: dict, iters: int, turns: int) -> dict:
    """Per label, the ms a call of each turn (CUDA events over ``iters``
    calls), the labels in order then in reverse, ``turns`` times."""
    import torch

    times = {k: [] for k in fns}
    for fn in fns.values():  # warm
        fn()
    order = list(fns)
    for t in range(turns):
        for k in order if t % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fns[k]()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end) / iters)
    return times


def main(argv=None) -> int:
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.experiments import common
    from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", help="LABEL=DIR, a copy of csrc/")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES) + list(TRACES) + list(GROUPS))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = Path(__file__).resolve().parents[2]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import chip_smoke as cs

    dev = torch.device("cuda")
    srcs = [("this", Path(__file__).resolve().parents[1] / "csrc")]
    srcs += [(s.split("=", 1)[0], Path(s.split("=", 1)[1])) for s in a.sources]
    def build_or_skip(src):
        try:
            return build(*src)
        except RuntimeError as err:  # a source the compiler refuses is left out
            print(f"[{src[0]}] left out: {err}", flush=True)
            return None

    with ThreadPoolExecutor(len(srcs)) as pool:  # the compilers run together
        libs = [lb for lb in pool.map(build_or_skip, srcs) if lb is not None]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    result = {"card": smi, "sources": {}, "sample_ms": {}, "trace_ms": {}, "stats": {}}
    for lb in libs:
        result["sources"][lb["label"]] = dict(ptxas=lb["ptxas"], queue_grid=lb["grid"],
                                              pairs_grid=lb["pairs_grid"])
        print(f"[{lb['label']}] ptxas {lb['ptxas']}; 2b grid (per SM, SMs, registers, threads, "
              f"smem, local) {lb['grid']}; pairs grid {lb['pairs_grid']}", flush=True)
    key = rg.key_from_generator(torch.Generator(device=dev).manual_seed(3), dev)
    for name in (s for s in a.shapes if s in SHAPES):
        cubes, res, nee = SHAPES[name]
        sun = cubes is not None
        g, m, e, c = (tt.make_outdoor_scene(n_cubes=cubes, emissive_panel=nee, device=dev) if sun
                      else common.closedbox(dev))
        args = cs.fused_inputs(g, m, e, c, res)
        lb_args = {lb["label"]: (sub_tiled(g, args[0], lb["sub"]),) + args[1:] for lb in libs}
        lights = build_light_pack(g, m) if nee else None
        first = None
        for lb in libs:
            stats = torch.zeros(STATS_SLOTS, dtype=torch.int64, device=dev)
            out = sample(lb["queue"], lb_args[lb["label"]], key, nee, lights, stats, sun)
            torch.cuda.synchronize()
            if first is None:
                first = out
            same = all(torch.equal(x, y) for x, y in zip(out, first))
            result["stats"][f"{name}/{lb['label']}"] = stats.tolist()
            print(f"[{name}] {lb['label']}: outputs bit-equal to this checkout's {same}; stats "
                  f"{stats.tolist()}", flush=True)
            if not same:
                raise SystemExit(f"{lb['label']} differs from this checkout on {name}")
        times = in_turns({lb["label"]: (lambda lb=lb: sample(lb["queue"], lb_args[lb["label"]], key,
                                                             nee, lights, sun=sun))
                          for lb in libs}, a.iters, a.turns)
        result["sample_ms"][name] = times
        for k, v in times.items():
            print(f"[{name}] {k}: ms a sample by turn {[round(x, 5) for x in v]}, median "
                  f"{statistics.median(v):.5f} [{smi}]", flush=True)
    pg = pp.kernel_grid()
    threads = pg["blocks_per_sm"] * pg["sms"] * pg["threads"]
    for name in (s for s in a.shapes if s in TRACES or s in GROUPS):
        if name in GROUPS:
            g, _, _, c = tt.make_outdoor_scene(n_cubes=GROUPS[name], device=dev)
            o, d = group_rays(g, c, dev, threads)
            plain_stats = torch.zeros(4, dtype=torch.int64, device=dev)
            plain = pp.trace_pairs_plain(g.feats, o, d, stats=plain_stats)
            result["stats"][f"{name}/plain"] = plain_stats.tolist()
            print(f"[{name}] plain version: stats {plain_stats.tolist()}", flush=True)
        else:
            cubes, res, n_bounce = TRACES[name]
            g, _, _, c = tt.make_outdoor_scene(n_cubes=cubes, device=dev)
            o, d = cs.role_rays(g, c, dev, seed=2, res=res, n_bounce=max(n_bounce, 1))
            if n_bounce == 0:  # the camera's rays alone
                o, d = o[:res * res].contiguous(), d[:res * res].contiguous()
            plain = None
        lanes = pp.select_lanes(o.shape[0], g.feats.block_bounds.shape[0], threads)
        print(f"[{name}] {o.shape[0]} rays: this checkout's first select gives each "
              f"{lanes} lanes", flush=True)
        lb_feats = {lb["label"]: sub_tiled(g, g.feats, lb["sub"]) for lb in libs}
        first = None
        for lb in libs:
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            out = trace(lb["pairs"], lb_feats[lb["label"]], o, d, stats)
            torch.cuda.synchronize()
            if first is None:
                first = (out, stats)
            same = all(torch.equal(x, y) for x, y in zip(out, first[0]))
            counts = torch.equal(stats[1:], first[1][1:])
            result["stats"][f"{name}/{lb['label']}"] = stats.tolist()
            vs_plain = ("" if plain is None else
                        f"; triangles differing from the plain version's "
                        f"{int((out[1] != plain.tri).sum())}")
            print(f"[{name}] {lb['label']}: {o.shape[0]} rays, hits bit-equal to this "
                  f"checkout's {same}, stagings, rounds and slab tests equal {counts}; stats "
                  f"{stats.tolist()}{vs_plain}", flush=True)
            if not (same and counts):
                raise SystemExit(f"{lb['label']} differs from this checkout on {name}")
        times = in_turns({lb["label"]: (lambda lb=lb: trace(lb["pairs"], lb_feats[lb["label"]], o,
                                                            d))
                          for lb in libs}, a.iters, a.turns)
        result["trace_ms"][name] = times
        for k, v in times.items():
            print(f"[{name}] {k}: ms a trace by turn {[round(x, 5) for x in v]}, median "
                  f"{statistics.median(v):.5f} [{smi}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
