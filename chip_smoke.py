#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``ensem3a_openclraytracer_tpu_torch/csrc``
and drives the port's main path, a scene loaded from an ``.obj`` + ``.ini``
and rendered at its ini settings with the default engine, its gradient
path (record, replay, train step, optimisation) and its command line
(progressive renders, ``--mesh``, ``optimize``, ``bench``) on the card:

1. environment and build: the card's name and power limit, versions, and
   the kernels' build time and ``-Xptxas -v`` report;
2. the resident closest-hit kernel against plain on one block (Cornell):
   ``trace_resident`` against ``trace_plain`` on the same 512^2 primary rays
   plus 65,536 bounce rays, with times, the (ray, triangle) pairs tested and
   needed, the least time the card could take (from the needed pairs), and
   its registers;
3. the main path at full size: ``Scene.load`` -> ``render_scene`` on seven
   renders, all on the fused engine, each a replay of the graph that the
   scene's first ``render_scene`` captured (``render_radiance_jit``; that
   first call's warm-up, capture and instantiation on a line of their
   own).  Cornell (1 block) and Cornell with NEE
   take it on ``csrc/fused_sample.cu``'s whole-render launch (``closest_hit``
   once, ``sample_fused`` once per render); outdoor_1000 (47 blocks),
   outdoor_1000 with a light panel and NEE, outdoor_1300 (61 blocks),
   outdoor_12500 (586 blocks) and the benchmark's ``outdoor600k`` (2,344
   blocks, above ``AGG_BLOCKS`` and ``SEL_BLOCKS``; written from
   ``port_bench/configs/outdoor600k.json`` as its cell writes it, at its
   256^2, 100 spp, 4 bounces) on ``csrc/fused_queue.cu`` (``pairs`` once,
   ``sample_fused_queue`` once per sample, ``sample_fused`` and ``uniforms``
   never).  The launch counts are set to 0 before each scene's first
   render (the main path: it launches every kernel through its wrapper,
   then captures the graph, which launches none) and checked after it; a
   replay is timed and counts nothing; one more replay of each is traced
   with ``torch.profiler`` (kernel time by name, device idle share) and the
   port's kernels in that trace (``ops/launches.count_kernels``) must be
   the warm-up's;
4. the same explicit random stream through the scan path with the kernel
   and with the plain scan on the card, at 64^2, 2 spp, 3 bounces: pixel
   forks below 2 %;
5. fused kernels against plain, per role, on arguments from the engine's
   own ``fused_args``.  One block (Cornell and Cornell with NEE, on
   ``fused_sample``): the whole-render launch against ``render_fused_plain``
   on the same explicit uniforms at 64^2, 2 spp, 3 bounces, and the
   one-sample launch against ``sample_fused_plain`` there; at the main
   path's shape (512^2 rays, 4 bounces, 64 samples, the kernel's own Philox
   stream) the whole-render launch against ``render_fused_plain`` and
   against 64 one-sample launches with the IBL and the sum on the host (0
   pixel forks at 1e-3); its time per render and per sample beside the
   one-sample launch's and the per-sample path's, its bound (from the pairs
   its traces need), ptxas registers and spills, its grid, items and
   waves.  Several blocks (outdoor_1000 with sun + IBL, and with its light
   panel and NEE, outdoor_1300, outdoor_12500 and phase 3's outdoor600k, on
   ``fused_queue``): one sample at 64^2 on explicit uniforms and at the
   render's own ray count (512^2; 256^2 on outdoor_12500 and outdoor600k;
   Morton-permuted, 4 bounces) on its own stream,
   its counts within 1 % of its plain version's, rounds, the grid syncs it
   counted, one sample under ``set_sync_debug_mode("error")``, its grid,
   and a sample with nothing to trace; above ``AGG_BLOCKS`` some rounds
   but not all group lanes, and above ``SEL_BLOCKS`` one bounce without
   sun counts exactly what the plain version counts; on outdoor_1300 the
   whole render
   (``render_fused_queue``: one launch a sample, the IBL and the sum inside
   it) at the benchmark's 256^2, 100 spp and the main path's 512^2, 16 spp
   against the per-sample loop it replaced (one launch a sample, the IBL
   lookup and the sum in PyTorch after each): 0 pixel forks at 1e-3,
   whether the two are bit-equal, both timed, and the device kernels a
   profiled run of each ran.  Pixel forks below 2 % and median
   difference below 1e-5 against plain everywhere; record mode (one sample)
   on Cornell and outdoor_1000 at both shapes;
6. stream identity: the fused kernels' in-kernel Philox stream against the
   RNG kernel's stream fed in explicitly gives the same images (0 forks)
   at each phase-5 role's shape, per sample and (one block) per render; the
   RNG kernel is bit-equal to its plain version at 2^24 values, with its
   time, bound and the plain version's time (it is off the main path: the
   scan estimator draws with it);
7. the same scene at the same settings with ``fused=True`` and with
   ``fused=False`` (Cornell, outdoor_1000, outdoor_1300, outdoor_12500):
   render times;
8. the grouped-pair prototype (``experiments/proto_grouped.trace_grouped``,
   kernel ``grouped_pairs``) on outdoor_1300 (61 blocks) and outdoor_12500
   (586 blocks), 65,536 rays built as the prototypes build them: one trace
   with the launch counts set to 0 before it and read after it, the kernel
   against its plain version (and the rays that differ in any bit; its
   counts, pairs tested and stagings, equal) and against ``trace_plain``
   (phase 2's bounds), two launches bit-equal, pairs tested within 1.25x
   the pairs needed, its ptxas report and launch plan (grid, shared memory
   per CUDA block, CUDA blocks per SM), then head to head with
   ``trace_pairs`` (the live engine) on the same rays: the kernel alone,
   the schedule and the whole trace, with the pairs tested per ray of
   each, all timed with ``tree_ms``;
9. the same for the pair-compaction prototype
   (``experiments/proto_compact.trace_compact``, kernel ``pair_compact``,
   one launch per round, the fold into each ray's best key inside it):
   the kernel's ``best_key`` after every round against its plain version
   folded over the same rounds' queues (phase 2's bounds, the rays that
   differ in any bit), counts equal (stagings per sub-tile), two launches
   bit-equal, its ptxas report and launch plan, its rounds, live tiles and
   real slots per round, times per round, per trace and of the whole
   trace, the bound per launch and per trace, and the per-piece profile of
   its first round (slab+sort, queue build, kernel with its fold);
10. the block-queue closest hit (``ops/pairs.trace_pairs``, kernel
   ``pairs``, one cooperative launch per trace) in roles #3 and #4, on
   phase 2's kind of rays (``role_rays``: 512^2 primary rays plus 65,536
   bounce rays, 327,680 in all) and at each render's own trace shape
   (262,144 bounce rays on outdoor_1300, 65,536 on outdoor_12500), and on
   outdoor600k's 2,344 blocks at its 256^2 (131,072 rays, then 65,536):
   against ``trace_plain`` at phase 2's bounds, counts equal to its plain
   version's, two runs equal, one trace under
   ``set_sync_debug_mode("error")`` (no host sync), times, pairs tested
   against needed, rounds, bound from the needed pairs.  Phases 8-9 also
   time it on the prototypes' rays;
11. the gradient path (``models/replay.py``, ``models/optimize.py``):
   (1) the fused recorder at the training shapes, Cornell 512^2, 100 spp,
   4 bounces (``fused_sample``'s record mode, one launch per sample) and
   outdoor_1000 512^2, 16 spp, sun + IBL (``fused_queue``'s): launches
   (= spp, no scan trace), time per sample, record bytes, and the record
   launch alone against its plain version with its bound; (2) the replay of
   those records against ``render_radiance(fused=None)`` at the same seed
   (forks < 2 %, median < 1e-5); (3) the replay's gradients on the card
   (scan recorder on the kernels, explicit uniforms, 64^2, 2 spp, 3
   bounces; Cornell, outdoor_1000, the glass-light scene with NEE) against
   the same call on the CPU (1e-4 relative per parameter) and chunked
   (``spp_chunk=1``) against unchunked (1e-5); (4) value+grad of
   ``image_loss`` through ``render_for_grad`` at bench.py's fwd+bwd shape
   (Cornell 512^2, 100 spp) and texel-gradient shape (outdoor with 64
   cubes, a 4096x8192 sky, 128^2, 4 spp, sun): s per step, Mrays/s, peak
   memory, launches (the backward launches none of the port's kernels), a
   profile split into record kernels, the port's other kernels, replay
   forward, backward and idle share, and two ``make_train_step`` steps (the
   first captures the step's graph, the second replays it);
   (5) ``run_optimization`` on Cornell at 128^2, 8 spp, 12 iterations from
   perturbed colors: the loss falls, and a run stopped after 6 iterations
   and resumed from its checkpoint gives the same losses bit for bit;
12. the product surface (``cli.py``, ``models/progressive.py``,
   ``parallel/``), in process, on scenes written as ``.obj`` + ``.ini``:
   (1) ``cli render`` of Cornell (512^2, 64 spp) and outdoor_1000 (512^2,
   16 spp) at the ini's settings in chunks of 16 with a checkpoint after
   each, the launch counts set to 0 before each call and read after it
   (the first chunk, which captures the chunk's graph: Cornell
   ``closest_hit`` and ``sample_fused`` once; outdoor_1000 ``pairs`` once,
   ``sample_fused_queue`` once per sample), and a traced call whose trace
   holds every chunk's kernels (Cornell: ``closest_hit`` and
   ``sample_fused`` once per chunk; outdoor_1000: ``pairs`` once per chunk,
   ``sample_fused_queue`` once per sample), wall and Mrays/s beside the
   same render without checkpoints and ``render_scene``'s; (2) Cornell stopped after two chunks and
   resumed: ``accum`` bit-equal to the uninterrupted run's, and the image
   equal to the float64 mean of its four ``render_radiance`` chunk calls
   (0 forks at 1e-3); (3) ``render --mesh 1,1`` with ``torchrun``'s
   environment set for one rank: the CLI joins an ``nccl`` group on
   ``cuda:0`` itself, and its render is bit-equal to the one without
   ``--mesh``; (4) one ``optimize``
   iteration (Cornell 128^2, 8 spp, ``--dry-run``); (5) ``bench``, whose
   JSON lines are printed;
13. the tree (``accel/``, ``ops/traversal.py``, kernel ``bvh_trace``):
   outdoor_12500's LBVH built on the host and on the card (equal);
   ``trace_bvh`` against ``trace_bvh_plain`` on the card on 262,144
   Cornell rays and on 65,536 outdoor bounce rays (outdoor_1300,
   outdoor_12500): ``t``, ``tri``, ``hit`` and the five counts equal (nodes
   popped, leaf tests, dropped pushes, the most nodes one ray popped, the
   sum over warps of each warp's most, whence the SIMT efficiency), two
   launches equal, times warm and with L2 flushed, ptxas registers, stack
   frame and spills; on phase 10's 327,680 rays against ``pairs.cu``; Cornell, outdoor_1300 and
   outdoor_12500 loaded with ``use_bvh=True`` and rendered (``bvh_trace``
   once per trace, the time per launch inside the profiled render; replays,
   after a first call that captures); replay gradients on a tree-only
   Cornell, card against CPU;
14. the compiled entry points as captured CUDA graphs (``utils/graphs.py``):
   ``render_radiance_jit`` against ``render_radiance`` (Cornell, Cornell
   with NEE, outdoor_1300 on 2b, a tree-only outdoor_1300 on the scan
   estimator), the progressive chunk function against its eager form (and
   a Cornell render stopped after two chunks and resumed, against the
   float64 fold of eager chunks), ``make_train_step``'s step against
   ``step.eager`` (the Cornell trainer at 128^2, 8 spp, with three chained
   steps; the texel step; Cornell value+grad at 512^2 and
   ``GRAPH_STEP_SPP`` samples): the first call (warm-up, capture under
   ``set_sync_debug_mode("error")``, instantiation, pool bytes), the first
   call, the first replay and a replay with a new key bit-equal to eager,
   the port's kernels the first call and the eager call launch (counted
   by the wrappers; a replay counts none) against those a profiled replay
   ran (counted in its trace), a render replayed after the camera, a
   material's colour, the emitters' power, the sun and (NEE) the lights
   changed, bit-equal to eager on the new values (Cornell with NEE,
   outdoor_1300), eager and graphed walls (median of ``GRAPH_RUNS``), and
   one profiled eager call and replay (kernels, device busy, idle share).

Every check that fails ends the run with a non-zero exit code and no
result line.  Without a card, the script fails.  The next-to-last line is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_FP32 = 67e12  # H100 SXM, FP32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# 32-bit integer instructions: 64 lanes per SM per clock (half the FP32
# lanes; Hopper white paper) x 132 SMs x 1.98 GHz
PEAK_INT32 = 64 * 132 * 1.98e9
# FP32 operations (FMA counted as two) per (ray, triangle) pair tested:
# three 6-term side tests (33), d.n (5), [o,1].plane (6), one divide (1)
FLOPS_PER_PAIR = 45
# per (ray, triangle block) slab test: 3 axes x (2 sub, 2 mul, min, max,
# max, min) plus the 6-operation epsilon margin
FLOPS_PER_SLAB = 30
RAYS_PER_CTA = 128
# FP32 operations per ray and bounce of the fused kernel outside its
# traces, counted from csrc/fused_sample.cu with sinf/cosf at 20 each:
# frame 14, sin/cos 40, radii and pdfs 11, two candidate directions 48,
# |cos| 6, the cheapest throughput update (Lambert) 8, the trace's ray
# setup 15, the advance 6; plus 27 per sun shadow ray (setup 15, tint 12)
# and 80 per NEE sample (light point 30, distances 20, setup 15, Lambert 15)
FUSED_FLOPS_PER_BOUNCE = 148
FUSED_FLOPS_SUN = 27
FUSED_FLOPS_NEE = 80
# Philox4x32-10 per block of four uniforms: 10 rounds x (two 32x32->64
# products, two 3-way XORs) + 9 x 2 key bumps, then shift, convert and scale
# per uniform
INT_OPS_PER_PHILOX = 10 * 4 + 9 * 2 + 4 * 3
SMOKE_TRIES = (64, 2, 3)  # kernel-against-plain renders: res, spp, bounces
MAIN_SHAPE = (512, 4)  # the fused kernel's rays per side and bounces on the main path
MAIN_SPP = 64  # samples of the one-block renders on the main path


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_once(fn):
    """``fn()``'s result and its time in ms (one call, CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def image_forks(img_k, img_p):
    """(pixel fork fraction, median, max) of the max-channel |difference|."""
    diff = (img_k - img_p).abs().amax(dim=-1)
    return float((diff > 1e-3).float().mean()), float(diff.median()), float(diff.max())


def bound(flops: float, nbytes: float, peak_ops: float = PEAK_FP32):
    """(bound ms, what bounds it): the larger of the operations at the
    card's peak and the bytes at its memory rate."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ptxas(log_text: str, kernel: str) -> dict:
    """Registers and spills of the kernel whose mangled name holds
    ``kernel``, from a build's ``-Xptxas -v`` report."""
    import re

    info, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or kernel not in cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                        spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["registers"] = int(m.group(1))
    check("registers" in info, f"no ptxas report for a kernel named like {kernel}")
    return info


def launch_registry():
    """``ops/launches``, the one registry of the wrappers' counters, with
    every wrapper module imported (the prototypes' too)."""
    from ensem3a_openclraytracer_tpu_torch.experiments import (  # noqa: F401
        proto_compact,
        proto_grouped,
    )
    from ensem3a_openclraytracer_tpu_torch.ops import (  # noqa: F401
        closest_hit,
        fused,
        launches,
        pairs,
        rng,
        traversal,
    )

    return launches


def reset_launches():
    launch_registry().reset()


def read_launches() -> dict:
    return launch_registry().read()


def traced_launches(prof) -> dict:
    """The port's kernels that a torch.profiler trace saw run, by counter
    (``ops/launches.count_kernels``): a graph replay runs no wrapper, so
    its launches are counted here."""
    import torch

    return launch_registry().count_kernels(
        ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)


def role_rays(geom, cam, dev, seed: int, res: int = 512, n_bounce: int = 65536):
    """The res^2 primary rays plus n_bounce rays leaving random primary
    hits in random directions of the side the camera sees (numpy seed)."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
    from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays

    o, d = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, res, res)
    o = o.contiguous()
    h = ch.trace_plain(geom.feats, o, d)
    hits = torch.nonzero(h.hit).squeeze(1).cpu().numpy()
    check(hits.size > 0, "no primary ray hits the scene")
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.choice(hits, n_bounce), device=dev)
    bd = torch.as_tensor(rng.normal(size=(n_bounce, 3)).astype(np.float32), device=dev)
    bd = torch.nn.functional.normalize(bd, dim=-1)
    n = geom.n[h.tri[pick]]
    side = -torch.sign(torch.sum(d[pick] * n, dim=-1, keepdim=True))
    bd = torch.where(torch.sum(bd * n, dim=-1, keepdim=True) * side < 0, -bd, bd)
    bo = o[pick] + d[pick] * h.t[pick, None]
    return torch.cat([o, bo]).contiguous(), torch.cat([d, bd]).contiguous()


def phase_kernel_vs_plain(role, dev, logs: dict):
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    g, _, _, c = role["make"](dev)
    nb = g.feats.block_bounds.shape[0]
    check(nb == role["blocks"], f"{role['name']}: {nb} blocks, want {role['blocks']}")
    o, d = role_rays(g, c, dev, seed=nb)
    order = ch.coherent_order(o, d)
    o, d = o[order].contiguous(), d[order].contiguous()
    n = o.shape[0]

    t, tri = ch.trace_resident(g.feats, o, d)
    torch.cuda.synchronize()
    ref = ch.trace_plain(g.feats, o, d)
    torch.cuda.synchronize()
    hit = t < ch.MISS_T
    same = tri.to(torch.int64) == ref.tri
    tri_frac = float(same.float().mean())
    hit_frac = float((hit == ref.hit).float().mean())
    err = (t - ref.t).abs()[same]
    bad_t = int((err > 1e-4 * torch.clamp(ref.t[same], min=1.0)).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"[phase 2] {role['name']} ({g.feats.num_tris} tris, {nb} blocks, {n} rays): "
        f"tri forks {1 - tri_frac:.6f}, hit forks {1 - hit_frac:.6f}, "
        f"t out of tolerance {bad_t}, max |dt| {max_err:.3e}, hit share {float(hit.float().mean()):.4f}")
    check(tri_frac >= 0.999, f"{role['name']}: tri agrees on {tri_frac:.6f} < 0.999")
    check(hit_frac >= 0.999, f"{role['name']}: hit agrees on {hit_frac:.6f} < 0.999")
    check(bad_t == 0, f"{role['name']}: {bad_t} rays with |dt| > 1e-4 max(1, t)")

    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    ch.trace_resident(g.feats, o, d, stats=stats)
    pairs, stagings = (int(x) for x in stats.cpu())
    ms = tree_ms(lambda: ch.trace_resident(g.feats, o, d), iters=role["iters"])
    plain_ms = cuda_ms(lambda: ch.trace_plain(g.feats, o, d), iters=2)
    tp = g.feats.edges.shape[-1]
    needed = needed_pairs(g.feats, o, d, ref.t)
    nbytes = n * (24 + 8) + 4 * 25 * tp + 32 * nb
    # the bound counts the pairs the closest hit needs (as phases 8-10 do); the
    # bound from the pairs this kernel chose to test, and its slab tests, beside it
    bound_ms, bound_by = bound(needed * FLOPS_PER_PAIR, nbytes)
    tested_bound_ms = bound(pairs * FLOPS_PER_PAIR + n * nb * FLOPS_PER_SLAB
                            + stagings * RAYS_PER_CTA * FLOPS_PER_SLAB, nbytes)[0]
    kernel = "resident_hit_kernel"
    regs = ptxas(logs["closest_hit"], kernel)
    log(f"[phase 2] {role['name']}: {kernel} {ms:.4f} ms (ptxas {regs}), plain {plain_ms:.3f} ms, "
        f"pairs tested {pairs} ({pairs / n:.1f} per ray, {pairs / (n * tp):.4f} of all), "
        f"needed {needed} ({needed / n:.1f} per ray), block stagings {stagings}, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({needed * FLOPS_PER_PAIR:.3e} FP32 ops on the needed "
        f"pairs, {nbytes} bytes); from the pairs tested and slab tests {tested_bound_ms:.4f} ms")
    return dict(
        name=role["name"], route="cuda",
        source="ensem3a_openclraytracer_tpu_torch/csrc/closest_hit.cu",
        replaces=role["replaces"], launches=0, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        rays=n, pairs_tested=pairs, pairs_needed=needed, bound_tested_ms=tested_bound_ms,
        tri_fork_fraction=1 - tri_frac, hit_fork_fraction=1 - hit_frac, kernel=kernel,
        block_stagings=stagings, ptxas=regs,
    )


def bench_config(name: str) -> dict:
    """The benchmark's configuration ``port_bench/configs/<name>.json``."""
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())


def load_scene(scn, dev, workdir: Path):
    """Write the scene's ``.obj`` + ``.ini`` at its render settings (a
    benchmark configuration's, ``scn["config"]``, as its cells write it with
    the seed 0) and load it back with ``Scene.load`` on the card."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    res, spp, mb = scn["render"]
    obj = workdir / f"{scn['scene']}.obj"
    if "config" in scn:
        from port_bench.scenes import files

        obj = Path(files.write_scene(scn["config"], 0, str(workdir), dev))
    elif not obj.exists():
        g, m, e, c = scn["make"]("cpu")
        tt.write_scene_files(str(obj), g, m, e, c, resolution=res, spp=spp, max_bounce=mb)
    t0 = time.perf_counter()
    scene = Scene.load(str(obj), device=dev)
    return scene, time.perf_counter() - t0


def timed_render(scene, overrides: dict, seed: int = 0):
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_scene(scene, seed=seed, overrides=overrides)
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0


def first_render(scene, overrides: dict, label: str, smi: str) -> tuple:
    """The first ``render_scene`` of a loaded scene at its settings: the call
    that renders eagerly (the warm-up) and captures its graph
    (``render_radiance_jit``), with the launch counts set to 0 just before
    it and read just after it: the wrappers count the warm-up's launches,
    the capture runs none.  Its wall and the capture's parts on a line of
    their own; ``(wall, launches)``."""
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance_jit

    graph = render_radiance_jit.graph
    captures = graph.captures
    reset_launches()
    _, first_s = timed_render(scene, overrides, seed=1)
    launches = read_launches()
    check(graph.captures == captures + 1, f"{label}: the first render_scene captured "
          f"{graph.captures - captures} graphs, want 1")
    cap = graph.last_capture
    recorded = {k: v for k, v in launches.items() if v}
    check(cap["launches"] == recorded, f"{label}: the graph recorded {cap['launches']}, the "
          f"warm-up launched {recorded}")
    log(f"{label}: first render_scene call {first_s:.3f} s: warm-up {cap['warm_up_s']:.3f} s, "
        f"graph capture {cap['capture_s']:.3f} s, instantiation {cap['instantiate_s']:.3f} s, "
        f"pool {cap['pool_bytes'] / 1e6:.1f} MB; warm-up launches {recorded} [{smi}]")
    return first_s, launches


def replayed(scene, overrides: dict, label: str):
    """A later ``render_scene``, a replay of the captured graph: it runs no
    wrapper, so the launch counts stay at 0.  ``(image, wall)``."""
    reset_launches()
    img, dt = timed_render(scene, overrides)
    counted = {k: v for k, v in read_launches().items() if v}
    check(not counted, f"{label}: a replay counted launches {counted}")
    return img, dt


def phase_main_path(scn, dev, workdir: Path, smi: str):
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import fused_by_default
    from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import resident

    res, spp, mb = scn["render"]
    scene, load_s = load_scene(scn, dev, workdir)
    nb = scene.geometry.feats.block_bounds.shape[0]
    sun = float(scene.env_params().sun_power) != 0.0
    check(sun == scn["sun"], f"{scn['scene']}: sun_enabled {sun}")
    fused = fused_by_default(scene.geometry, dev)
    check(fused, f"{scn['scene']}: {nb} blocks, the default engine is not the fused one")
    ov = dict(scn.get("overrides", {}))
    # the main path: the scene's first render_scene, which launches every kernel
    # through its wrapper (then captures); later renders replay the graph
    first_s, launches = first_render(scene, ov, f"[phase 3] {scn['name']}", smi)
    img, dt = replayed(scene, ov, f"[phase 3] {scn['name']}")

    # the primary trace of a multi-block scene goes through the pairs kernel,
    # of a one-block scene through closest_hit; the samples of a multi-block
    # scene through fused_queue (once per sample), of a one-block scene through
    # fused_sample (once per render)
    queue = not resident(scene.geometry.feats)
    hit_kernel = "pairs" if queue else "closest_hit"
    expected = {hit_kernel: 1, "sample_fused_queue" if queue else "sample_fused": spp if queue else 1}
    expected = {"closest_hit": 0, "pairs": 0, "sample_fused": 0, "sample_fused_queue": 0,
                "uniforms": 0, "grouped_pairs": 0, "pair_compact": 0, "bvh_trace": 0,
                **expected}  # the prototypes are off the render path; features packs, no tree
    mean = float(img.mean())
    check(tuple(img.shape) == (res, res, 3), f"{scn['name']}: image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{scn['name']}: non-finite pixels")
    check(0.0 < mean <= 1.0, f"{scn['name']}: image mean {mean}")
    check(launches == expected, f"{scn['name']}: launches {launches}, want {expected}")
    rays = res * res * (1 + spp * (mb + 1) * (2 if sun else 1))  # counted as bench.py counts
    log(f"[phase 3] {scn['name']} ({scene.num_tris} tris, {nb} blocks) {res}^2 {spp} spp {mb} "
        f"bounces sun={sun} engine=fused: load {load_s:.2f} s, replayed render "
        f"{dt:.3f} s, {rays / dt / 1e6:.1f} Mrays/s, mean {mean:.4f}, launches {launches} "
        f"[{smi}]")
    info = dict(name=scn["name"], res=res, spp=spp, max_bounce=mb, sun=sun, blocks=nb,
                engine="fused", seconds=dt, mrays_per_s=rays / dt / 1e6,
                launches=launches, mean=mean, first_call_s=first_s)
    info.update(phase_profile(scene, scn["name"], ov, want=expected))
    return scene, info


# the port's kernels in a profile, by the kernel-name substrings of each
# group: the one-block closest hit, the block-queue closest hit, the
# one-block fused kernels (a whole render; one sample: both count as
# launches of sample_fused, and their times stand apart here), the
# multi-block fused kernel, the RNG, the tree walk
KERNEL_GROUPS = {
    "closest_hit": ("resident_hit_kernel",),
    "pairs": ("::pairs_kernel",),
    "fused_render": ("fused_render_kernel",),
    "fused_sample": ("fused_sample_kernel",),
    "fused_queue": ("fused_queue",),
    "uniforms": ("uniforms",),
    "bvh_trace": ("bvh_trace_kernel",),
}


def union_length(spans) -> float:
    """The length of the union of ``(start, end)`` spans: a device's busy
    time from its kernels' spans."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(scene, name: str, overrides: dict, phase: str = "3",
                  want: dict = None) -> dict:
    """Where the time goes in one more render of the scene (a replay of its
    graph), traced with torch.profiler: device time of each of the port's
    kernels and of the other kernels, and the device's idle share of the
    traced window.  The port's kernels in the trace, by counter, must equal
    ``want`` (the warm-up's launches)."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene

    with launch_registry().trace() as prof:
        t0 = time.perf_counter()
        render_scene(scene, seed=2, overrides=overrides)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = ev.time_range.start, ev.time_range.elapsed_us()
        spans.append((start, start + dur))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + dur
    if not spans:
        log(f"[phase {phase}] {name}: profiler saw no device time: breakdown not measured")
        return dict(profile="not measured")
    traced = traced_launches(prof)
    check(want is None or traced == want, f"[phase {phase}] {name}: the profiled replay ran "
          f"{traced}, the warm-up launched {want}")
    busy = union_length(spans)
    total_us = sum(by_name.values())
    ours = lambda k, subs: any(x in k for x in subs)
    group_us = {g: sum(v for k, v in by_name.items() if ours(k, subs))
                for g, subs in KERNEL_GROUPS.items()}
    other_us = total_us - sum(group_us.values())
    top = sorted(((v, k) for k, v in by_name.items()
                  if not any(ours(k, subs) for subs in KERNEL_GROUPS.values())), reverse=True)[:4]
    log(f"[phase {phase}] {name} profiled render: wall {wall_us / 1e3:.1f} ms (profiler on), device "
        f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}; "
        + ", ".join(f"{g} {v / 1e3:.1f} ms = {v / total_us:.3f}" for g, v in group_us.items())
        + f" of device time; other kernels {other_us / 1e3:.1f} ms, largest: "
        + "; ".join(f"{k[:60]} {v / 1e3:.1f} ms" for v, k in top))
    log(f"[phase {phase}] {name} profiled replay ran the port's kernels {traced}")
    out = dict(profile_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               idle_share=1 - busy / wall_us, other_kernels_ms=other_us / 1e3,
               replay_launches=traced)
    for g, v in group_us.items():
        out[f"{g}_ms"] = v / 1e3
        out[f"{g}_share"] = v / total_us
    hit_us = group_us["closest_hit"] + group_us["pairs"] + group_us["bvh_trace"]
    out["closest_hit_all_share"] = hit_us / total_us  # every closest-hit kernel
    log(f"[phase {phase}] {name}: closest-hit kernels {hit_us / 1e3:.1f} ms = {hit_us / total_us:.3f} "
        "of device time")
    return out


def phase_same_stream(role, dev):
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance

    res, spp, mb = SMOKE_TRIES
    g, m, e, c = role["make"](dev)
    rng = np.random.default_rng(11)
    u = torch.as_tensor(rng.random(size=(spp, mb + 1, res * res, 2), dtype=np.float64)
                        .astype(np.float32), device=dev)
    kw = dict(height=res, width=res, spp=spp, max_bounce=mb, sun_enabled=role["sun"], uniforms=u)
    before = read_launches()
    img_k = render_radiance(g, m, e, c, engine="kernel", **kw)
    after = read_launches()
    check(after["closest_hit"] + after["pairs"] > before["closest_hit"] + before["pairs"],
          f"{role['scene']}: kernel path made no closest-hit launch")
    img_p = render_radiance(g, m, e, c, engine="plain", **kw)
    torch.cuda.synchronize()
    diff = (img_k - img_p).abs().amax(dim=-1)
    frac = float((diff > 1e-3).float().mean())
    log(f"[phase 4] {role['scene']}: kernel vs plain pixel forks {frac:.5f}, "
        f"max diff {float(diff.max()):.3e}")
    check(bool(torch.isfinite(img_k).all()), f"{role['scene']}: non-finite pixels")
    check(frac < 0.02, f"{role['scene']}: pixel forks {frac:.5f} >= 0.02")


def fused_inputs(g, m, e, c, res: int):
    """The fused engine's per-sample arguments for ``res^2`` camera rays,
    from the engine's own ``fused_args`` (Morton order of the primary hits
    on multi-block scenes)."""
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import _gather_surface
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays

    o, d = camera_rays(c.position, c.rotation_deg, c.fov_deg, res, res)
    h = ch.trace(g, o, d)
    return fu.fused_args(g, m, e, o, d, h, _gather_surface(g, m, o, d, h))[0]


def fused_image(outs, e):
    """Mean over samples of ``rad + esc_thr * ibl(esc_dir)`` (the IBL
    outside the kernel, as the estimator adds it)."""
    from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl

    return sum(o[0] + o[1] * sample_ibl(e.ibl, o[2]) * e.ibl_power for o in outs) / len(outs)


def check_record(role, args, mb, seed, shape):
    """Record mode, kernel (through ``sample_fused``) against plain on the
    kernel's own stream: the recorded uniforms equal, ``tri`` and
    ``sun_tri`` agreeing on >= 99.5 %."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg

    key = rg.key_from_generator(torch.Generator(device=args[2].device).manual_seed(seed),
                                args[2].device)
    kw = dict(max_bounce=mb, sun_enabled=role["sun"], record=True)
    rp = fu.sample_fused_plain(*args, key, 1, **kw)
    rk = fu.sample_fused(*args, key, 1, **kw)
    agree = [float((a == b).float().mean()) for a, b in zip(rk[4:], rp[4:])]
    log(f"[phase 5] {role['name']} record mode at {shape}: u equal "
        f"{bool(torch.equal(rk[3], rp[3]))}, tri agrees {agree[0]:.5f}, sun_tri agrees "
        f"{agree[1]:.5f}")
    check(torch.equal(rk[3], rp[3]), f"{role['name']}: recorded uniforms differ at {shape}")
    check(min(agree) >= 0.995, f"{role['name']}: record agreement {agree} < 0.995 at {shape}")


class NeededPairs:
    """A ``traces`` list for ``sample_fused_plain`` that keeps only the
    pairs each logged trace needs (``needed_pairs``), so a whole render's
    traces need not stay in memory."""

    def __init__(self, feats):
        self.feats, self.pairs, self.loops, self.rays = feats, 0, 0, 0

    def append(self, trace):
        o, d, h = trace
        self.pairs += needed_pairs(self.feats, o, d, h.t)
        self.loops += 1
        self.rays += o.shape[0]


def fused_bytes(n, tp, nb, lights, out_per_ray):
    """Bytes a fused launch must move: the primary state read once (57 per
    lane), its outputs, the packed features and the attribute table, the
    block bounds and the light columns."""
    return (n * (57 + out_per_ray) + tp * (4 * 28 + 32) + 32 * nb
            + (56 * lights.area.shape[0] if lights is not None else 0))


def fused_flops(needed, lanes_samples, mb, sun, nee):
    """FP32 operations of fused samples: the needed pairs of their traces
    and the shading per lane, sample and bounce."""
    per_bounce = FUSED_FLOPS_PER_BOUNCE + FUSED_FLOPS_SUN * int(sun) + FUSED_FLOPS_NEE * int(nee)
    return needed * FLOPS_PER_PAIR + lanes_samples * (mb + 1) * per_bounce


def phase_fused_resident(role, dev, smi: str, logs: dict):
    """Phase 5 on a one-block role: the whole-render launch
    (``render_fused_resident``) and the one-sample launch against their plain
    versions at a small shape on explicit uniforms, then at the main path's
    shape on the kernel's own stream against ``render_fused_plain`` and
    against one launch per sample with the IBL and the sum on the host, with
    times, bound, registers, grid and waves.  Returns the role's
    ``kernels`` line."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg
    from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    res, spp, mb = SMOKE_TRIES
    g, m, e, c = role["make"](dev)
    nb = g.feats.block_bounds.shape[0]
    check(nb == 1, f"{role['name']}: {nb} blocks, want 1")
    nee = role.get("nee", False)
    lights = build_light_pack(g, m) if nee else None
    n_u = 5 if nee else 2
    ibl = dict(ibl=e.ibl, ibl_power=e.ibl_power)
    args = fused_inputs(g, m, e, c, res)
    n = args[2].shape[0]
    rng = np.random.default_rng(11 + 5 * int(nee))
    u = torch.as_tensor(rng.random((spp, mb + 1, n, n_u)).astype(np.float32), device=dev)
    kw = dict(max_bounce=mb, sun_enabled=role["sun"], nee=nee, lights=lights)
    render_k = fu.render_fused_resident(*args, None, 0, spp, uniforms=u, **ibl, **kw) / spp
    render_p = fu.render_fused_plain(*args, None, 0, spp, uniforms=u, **ibl, **kw) / spp
    sample_k = fused_image([fu.sample_fused(*args, uniforms=u[s], **kw) for s in range(spp)], e)
    sample_p = fused_image([fu.sample_fused_plain(*args, uniforms=u[s], **kw)
                            for s in range(spp)], e)
    torch.cuda.synchronize()
    frac, med, max_err = image_forks(render_k, render_p)
    frac_s, med_s, max_s = image_forks(sample_k, sample_p)
    log(f"[phase 5] {role['name']} (1 block) {res}^2 {spp} spp {mb} bounces, explicit uniforms: "
        f"whole-render launch vs render_fused_plain pixel forks {frac:.5f}, median diff "
        f"{med:.3e}, max diff {max_err:.3e}; one-sample launches vs sample_fused_plain forks "
        f"{frac_s:.5f}, median {med_s:.3e}, max {max_s:.3e}")
    for name, img, f_, m_ in (("render", render_k, frac, med), ("sample", sample_k, frac_s, med_s)):
        check(bool(torch.isfinite(img).all()), f"{role['name']}: non-finite {name} pixels")
        check(f_ < 0.02, f"{role['name']}: {name} pixel forks {f_:.5f} >= 0.02")
        check(m_ < 1e-5, f"{role['name']}: {name} median diff {m_:.3e} >= 1e-5")
    if role.get("record"):
        check_record(role, args, mb, 4, f"{res}^2")

    # the main path's shape and stream: 512^2 rays, 4 bounces, the render's
    # 64 samples on the kernel's own Philox stream
    (res_t, mb_t), spp_t = MAIN_SHAPE, MAIN_SPP
    args = fused_inputs(g, m, e, c, res_t)
    n = args[2].shape[0]
    key = rg.key_from_generator(torch.Generator(device=dev).manual_seed(3), dev)
    kw = dict(max_bounce=mb_t, sun_enabled=role["sun"], nee=nee, lights=lights)
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    out_k = fu.render_fused_resident(*args, key, 0, spp_t, stats=stats, **ibl, **kw) / spp_t
    pairs, stagings, _, slabs, _ = (int(x) for x in stats.cpu())
    traces = NeededPairs(g.feats)
    out_p, plain_ms = timed_once(lambda: fu.render_fused_plain(
        *args, key, 0, spp_t, traces=traces, **ibl, **kw))
    out_p = out_p / spp_t

    def per_sample_path():
        acc = torch.zeros((n, 3), device=dev)
        for s in range(spp_t):
            rad, esc_thr, esc_dir = fu.sample_fused_blocks(*args, key, s, **kw)
            acc = acc + rad + esc_thr * (sample_ibl(e.ibl, esc_dir) * e.ibl_power)
        return acc

    out_s = per_sample_path() / spp_t
    torch.cuda.synchronize()
    frac_t, med_t, max_t = image_forks(out_k, out_p)
    forks_s = int(((out_k - out_s).abs().amax(dim=-1) > 1e-3).sum())
    max_s = float((out_k - out_s).abs().max())
    log(f"[phase 5] {role['name']} at {res_t}^2, {mb_t} bounces, {spp_t} samples, own stream: "
        f"whole-render launch vs render_fused_plain pixel forks {frac_t:.5f}, median diff "
        f"{med_t:.3e}, max diff {max_t:.3e}; vs {spp_t} one-sample launches + host IBL and sum: "
        f"{forks_s} pixel forks at 1e-3, max diff {max_s:.3e}")
    check(bool(torch.isfinite(out_k).all()), f"{role['name']}: non-finite outputs at {res_t}^2")
    check(frac_t < 0.02, f"{role['name']}: pixel forks {frac_t:.5f} >= 0.02 at {res_t}^2")
    check(med_t < 1e-5, f"{role['name']}: median diff {med_t:.3e} >= 1e-5 at {res_t}^2")
    check(forks_s == 0, f"{role['name']}: {forks_s} pixel forks against the per-sample launches")
    if role.get("record"):
        check_record(role, args, mb_t, 6, f"{res_t}^2")

    ms = cuda_ms(lambda: fu.render_fused_resident(*args, key, 0, spp_t, **ibl, **kw),
                 iters=role["iters"])
    sample_ms = cuda_ms(lambda: fu.sample_fused_blocks(*args, key, 0, **kw), iters=role["iters"])
    path_ms = cuda_ms(per_sample_path, iters=2)
    plan = fu.render_plan(n, spp_t)
    regs = {k: ptxas(logs["fused_sample"], k) for k in ("fused_render_kernel", "fused_sample_kernel")}
    waves = plan["grid"] / (plan["blocks_per_sm"] * plan["sms"])
    flops = fused_flops(traces.pairs, n * spp_t, mb_t, role["sun"], nee)
    nbytes = fused_bytes(n, g.feats.edges.shape[-1], nb, lights, 12) + e.ibl.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[phase 5] {role['name']} at {res_t}^2, {mb_t} bounces, {spp_t} samples: fused_sample "
        f"whole-render launch {ms:.4f} ms per render = {ms / spp_t:.4f} ms per sample; one-sample "
        f"launch {sample_ms:.4f} ms; per-sample path ({spp_t} launches + host IBL and sum) "
        f"{path_ms:.4f} ms; plain {plain_ms:.1f} ms; {traces.loops} trace loops, {traces.rays} rays "
        f"traced; pairs tested {pairs} ({pairs / (n * spp_t):.1f} per lane and sample), needed "
        f"{traces.pairs} (tested / needed {pairs / max(traces.pairs, 1):.4f}), slab tests {slabs}, "
        f"block stagings {stagings}; bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FP32 ops, "
        f"{nbytes} bytes); {traces.pairs * FLOPS_PER_PAIR / ms / 1e9:.2f} TFLOP/s on the needed "
        f"pairs; plan {plan} ({waves:.2f} resident waves, {plan['items'] / plan['grid']:.1f} items "
        f"per CUDA block); ptxas {regs} [{smi}]")
    return dict(
        name=role["name"], route="cuda",
        source="ensem3a_openclraytracer_tpu_torch/csrc/fused_sample.cu",
        replaces="ensem3a_openclraytracer_tpu/ops/fused.py:125", launches=0,
        max_abs_err=max(max_err, max_t), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, unit="one render of 64 samples", samples=spp_t,
        ms_per_sample=ms / spp_t, bound_ms_per_sample=bound_ms / spp_t, sample_launch_ms=sample_ms,
        per_sample_path_ms=path_ms, rays=n, pairs_tested=pairs, pairs_needed=traces.pairs,
        slab_tests=slabs, block_stagings=stagings, plan=plan, waves=waves, ptxas=regs,
        pixel_fork_fraction=frac, pixel_fork_fraction_main_shape=frac_t,
        sample_pixel_fork_fraction=frac_s, forks_vs_per_sample_launches=forks_s,
    )


def phase_fused_queue(role, dev, smi: str):
    """Phase 5 on a multi-block role: the queue kernel against its plain
    version on one explicit stream at a small shape, then at the main path's
    shape on the kernel's own stream, with its time and bound, its counts
    against the plain version's, a sample under
    ``set_sync_debug_mode("error")``, its grid, and a sample with nothing
    to trace.  Returns the role's ``kernels`` line."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg
    from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import resident
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    res, spp, mb = SMOKE_TRIES
    g, m, e, c = role["make"](dev)
    nb = g.feats.block_bounds.shape[0]
    check(nb == role["blocks"], f"{role['name']}: {nb} blocks, want {role['blocks']}")
    check(not resident(g.feats), f"{role['name']}: {nb} blocks do not take the queue kernel")
    nee = role.get("nee", False)
    lights = build_light_pack(g, m) if nee else None
    args = fused_inputs(g, m, e, c, res)
    n = args[2].shape[0]
    n_u = 5 if nee else 2
    rng = np.random.default_rng(nb + 5 * int(nee))
    u = torch.as_tensor(rng.random((spp, mb + 1, n, n_u)).astype(np.float32), device=dev)
    kw = dict(max_bounce=mb, sun_enabled=role["sun"], nee=nee, lights=lights)
    img_k = fused_image([fu.sample_fused(*args, uniforms=u[s], **kw) for s in range(spp)], e)
    img_p = fused_image([fu.sample_fused_plain(*args, uniforms=u[s], **kw) for s in range(spp)], e)
    torch.cuda.synchronize()
    frac, med, max_err = image_forks(img_k, img_p)
    log(f"[phase 5] {role['name']} ({nb} blocks) {res}^2 {spp} spp {mb} bounces: kernel vs "
        f"plain pixel forks {frac:.5f}, median diff {med:.3e}, max diff {max_err:.3e}")
    check(bool(torch.isfinite(img_k).all()), f"{role['name']}: non-finite pixels")
    check(frac < 0.02, f"{role['name']}: pixel forks {frac:.5f} >= 0.02")
    check(med < 1e-5, f"{role['name']}: median diff {med:.3e} >= 1e-5")
    if role.get("record"):
        check_record(role, args, mb, 4, f"{res}^2")

    # the shape and stream of the role's render on the main path: its rays
    # (Morton-permuted), 4 bounces, the kernel's own Philox stream
    res_t, mb_t = role.get("res", MAIN_SHAPE[0]), MAIN_SHAPE[1]
    args = fused_inputs(g, m, e, c, res_t)
    n = args[2].shape[0]
    key = rg.key_from_generator(torch.Generator(device=dev).manual_seed(3), dev)
    kw = dict(max_bounce=mb_t, sun_enabled=role["sun"], nee=nee, lights=lights)
    fields = fu.queue_stats_fields(mb_t)
    stats = torch.zeros(len(fields), dtype=torch.int64, device=dev)
    out_k = fu.sample_fused(*args, key, 0, stats=stats, **kw)
    named = dict(zip(fields, (int(x) for x in stats.cpu())))
    pairs, stagings, rounds, slabs, syncs = (named[f] for f in fu.QUEUE_STATS[:5])
    traces = NeededPairs(g.feats)
    plain_stats = torch.zeros(len(fields), dtype=torch.int64, device=dev)
    out_p, plain_ms = timed_once(lambda: fu.sample_fused_plain(
        *args, key, 0, stats=plain_stats, traces=traces, **kw))
    plain_named = dict(zip(fields, (int(x) for x in plain_stats.cpu())))
    frac_t, med_t, max_t = image_forks(fused_image([out_k], e), fused_image([out_p], e))
    log(f"[phase 5] {role['name']} at {res_t}^2, {mb_t} bounces, own stream: kernel vs plain "
        f"pixel forks {frac_t:.5f}, median diff {med_t:.3e}, max diff {max_t:.3e}")
    check(all(bool(torch.isfinite(x).all()) for x in out_k),
          f"{role['name']}: non-finite outputs at {res_t}^2")
    check(frac_t < 0.02, f"{role['name']}: pixel forks {frac_t:.5f} >= 0.02 at {res_t}^2")
    check(med_t < 1e-5, f"{role['name']}: median diff {med_t:.3e} >= 1e-5 at {res_t}^2")
    # shading float order forks a few knife-edge rays, so the counts may differ a little
    counted = [f for f in fields if f not in ("syncs", "split_rounds", "items",
                                              "coop_select_rounds")
               and not f.endswith("cycles")]
    ks, ps = [named[f] for f in counted], [plain_named[f] for f in counted]
    gap = [abs(a - b) / max(b, 1) for a, b in zip(ks, ps)]
    log(f"[phase 5] {role['name']}: kernel counts ({', '.join(counted)}) {ks}, plain {ps}, "
        f"equal {ks == ps}, relative gaps {[round(x, 6) for x in gap]}; grid syncs {syncs}")
    check(max(gap) <= 0.01, f"{role['name']}: counts {ks} vs plain {ps} differ by more than 1 %")
    check(syncs > 0, f"{role['name']}: the kernel counted no grid syncs")
    lanes = [named[f"lanes.{b}"] for b in range(mb_t + 1)]
    check(sum(lanes) == named["segments"] and plain_named["segments"] == traces.rays,
          f"{role['name']}: segments {named['segments']}, lanes by bounce {lanes}; the plain "
          f"version counted {plain_named['segments']} and traced {traces.rays} rays")
    phases = [named[f] for f in fu.QUEUE_STATS[8:13]]
    check(0 < named["sync_cycles"] < named["kernel_cycles"] and min(phases) >= 0
          and sum(phases) > 0 and 0 < named["select_cycles"] < named["kernel_cycles"],
          f"{role['name']}: cycles {named}")
    check(named["stagings"] <= named["items"] <= pp.S_MAX * named["stagings"]
          and named["split_rounds"] <= rounds and named["coop_select_rounds"] <= rounds,
          f"{role['name']}: slices {named}")
    log(f"[phase 5] {role['name']}: grid-sync share {named['sync_cycles'] / named['kernel_cycles']:.4f} "
        f"and select share {named['select_cycles'] / named['kernel_cycles']:.4f} "
        f"of the CUDA blocks' cycles; rounds split into triangle slices {named['split_rounds']} of "
        f"{rounds}, work items {named['items']} for {stagings} stagings; rounds selecting with "
        f"a group of lanes a ray {named['coop_select_rounds']}; block 0's cycles by "
        f"phase (shade, bounce trace, resolve, sun trace, finish) "
        f"{[round(p / sum(phases), 4) for p in phases]}; pairs per segment "
        f"{pairs / max(named['segments'], 1):.2f}; lanes by bounce {lanes}")
    if nb > pp.AGG_BLOCKS:  # the groups take their slots from the global counts
        check(0 < named["coop_select_rounds"] < rounds,
              f"{role['name']}: {named['coop_select_rounds']} of {rounds} rounds grouped lanes")
    if nb > pp.SEL_BLOCKS:
        first_bounce_exact(role, args, key, nee, lights)
    if role.get("record"):
        check_record(role, args, mb_t, 6, f"{res_t}^2")
    ms = cuda_ms(lambda: fu.sample_fused(*args, key, 0, **kw), iters=role["iters"])
    flops = fused_flops(traces.pairs, n, mb_t, role["sun"], nee)
    nbytes = fused_bytes(n, g.feats.edges.shape[-1], nb, lights, 36)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[phase 5] {role['name']} at {res_t}^2, {mb_t} bounces: fused_queue kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms; {traces.loops} trace loops, {traces.rays} rays traced; pairs "
        f"tested {pairs} ({pairs / n:.1f} per lane), needed {traces.pairs} ({traces.pairs / n:.1f} "
        f"per lane, tested / needed {pairs / max(traces.pairs, 1):.4f}), slab tests {slabs}, block "
        f"stagings {stagings}, rounds {rounds}; bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} "
        f"FP32 ops, {nbytes} bytes); {traces.pairs * FLOPS_PER_PAIR / ms / 1e9:.2f} TFLOP/s on the "
        f"needed pairs [{smi}]")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fu.sample_fused(*args, key, 0, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    grid = fu.queue_grid()
    # a sample with nothing to trace (every lane dead): the launch's fixed cost, its lane
    # passes and the grid syncs around empty trace loops
    dead = args[:7] + (torch.zeros_like(args[7]),) + args[8:]
    estats = torch.zeros(len(fields), dtype=torch.int64, device=dev)
    fu.sample_fused(*dead, key, 0, stats=estats, **kw)
    empty_syncs = int(estats[fu.QUEUE_STATS.index("syncs")])
    empty_ms = cuda_ms(lambda: fu.sample_fused(*dead, key, 0, **kw), iters=role["iters"])
    log(f"[phase 5] {role['name']}: one sample under set_sync_debug_mode('error') passed; grid "
        f"{grid}; a sample with nothing to trace {empty_ms:.4f} ms ({empty_syncs} grid syncs "
        f"counted; the full sample counted {syncs}) [{smi}]")
    renders = [queue_render_vs_loop(role, g, m, e, c, dev, res_w, spp_w, smi)
               for res_w, spp_w in role.get("whole_render", ())]
    return dict(
        name=role["name"], route="cuda",
        source="ensem3a_openclraytracer_tpu_torch/csrc/fused_queue.cu",
        replaces="ensem3a_openclraytracer_tpu/ops/fused.py:125", launches=0,
        max_abs_err=max(max_err, max_t), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, unit="one sample", rays=n, pairs_tested=pairs,
        pairs_needed=traces.pairs, slab_tests=slabs, block_stagings=stagings, rounds=rounds,
        pixel_fork_fraction=frac, pixel_fork_fraction_main_shape=frac_t, grid=grid,
        empty_sample_ms=empty_ms, empty_sample_grid_syncs=empty_syncs, grid_syncs=syncs,
        segments=named["segments"], grid_sync_share=named["sync_cycles"] / named["kernel_cycles"],
        split_rounds=named["split_rounds"], work_items=named["items"],
        coop_select_rounds=named["coop_select_rounds"], whole_renders=renders,
    )


def first_bounce_exact(role, args, key, nee, lights):
    """Above ``SEL_BLOCKS`` the selects stage the block bounds in chunks:
    one bounce without sun is one trace of the bounce rays off the camera
    rays' hits, whose counts must equal the plain version's exactly, with
    some rounds but not all grouping lanes, so a pick that hung on the
    chunking or on the group would show."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu

    kw = dict(max_bounce=0, sun_enabled=False, nee=nee, lights=lights)
    fields = fu.queue_stats_fields(0)
    stats, plain_stats = (torch.zeros(len(fields), dtype=torch.int64, device=args[2].device)
                          for _ in range(2))
    out_k = fu.sample_fused(*args, key, 0, stats=stats, **kw)
    out_p = fu.sample_fused_plain(*args, key, 0, stats=plain_stats, **kw)
    named, plain = (dict(zip(fields, x.tolist())) for x in (stats, plain_stats))
    counted = fu.QUEUE_STATS[:4] + ("segments", "subtiles_offered", "subtiles_tested", "lanes.0")
    ks, ps = [named[f] for f in counted], [plain[f] for f in counted]
    equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    log(f"[phase 5] {role['name']} one bounce, no sun: kernel counts ({', '.join(counted)}) "
        f"{ks}, plain {ps}; rounds grouping lanes {named['coop_select_rounds']} of "
        f"{named['rounds']}; outputs bit-equal to plain {equal}")
    check(ks == ps, f"{role['name']}: one bounce, counts {ks} vs plain {ps}")
    check(0 < named["coop_select_rounds"] < named["rounds"],
          f"{role['name']}: one bounce, {named['coop_select_rounds']} of {named['rounds']} "
          f"rounds grouped lanes")


def device_kernels(prof) -> list:
    """The names of the device kernels in a torch.profiler trace, as the
    benchmark counts them: no copies, no memsets, no annotations."""
    import torch

    return [ev.name() for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation()
            and not ev.name().startswith(("Memcpy", "Memset"))]


def queue_render_vs_loop(role, g, m, e, c, dev, res: int, spp: int, smi: str) -> dict:
    """2b's whole render (``render_fused_queue``) at ``res^2``, ``spp``
    samples, 4 bounces, on the kernel's own stream, against the per-sample
    loop it replaced (``sample_fused_queue`` a sample, then the IBL lookup
    and the sum in PyTorch): pixel forks at 1e-3 (none allowed) and
    bit-equality, CUDA-event times of each (eager, median of 3), the device
    kernels a profiled run of each ran, and the escapes the render looked
    up."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg
    from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl

    args = fused_inputs(g, m, e, c, res)
    n, mb = args[2].shape[0], MAIN_SHAPE[1]
    key = rg.key_from_generator(torch.Generator(device=dev).manual_seed(13), dev)
    kw = dict(max_bounce=mb, sun_enabled=role["sun"])
    ibl = dict(ibl=e.ibl, ibl_power=e.ibl_power)

    def loop():
        acc = torch.zeros((n, 3), device=dev)
        for s in range(spp):
            rad, esc_thr, esc_dir = fu.sample_fused_queue(*args, key, s, **kw)
            acc = acc + rad + esc_thr * (sample_ibl(e.ibl, esc_dir) * e.ibl_power)
        return acc

    whole = lambda: fu.render_fused_queue(*args, key, 0, spp, **ibl, **kw)
    fields = fu.queue_stats_fields(mb)
    stats = torch.zeros(len(fields), dtype=torch.int64, device=dev)
    out = fu.render_fused_queue(*args, key, 0, spp, stats=stats, **ibl, **kw)
    ref = loop()
    torch.cuda.synchronize()
    forks = int(((out - ref).abs().amax(dim=-1) > 1e-3).sum())
    equal = bool(torch.equal(out, ref))
    max_diff = float((out - ref).abs().max())
    lookups = int(stats[fields.index("escape_lookups")])
    check(bool(torch.isfinite(out).all()) and float(out.mean()) > 0.0,
          f"{role['name']}: whole render at {res}^2 non-finite or black")
    check(forks == 0, f"{role['name']}: whole render at {res}^2, {spp} spp: {forks} pixel forks "
          f"against the per-sample loop")
    check(0 < lookups <= n * spp, f"{role['name']}: escape_lookups {lookups}")
    times = {}
    for name, fn in (("whole", whole), ("loop", loop)):
        times[name] = float(np.median([cuda_ms(fn, iters=1) for _ in range(3)]))
    kernels = {}
    for name, fn in (("whole", whole), ("loop", loop)):
        with launch_registry().trace() as prof:
            fn()
        kernels[name] = len(device_kernels(prof))
    check(kernels["whole"] <= spp + 2, f"{role['name']}: the whole render ran {kernels['whole']} "
          f"device kernels for {spp} samples")
    log(f"[phase 5] {role['name']} whole render at {res}^2, {spp} spp, {mb} bounces, own stream: "
        f"render_fused_queue {times['whole']:.3f} ms ({kernels['whole']} device kernels), "
        f"per-sample loop with the IBL and the sum in PyTorch {times['loop']:.3f} ms "
        f"({kernels['loop']} device kernels), ratio {times['loop'] / times['whole']:.4f}; "
        f"{forks} pixel forks at 1e-3, bit-equal {equal}, max diff {max_diff:.3e}; escapes "
        f"looked up {lookups} ({lookups / (n * spp):.4f} of lanes x samples) [{smi}]")
    return dict(res=res, spp=spp, ms=times["whole"], loop_ms=times["loop"],
                kernels=kernels["whole"], loop_kernels=kernels["loop"], forks=forks,
                bit_equal=equal, max_diff=max_diff, escape_lookups=lookups)


def phase_stream_identity(roles, dev):
    """In-kernel Philox stream against the RNG kernel's stream fed in, at
    the main path's shape, and the RNG kernel against its plain version;
    returns the RNG kernel's line."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    mb, spp = MAIN_SHAPE[1], 2
    for role in roles:
        res = role.get("res", MAIN_SHAPE[0])
        g, m, e, c = role["make"](dev)
        nee = role.get("nee", False)
        args = fused_inputs(g, m, e, c, res)
        n = args[2].shape[0]
        key = rg.key_from_generator(torch.Generator(device=dev).manual_seed(8), dev)
        kw = dict(max_bounce=mb, sun_enabled=role["sun"], nee=nee,
                  lights=build_light_pack(g, m) if nee else None)
        fed_u = [rg.uniforms(key, (mb + 1, n, 5 if nee else 2), s) for s in range(spp)]
        own = fused_image([fu.sample_fused(*args, key, s, **kw) for s in range(spp)], e)
        fed = fused_image([fu.sample_fused(*args, uniforms=fed_u[s], **kw) for s in range(spp)], e)
        pairs = [("one-sample launches", own, fed)]
        if g.feats.block_bounds.shape[0] == 1:  # and the whole-render launch
            ibl = dict(ibl=e.ibl, ibl_power=e.ibl_power)
            pairs.append(("whole-render launch",
                          fu.render_fused_resident(*args, key, 0, spp, **ibl, **kw),
                          fu.render_fused_resident(*args, None, 0, spp,
                                                   uniforms=torch.stack(fed_u), **ibl, **kw)))
        for what, a, b in pairs:
            forks = int(((a - b).abs().amax(dim=-1) > 1e-3).sum())
            log(f"[phase 6] {role['name']} {what} at {res}^2, {mb} bounces, {spp} samples: "
                f"in-kernel stream vs RNG-kernel stream: {forks} pixel forks, bit-equal "
                f"{bool(torch.equal(a, b))}")
            check(forks == 0, f"{role['name']}: {forks} pixel forks between the two streams "
                  f"({what})")

    n = 1 << 24
    key = torch.tensor([0x2545F491, -0x61C88647], dtype=torch.int32, device=dev)
    k = rg.uniforms(key, (n,), 7)
    p = rg.uniforms_plain(key, (n,), 7)
    torch.cuda.synchronize()
    equal = bool(torch.equal(k, p))
    max_err = float((k - p).abs().max())
    ms = tree_ms(lambda: rg.uniforms(key, (n,), 7), iters=20)
    plain_ms = cuda_ms(lambda: rg.uniforms_plain(key, (n,), 7), iters=2)
    bound_ms, bound_by = bound(n / 4 * INT_OPS_PER_PHILOX, 4 * n + 8, PEAK_INT32)
    log(f"[phase 6] uniforms: {n} values bit-equal to plain {equal}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({n / 4 * INT_OPS_PER_PHILOX:.3e} int32 ops, {4 * n} bytes)")
    check(equal, "uniforms kernel differs from its plain version")
    return dict(name="uniforms", route="cuda", source="ensem3a_openclraytracer_tpu_torch/csrc/rng.cu",
                replaces="ensem3a_openclraytracer_tpu/ops/rng.py:34", launches=0,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, values=n)


def phase_fused_vs_scan(scn, scene):
    """The same scene and settings through both engines (measurement only:
    the dispatch rule does not move on it)."""
    import torch

    ov = dict(scn.get("overrides", {}))
    out = {}
    for order in ((True, False), (False, True)):  # fused, scan, scan, fused
        for fused in order:
            img, dt = timed_render(scene, {**ov, "fused": fused}, seed=0)
            out.setdefault(fused, []).append((dt, img))
    (tf_, img_f), (ts_, img_s) = min(out[True], key=lambda x: x[0]), min(out[False],
                                                                          key=lambda x: x[0])
    diff = (img_f - img_s).abs().amax(dim=-1)
    forks = float((diff > 1e-3).float().mean())
    mean_gap = float(img_f.mean() - img_s.mean())
    log(f"[phase 7] {scn['name']}: fused {[round(d, 4) for d, _ in out[True]]} s, scan "
        f"{[round(d, 4) for d, _ in out[False]]} s; images: pixel forks {forks:.4f}, "
        f"mean fused - scan {mean_gap:+.5f}")
    check(bool(torch.isfinite(img_f).all()), f"{scn['name']}: non-finite fused pixels")
    if scene.geometry.feats.block_bounds.shape[0] == 1:
        # no ray permutation on one block: both engines draw one stream per ray
        check(forks < 0.02, f"{scn['name']}: fused vs scan pixel forks {forks:.4f} >= 0.02")
    return dict(name=scn["name"], fused_s=[d for d, _ in out[True]],
                scan_s=[d for d, _ in out[False]], pixel_forks=forks, mean_gap=mean_gap)


PROTO_RAYS = 65536  # rays of the prototypes' own runs


def hold(label: str, t, tri, hit, ref):
    """Phase 2's bounds: ``tri`` and ``hit`` agree on >= 99.9 % of rays,
    ``|dt| <= 1e-4 max(1, t)`` where ``tri`` agrees.  Returns (tri fork
    fraction, hit fork fraction, max |dt| where tri agrees)."""
    import torch

    same = tri == ref.tri
    tri_frac = float(same.float().mean())
    hit_frac = float((hit == ref.hit).float().mean())
    err = (t - ref.t).abs()[same]
    bad_t = int((err > 1e-4 * torch.clamp(ref.t[same], min=1.0)).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"{label}: tri forks {1 - tri_frac:.6f}, hit forks {1 - hit_frac:.6f}, t out of "
        f"tolerance {bad_t}, max |dt| {max_err:.3e}")
    check(tri_frac >= 0.999, f"{label}: tri agrees on {tri_frac:.6f} < 0.999")
    check(hit_frac >= 0.999, f"{label}: hit agrees on {hit_frac:.6f} < 0.999")
    check(bad_t == 0, f"{label}: {bad_t} rays with |dt| > 1e-4 max(1, t)")
    return 1 - tri_frac, 1 - hit_frac, max_err


def needed_pairs(feats, o, d, t, chunk: int = 8192) -> int:
    """The (ray, triangle) pairs that a closest hit culled by triangle
    block needs on these rays: for each ray, every triangle of each block
    whose margined box it enters no farther than its closest hit ``t``
    (every block it enters, for a miss).  A search must test them all to
    prove its hit, whatever order it visits blocks in."""
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    nb = feats.block_bounds.shape[0]
    tile = feats.edges.shape[-1] // nb
    blocks = 0
    for i in range(0, o.shape[0], chunk):
        entry = ch.block_entries(feats.block_bounds, o[i:i + chunk], d[i:i + chunk])
        blocks += int((entry <= t[i:i + chunk, None]).sum())
    return blocks * tile


def proto_inputs(scn, dev, smi: str) -> dict:
    """The scene, the prototypes' rays, ``trace_plain`` on them, the pairs
    the closest hit needs on them (``needed_pairs``, which the bounds of
    phases 8-9 count), and the closest hit the prototypes are held
    against: ``ops/pairs.trace_pairs`` (what ``ops/closest_hit.trace`` runs
    on these scenes), held to phase 2's bounds against ``trace_plain``."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.experiments import common
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
    from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp

    g = scn["make"](dev)[0]
    nb = g.feats.block_bounds.shape[0]
    check(nb == scn["blocks"], f"{scn['name']}: {nb} blocks, want {scn['blocks']}")
    o, d = common.bounce_rays(g, PROTO_RAYS)
    ref, plain_ms = timed_once(lambda: ch.trace_plain(g.feats, o, d))
    needed = needed_pairs(g.feats, o, d, ref.t)
    pstats = torch.zeros(4, dtype=torch.int64, device=dev)
    h = pp.trace_pairs(g.feats, o, d, stats=pstats)
    forks = hold(f"[phase 8] {scn['name']} trace_pairs vs trace_plain", h.t, h.tri, h.hit, ref)
    pairs_ms = tree_ms(lambda: pp.trace_pairs(g.feats, o, d), iters=scn["iters"])
    p_pairs, p_stagings, p_rounds, _ = (int(x) for x in pstats.cpu())
    log(f"[phase 8] {scn['name']} ({g.feats.num_tris} tris, {nb} blocks, {PROTO_RAYS} rays as the "
        f"prototypes build them): trace_pairs {pairs_ms:.4f} ms, pairs tested "
        f"{p_pairs / PROTO_RAYS:.1f} per ray, {p_rounds} rounds, {p_stagings} block stagings; pairs "
        f"needed {needed} ({needed / PROTO_RAYS:.1f} per ray), trace_plain {plain_ms:.1f} ms [{smi}]")
    return dict(g=g, o=o, d=d, ref=ref, needed_pairs=needed, trace_plain_ms=plain_ms,
                pairs_ms=pairs_ms, pairs_pairs=p_pairs, pairs_rounds=p_rounds,
                pairs_tri_fork_fraction=forks[0])


def phase_grouped(scn, inp, dev, smi: str, logs: dict) -> dict:
    """Phase 8 on one scene: the grouped-pair trace once as a user calls
    it (launch counts 0 before, read after), its kernel against its plain
    version on the same schedule (phase 2's bounds, the rays that differ in
    any bit, the counts equal) and against ``trace_plain``, two launches
    bit-equal, its launch plan and ptxas report, then times (``tree_ms``)."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.experiments import proto_grouped as pg
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    g, o, d = inp["g"], inp["o"], inp["d"]
    n, tp, name = o.shape[0], g.feats.edges.shape[-1], scn["name"]
    reset_launches()
    t, tri, hit, sched_pairs = pg.trace_grouped(g.feats, o, d)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["grouped_pairs"] == 1 and sum(launches.values()) == 1,
          f"{name}: trace_grouped launches {launches}, want grouped_pairs once")
    sched = pg.build_schedule(g.feats, o, d)
    plain_stats = torch.zeros(2, dtype=torch.int64, device=dev)
    sorted_plain, plain_ms = timed_once(lambda: pg.grouped_pairs_plain(g.feats, sched, plain_stats))
    plain = ch.Hit(*pg.unsort(sched, *sorted_plain))
    forks = hold(f"[phase 8] {name} grouped kernel vs plain", t, tri, hit, plain)
    bits = int(((tri != plain.tri) | (hit != plain.hit)
                | (t.view(torch.int32) != plain.t.view(torch.int32))).sum())
    hold(f"[phase 8] {name} grouped kernel vs trace_plain", t, tri, hit, inp["ref"])
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    first = pg.grouped_pairs(g.feats, sched, stats=stats)
    second = pg.grouped_pairs(g.feats, sched)
    check(torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))
          and torch.equal(first[1], second[1]), f"{name}: two grouped_pairs launches differ")
    check(stats.tolist() == plain_stats.tolist(),
          f"{name}: kernel counts {stats.tolist()}, plain {plain_stats.tolist()}")
    pairs, stagings = (int(x) for x in stats.cpu())
    needed = inp["needed_pairs"]
    check(needed <= pairs <= 1.25 * needed,
          f"{name}: {pairs} pairs tested, needed {needed}: not within 1.25x")
    plan = pg.launch_plan(sched.rt, sched.offsets.numel() - 1)
    regs = ptxas(logs["grouped_pairs"], "grouped_pairs_kernel")
    ms = tree_ms(lambda: pg.grouped_pairs(g.feats, sched), iters=scn["iters"])
    schedule_ms = tree_ms(lambda: pg.build_schedule(g.feats, o, d), iters=scn["iters"])
    whole_ms = tree_ms(lambda: pg.trace_grouped(g.feats, o, d), iters=scn["iters"])
    tiles = sched.offsets.numel() - 1
    flops = needed * FLOPS_PER_PAIR  # the pairs the function needs, not those tested
    nbytes = n * (24 + 8) + 4 * 25 * tp + 8 * int(sched_pairs) + 4 * (tiles + 1)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[phase 8] {name} grouped: kernel {ms:.4f} ms (ptxas {regs}; grid {plan['grid']} CUDA "
        f"blocks of {plan['threads']} threads, {plan['smem_bytes']} bytes of shared memory each, "
        f"{plan['blocks_per_sm']} per SM), schedule {schedule_ms:.4f} ms, whole trace "
        f"{whole_ms:.4f} ms; trace_pairs {inp['pairs_ms']:.4f} ms; pairs per ray: grouped "
        f"{pairs / n:.1f} ({pairs / max(needed, 1):.4f} of needed), trace_pairs "
        f"{inp['pairs_pairs'] / n:.1f}, needed "
        f"{needed / n:.1f}; scheduled (tile, block) pairs {int(sched_pairs)} of "
        f"{tiles * g.feats.block_bounds.shape[0]}, block stagings {stagings} (counts equal to "
        f"plain's); rays differing from plain in any bit {bits}; plain {plain_ms:.1f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({flops:.3e} FP32 ops, {nbytes} bytes), "
        f"{flops / ms / 1e9:.2f} TFLOP/s on the needed pairs [{smi}]")
    return dict(
        name=f"trace_grouped:{name}", route="cuda",
        source="ensem3a_openclraytracer_tpu_torch/csrc/grouped_pairs.cu",
        replaces="experiments/proto_grouped.py:49", launches=launches["grouped_pairs"],
        max_abs_err=forks[2], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, rays=n, pairs_tested=pairs, pairs_per_ray=pairs / n,
        pairs_needed=needed, block_stagings=stagings, rays_differing_bits=bits,
        scheduled_pairs=int(sched_pairs), schedule_ms=schedule_ms, plan=plan, ptxas=regs,
        trace_ms=whole_ms, trace_pairs_ms=inp["pairs_ms"],
        trace_pairs_pairs_per_ray=inp["pairs_pairs"] / n, tri_fork_fraction=forks[0],
        hit_fork_fraction=forks[1],
    )


def compact_fold(feats, o, d, queues, fold) -> tuple:
    """``(best keys, [pairs tested, stagings])`` of ``fold`` (the kernel or
    its plain version) over recorded rounds, from no hit."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact as pc

    best = torch.full((o.shape[0] + 1,), pc.NO_HIT_KEY, dtype=torch.int64, device=o.device)
    stats = torch.zeros(2, dtype=torch.int64, device=o.device)
    for q in queues:
        fold(feats, o, d, q, best, stats)
    return best, stats


def phase_compact(scn, inp, dev, smi: str, logs: dict) -> dict:
    """Phase 9 on one scene: the pair-compaction trace once as a user
    calls it (launch counts 0 before, read after: one per round), then on
    the same rounds' queues the kernel's ``best_key`` after every round
    against its plain version's fold (phase 2's bounds, the rays that
    differ in any bit), the counts equal (stagings per sub-tile in both),
    two launches bit-equal, the result against ``trace_plain``, the launch
    plan and ptxas report, times (``tree_ms``: per round, per trace, the
    whole trace) and the per-piece profile of the first round."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact as pc
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    g, o, d = inp["g"], inp["o"], inp["d"]
    f = g.feats
    n, tp, name = o.shape[0], f.edges.shape[-1], scn["name"]
    queues = []
    reset_launches()
    t, tri, hit, rounds = pc.trace_compact(f, o, d, queues=queues)
    torch.cuda.synchronize()
    launches = read_launches()
    check(rounds > 0 and launches["pair_compact"] == rounds and sum(launches.values()) == rounds,
          f"{name}: trace_compact launches {launches}, want pair_compact once per round ({rounds})")
    best = torch.full((n + 1,), pc.NO_HIT_KEY, dtype=torch.int64, device=dev)
    plain = best.clone()
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    plain_stats = stats.clone()
    plain_ms, bits, forks = 0.0, [], (0.0, 0.0, 0.0)
    for i, q in enumerate(queues):
        pc.pair_compact(f, o, d, q, best, stats)
        plain_ms += timed_once(lambda: pc.pair_compact_plain(f, o, d, q, plain, plain_stats))[1]
        forks = hold(f"[phase 9] {name} round {i + 1}: kernel best_key vs plain fold",
                     *pc.key_hit(best[:n]), pc.key_hit(plain[:n]))
        bits.append(int((best[:n] != plain[:n]).sum()))
    check(stats.tolist() == plain_stats.tolist(),
          f"{name}: kernel counts {stats.tolist()}, plain {plain_stats.tolist()}")
    bit_equal(f"[phase 9] {name} the trace against its rounds refolded", ch.Hit(t, tri, hit),
              pc.key_hit(best[:n]))
    hold(f"[phase 9] {name} compact kernel vs trace_plain", t, tri, hit, inp["ref"])
    again = compact_fold(f, o, d, queues, pc.pair_compact)
    check(torch.equal(again[0], best) and again[1].tolist() == stats.tolist(),
          f"{name}: two pair_compact launches per round differ")
    pairs, stagings = (int(x) for x in stats.cpu())
    tiles = queues[0].tile_blk.numel()
    rt = queues[0].queue_rid.numel() // tiles
    plan = pc.launch_plan(rt, tiles)
    regs = ptxas(logs["pair_compact"], "pair_compact_kernel")
    scratch = best.clone()
    round_ms = [tree_ms(lambda q=q: pc.pair_compact(f, o, d, q, scratch), iters=scn["iters"])
                for q in queues]
    kernels_ms = tree_ms(lambda: [pc.pair_compact(f, o, d, q, scratch) for q in queues],
                         iters=scn["iters"])
    whole_ms = tree_ms(lambda: pc.trace_compact(f, o, d), iters=scn["iters"])
    live = [int(q.tile_live.sum()) for q in queues]
    real = [int((q.queue_rid < n).sum()) for q in queues]
    pieces = pc.profile(f, o, d, runs=3)
    needed = inp["needed_pairs"]
    flops = needed * FLOPS_PER_PAIR  # per trace: the pairs the function needs, not those tested
    # per launch, each input read once and each output written once: rays, packed
    # features, slots, tiles' block and live flag, best_key read and written
    nbytes = n * 24 + 4 * 28 * tp + 8 * rt * tiles + 8 * tiles + 16 * (n + 1)
    bound_ms, bound_by = bound(flops / rounds, nbytes)
    trace_bound_ms, _ = bound(flops, nbytes * rounds)
    log(f"[phase 9] {name} compact: {rounds} rounds, live tiles per round {live} of {tiles}, real "
        f"slots per round {real}; kernel with its fold {kernels_ms:.4f} ms per trace "
        f"({kernels_ms / rounds:.4f} per launch; per round {[round(x, 4) for x in round_ms]}), "
        f"whole trace {whole_ms:.4f} ms; ptxas {regs}; plan {plan['grid']} CUDA blocks of "
        f"{plan['threads']} threads, {plan['smem_bytes']} bytes of shared memory each, "
        f"{plan['blocks_per_sm']} per SM; trace_pairs {inp['pairs_ms']:.4f} ms; pairs per ray: "
        f"compact {pairs / n:.1f} ({pairs / max(needed, 1):.4f} of needed), trace_pairs "
        f"{inp['pairs_pairs'] / n:.1f}, needed "
        f"{needed / n:.1f}; block stagings {stagings} (counts equal to plain's); rays differing "
        f"from plain in any bit per round {bits}; plain {plain_ms:.1f} ms over the rounds; bound "
        f"per launch {bound_ms:.4f} ms by {bound_by} ({flops / rounds:.3e} FP32 ops, {nbytes} "
        f"bytes), per trace {trace_bound_ms:.4f} ms; {flops / kernels_ms / 1e9:.2f} TFLOP/s on "
        f"the needed pairs [{smi}]")
    log(f"[phase 9] {name} compact first round, per piece: slab+sort {pieces['pre_ms']:.4f} ms, "
        f"queue build {pieces['queue_ms']:.4f} ms, pair kernel with its fold "
        f"{pieces['kernel_ms']:.4f} ms; blocks entered per ray mean {pieces['counts_mean']:.2f}, "
        f"max {pieces['counts_max']}")
    return dict(
        name=f"trace_compact:{name}", route="cuda",
        source="ensem3a_openclraytracer_tpu_torch/csrc/pair_compact.cu",
        replaces="experiments/proto_compact.py:68", launches=launches["pair_compact"],
        max_abs_err=forks[2], ms=kernels_ms / rounds, plain_ms=plain_ms / rounds,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, rays=n, pairs_tested=pairs,
        pairs_per_ray=pairs / n, pairs_needed=needed, block_stagings=stagings,
        rounds=rounds, live_tiles=live, real_slots=real, tiles=tiles, round_ms=round_ms,
        kernel_ms_per_trace=kernels_ms, bound_ms_per_trace=trace_bound_ms,
        tflops_needed=flops / kernels_ms / 1e9, rays_differing_bits=bits, plan=plan, ptxas=regs,
        trace_ms=whole_ms, trace_pairs_ms=inp["pairs_ms"],
        trace_pairs_pairs_per_ray=inp["pairs_pairs"] / n, profile=pieces,
        tri_fork_fraction=forks[0], hit_fork_fraction=forks[1],
    )


def phase_pairs(role, dev, smi: str, proto: dict | None) -> dict:
    """Phase 10 on one role: ``ops/pairs.trace_pairs`` (the block-queue
    kernel that ``ops/closest_hit.trace`` runs on multi-block scenes) on
    ``role_rays`` as phase 2 builds them and on as many bounce rays as the
    role's render traces at once (res^2, leaving random primary hits): held
    against ``trace_plain`` at phase 2's bounds, its counts against its
    plain version's (on the first rays), one trace under
    ``torch.cuda.set_sync_debug_mode("error")``, its time, pairs tested
    against ``needed_pairs``, rounds, and a bound from the needed pairs.
    ``proto`` is phase 8's inputs on the role's scene, or None where the
    prototypes do not run; ``role["phase2_res"]`` (default 512) sets the
    primary rays of the first shape."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
    from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp

    g, _, _, c = role["make"](dev)
    feats, name = g.feats, role["name"]
    nb, tp = feats.block_bounds.shape[0], feats.edges.shape[-1]
    res = role["render_res"]
    o2, d2 = role_rays(g, c, dev, seed=nb, res=role.get("phase2_res", 512))
    ob, db = role_rays(g, c, dev, seed=nb + 1, res=res, n_bounce=res * res)
    shapes = {"phase2": (o2, d2), "render": (ob[res * res:].contiguous(), db[res * res:].contiguous())}
    grid = pp.kernel_grid()
    out = dict(name=f"pairs:{name.split(':')[1]}", route="cuda",
               source="ensem3a_openclraytracer_tpu_torch/csrc/pairs.cu", replaces=role["replaces"],
               launches=0, library_ms=None, k=pp.K, grid=grid)
    for label, (o, d) in shapes.items():
        n = o.shape[0]
        ref = ch.trace_plain(feats, o, d)
        stats = torch.zeros(4, dtype=torch.int64, device=dev)
        h = pp.trace_pairs(feats, o, d, stats=stats)
        torch.cuda.synchronize()
        forks = hold(f"[phase 10] {name} trace_pairs vs trace_plain, {label} shape ({n} rays)",
                     h.t, h.tri, h.hit, ref)
        again = pp.trace_pairs(feats, o, d)
        check(torch.equal(again.t, h.t) and torch.equal(again.tri, h.tri),
              f"{name}: two trace_pairs runs differ at the {label} shape")
        pairs, stagings, rounds, slabs = (int(x) for x in stats.cpu())
        needed = needed_pairs(feats, o, d, ref.t)
        ms = cuda_ms(lambda: pp.trace_pairs(feats, o, d), iters=role["iters"])
        nbytes = n * (24 + 4 + 8 + 1) + 4 * ch.PACKED_ROWS * tp + 32 * nb
        bound_ms, bound_by = bound(needed * FLOPS_PER_PAIR, nbytes)
        log(f"[phase 10] {name} {label} shape ({n} rays, {nb} blocks): trace_pairs {ms:.4f} ms; "
            f"pairs tested {pairs} ({pairs / n:.1f} per ray), needed "
            f"{needed} ({needed / n:.1f} per ray, tested / needed {pairs / max(needed, 1):.4f}); "
            f"{rounds} rounds, {stagings} block stagings, {slabs} slab tests ({slabs * FLOPS_PER_SLAB:.3e}"
            f" FP32 ops against {pairs * FLOPS_PER_PAIR:.3e} in pair tests); bound {bound_ms:.4f} ms by "
            f"{bound_by}; {needed * FLOPS_PER_PAIR / ms / 1e9:.2f} TFLOP/s on the needed pairs [{smi}]")
        shape = dict(rays=n, ms=ms, bound_ms=bound_ms, bound_by=bound_by, pairs_tested=pairs,
                     pairs_needed=needed, rounds=rounds, block_stagings=stagings,
                     slab_tests=slabs, tri_fork_fraction=forks[0], hit_fork_fraction=forks[1],
                     max_abs_err=forks[2])
        if label == "phase2":
            plain_stats = torch.zeros(4, dtype=torch.int64, device=dev)
            hp, plain_ms = timed_once(lambda: pp.trace_pairs_plain(feats, o, d, stats=plain_stats))
            hold(f"[phase 10] {name} trace_pairs vs its plain version", h.t, h.tri, h.hit, hp)
            check(torch.equal(stats, plain_stats),
                  f"{name}: kernel counts {stats.tolist()}, plain {plain_stats.tolist()}")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pp.trace_pairs(feats, o, d)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            log(f"[phase 10] {name}: counts equal to the plain version's {stats.tolist()}, plain "
                f"{plain_ms:.1f} ms; one trace under set_sync_debug_mode('error') passed; grid {grid}")
            out.update(shape, plain_ms=plain_ms)
        else:
            out["render_shape"] = shape
    if proto is not None:
        out["prototype_rays"] = dict(rays=PROTO_RAYS, ms=proto["pairs_ms"],
                                     pairs_per_ray=proto["pairs_pairs"] / PROTO_RAYS,
                                     needed_per_ray=proto["needed_pairs"] / PROTO_RAYS,
                                     rounds=proto["pairs_rounds"])
    return out


# ---------------------------------------------------------------------------
# Phase 11: the gradient path (models/replay.py, models/optimize.py)
# ---------------------------------------------------------------------------

GRAD_SHAPE = (512, 100, 4)  # bench.py's fwd+bwd shape: res, spp, bounces (Cornell, no sun)
TEXEL_SHAPE = (128, 4, 4)  # bench.py's texel-gradient shape (outdoor, 64 cubes, sun + IBL)
TEXEL_IBL = (4096, 8192)  # its default_sky
GRAD_TRIES = (64, 2, 3)  # card against CPU gradients: res, spp, bounces
# the trainer: the CLI's resolution cap (cli.py:253), 8 spp, 4 bounces
TRAIN = dict(res=128, spp=8, max_bounce=4, iters=12, every=4, stop=6, lr=5e-2)
# a profile's device kernels: the record launches, the port's other kernels
RECORD_SUBS = KERNEL_GROUPS["fused_render"] + KERNEL_GROUPS["fused_sample"] + KERNEL_GROUPS["fused_queue"]
OTHER_PORT_SUBS = KERNEL_GROUPS["closest_hit"] + KERNEL_GROUPS["pairs"] + KERNEL_GROUPS["uniforms"]


def no_launches(**want) -> dict:
    out = dict.fromkeys(read_launches(), 0)
    out.update(want)
    return out


def phase_records(role, dev, smi: str) -> dict:
    """11.1-11.2 on one role: the fused recorder at the training shape (its
    launches, time per sample, bytes), the replay of its records against
    the fused forward render at the same generator seed, and the record
    launch alone against its plain version.  Returns the ``kernels`` line."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import radiance_for_rays
    from ensem3a_openclraytracer_tpu_torch.models.replay import record_paths, replay_radiance
    from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
    from ensem3a_openclraytracer_tpu_torch.ops import rng as rg
    from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
    from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import resident

    name, (res, spp, mb), sun = role["name"], role["shape"], role["sun"]
    g, m, e, c = role["make"](dev)
    nb = g.feats.block_bounds.shape[0]
    o, d = camera_rays(c.position, c.rotation_deg, c.fov_deg, res, res)
    gen = lambda: torch.Generator(device=dev).manual_seed(role["seed"])
    key = rg.key_from_generator(gen(), dev)
    rec_kw = dict(spp=spp, max_bounce=mb, sun_enabled=sun)
    record_paths(g, m, e, o, d, key, **{**rec_kw, "spp": 1})  # warm-up
    one = resident(g.feats)
    kern = "sample_fused" if one else "sample_fused_queue"
    want = no_launches(**{"closest_hit" if one else "pairs": 1, kern: spp})
    reset_launches()
    rec, rec_ms = timed_once(lambda: record_paths(g, m, e, o, d, key, **rec_kw))
    launches = read_launches()
    check(launches == want, f"[phase 11] {name}: record launches {launches}, want {want}")
    rec_bytes = sum(x.numel() * x.element_size() for x in rec if x is not None)
    log(f"[phase 11] {name} ({nb} blocks) fused records at {res}^2, {spp} spp, {mb} bounces, "
        f"sun={sun}: {rec_ms:.1f} ms = {rec_ms / spp:.3f} ms per sample (scatter to pixel order "
        f"included), {rec_bytes / 1e9:.3f} GB of records, launches {launches} [{smi}]")

    with torch.no_grad():
        img_r = replay_radiance(rec, g, m, e, d, sun_enabled=sun)
        img_f = radiance_for_rays(g, m, e, o, d, gen(), spp=spp, max_bounce=mb, sun_enabled=sun)
    torch.cuda.synchronize()
    frac, med, max_img = image_forks(img_r, img_f)
    log(f"[phase 11] {name}: replay of the fused records vs render_radiance(fused=None) at the "
        f"same seed: pixel forks {frac:.5f}, median diff {med:.3e}, max diff {max_img:.3e}")
    check(bool(torch.isfinite(img_r).all()), f"{name}: non-finite replay pixels")
    check(frac < 0.02, f"{name}: replay pixel forks {frac:.5f} >= 0.02")
    check(med < 1e-5, f"{name}: replay median diff {med:.3e} >= 1e-5")
    del rec, img_r, img_f

    # the record launch alone (one sample on the engine's own arguments), kernel vs plain
    args = fused_inputs(g, m, e, c, res)
    n = args[2].shape[0]
    kw = dict(max_bounce=mb, sun_enabled=sun, record=True)
    rk = fu.sample_fused(*args, key, 1, **kw)
    traces = NeededPairs(g.feats)
    rp, plain_ms = timed_once(lambda: fu.sample_fused_plain(*args, key, 1, traces=traces, **kw))
    u_equal = bool(torch.equal(rk[3], rp[3]))
    agree = [float((a == b).float().mean()) for a, b in zip(rk[4:], rp[4:])]
    # float differences on the lanes whose records agree; a lane whose trace forked on a
    # knife edge (a different triangle) follows another path
    same = ((rk[4] == rp[4]) & (rk[5] == rp[5])).all(dim=0)
    forked = int((~same).sum())
    max_err = max(float((a - b)[same].abs().max()) for a, b in zip(rk[:3], rp[:3]))
    check(u_equal, f"{name}: recorded uniforms differ from plain")
    check(min(agree) >= 0.995, f"{name}: record agreement {agree} < 0.995")
    check(max_err < 1e-3, f"{name}: kernel vs plain max diff {max_err:.3e} on unforked lanes")
    ms = cuda_ms(lambda: fu.sample_fused(*args, key, 1, **kw), iters=role["iters"])
    out_per_ray = 36 + (mb + 1) * (8 + 4 + 4 * int(sun))  # rad, esc_thr, esc_dir; u, tri, sun_tri
    flops = fused_flops(traces.pairs, n, mb, sun, False)
    nbytes = fused_bytes(n, g.feats.edges.shape[-1], nb, None, out_per_ray)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"[phase 11] {name} record launch ({kern}) at {res}^2, {mb} bounces: {ms:.4f} ms per "
        f"sample, plain {plain_ms:.1f} ms; u equal {u_equal}, tri / sun_tri agree {agree}, "
        f"{forked} forked lanes, max diff (rad, esc) on the others {max_err:.3e}; "
        f"{traces.loops} trace loops, {traces.rays} rays traced, "
        f"needed pairs {traces.pairs}; bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FP32 "
        f"ops, {nbytes} bytes) [{smi}]")
    src = "fused_queue.cu" if kern == "sample_fused_queue" else "fused_sample.cu"
    return dict(
        name=f"sample_fused:record:{name}", route="cuda",
        source=f"ensem3a_openclraytracer_tpu_torch/csrc/{src}",
        replaces="ensem3a_openclraytracer_tpu/ops/fused.py:125", launches=launches[kern],
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, unit="one sample in record mode", rays=n, samples=spp,
        record_ms_per_sample=rec_ms / spp, record_bytes=rec_bytes, pairs_needed=traces.pairs,
        record_agreement=agree, forked_lanes=forked, replay_pixel_fork_fraction=frac,
        replay_median_diff=med,
    )


def phase_gather_backward(dev, smi: str) -> list:
    """The backward pass of a replay gather (a scatter-add of every lane's
    row gradient into the table) at the replay's shapes, with the lanes
    spread evenly or concentrated on a few rows (Zipf): ``gather_rows``'s
    (``ops/gathers.scatter_rows``) beside autograd's ``index_put_(accumulate=True)``, the embedding
    backward and ``index_add_``, each run three times on the same inputs between other
    allocations: its time, whether the results are bit-equal, and its
    largest difference from a float64 sum (relative to the largest entry).
    ``gather_rows``'s must be bit-equal."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops.gathers import scatter_rows

    rng = np.random.default_rng(51)
    shapes = (  # faces of Cornell, materials, an 8k sky, the IBL pass of one Cornell env group
        ("even", 262144, 36, 9), ("even", 262144, 6, 4), ("even", 262144, 4096 * 8192, 3),
        ("zipf", 262144, 36, 9), ("zipf", 8388608, 512, 3))
    methods = {
        "gather_rows": scatter_rows,
        "index_put": lambda g, i, r: torch.zeros((r, g.shape[1]), device=dev).index_put_(
            (i,), g, accumulate=True),
        "embedding": lambda g, i, r: torch.ops.aten.embedding_dense_backward(g, i, r, -1, False),
        "index_add": lambda g, i, r: torch.zeros((r, g.shape[1]), device=dev).index_add_(0, i, g),
    }
    out = []
    for spread, n, rows, cols in shapes:
        raw = rng.integers(0, rows, n) if spread == "even" else rng.zipf(1.5, n) - 1
        idx = torch.as_tensor(np.minimum(raw, rows - 1), device=dev)
        grad = torch.as_tensor(rng.standard_normal((n, cols)).astype(np.float32), device=dev)
        exact = torch.zeros((rows, cols), dtype=torch.float64, device=dev).index_add_(
            0, idx, grad.to(torch.float64))
        scale = max(float(exact.abs().max()), 1e-30)
        line = dict(spread=spread, lanes=n, rows=rows, cols=cols)
        for name, fn in methods.items():
            ref = fn(grad, idx, rows)
            same = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                junk = torch.empty(int(rng.integers(1, 1 << 22)), device=dev)  # move the allocator
                same &= bool(torch.equal(fn(grad, idx, rows), ref))
            torch.cuda.synchronize()
            del junk
            err = float((ref.to(torch.float64) - exact).abs().max()) / scale
            line[name] = dict(ms=(time.perf_counter() - t0) / 3 * 1e3, deterministic=same,
                              rel_err=err)
        log(f"[phase 11] gather backward, {n} lanes ({spread}) into [{rows}, {cols}]: "
            + "; ".join(f"{k} {v['ms']:.3f} ms, bit-equal {v['deterministic']}, error "
                        f"{v['rel_err']:.1e}" for k, v in line.items() if isinstance(v, dict))
            + f" [{smi}]")
        check(line["gather_rows"]["deterministic"], f"gather_rows backward is not deterministic at "
              f"{n} lanes into {rows} rows")
        check(line["gather_rows"]["rel_err"] < 1e-6, f"gather_rows backward error "
              f"{line['gather_rows']['rel_err']:.2e} at {n} lanes into {rows} rows")
        out.append(line)
    return out


def phase_grad_parity(case, dev, smi: str, phase: str = "11",
                      trace_kernels=("closest_hit", "pairs")) -> dict:
    """11.3 on one scene: the replay's gradients of ``mean(img^2)`` on the
    card (scan recorder on the kernels, explicit uniforms) against the same
    call on the CPU, and a chunked call (``spp_chunk=1``) against an
    unchunked one on the card.  ``trace_kernels``: the kernels that must
    have traced (phase 13 runs it on a tree-only pack)."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.replay import render_radiance_replay
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    res, spp, mb = GRAD_TRIES
    name, sun, nee = case["name"], case["sun"], case.get("nee", False)
    rng = np.random.default_rng(case["seed"])
    u = rng.random((spp, mb + 1, res * res, 2)).astype(np.float32)
    lu = rng.random((spp, mb + 1, res * res, 3)).astype(np.float32) if nee else None

    def grads(device, spp_chunk=None):
        g, m, e, c = case["make"](device)
        lights = build_light_pack(g, m) if nee else None
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (m.color, m.roughness, e.sun_power, e.ibl_power, e.ibl)]
        m2 = m._replace(color=leaves[0], roughness=leaves[1])
        e2 = e._replace(sun_power=leaves[2], ibl_power=leaves[3], ibl=leaves[4])
        img = render_radiance_replay(
            g, m2, e2, c, height=res, width=res, spp=spp, max_bounce=mb, sun_enabled=sun,
            uniforms=torch.as_tensor(u, device=device),
            light_uniforms=None if lu is None else torch.as_tensor(lu, device=device),
            nee=nee, lights=lights, spp_chunk=spp_chunk)
        loss = torch.mean(img ** 2)
        gr = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.item(), [(torch.zeros_like(x) if gx is None else gx).cpu()
                             for gx, x in zip(gr, leaves)]

    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    names = ("color", "roughness", "sun_power", "ibl_power", "ibl")
    reset_launches()
    (loss_k, g_k), ms = timed_once(lambda: grads(dev))
    launches = read_launches()
    check(sum(launches[k] for k in trace_kernels) > 0, f"{name}: the card made no trace launch")
    t0 = time.perf_counter()
    loss_c, g_c = grads("cpu")
    cpu_s = time.perf_counter() - t0
    loss_ch, g_ch = grads(dev, spp_chunk=1)
    card_cpu = {n_: rel(a, b) for n_, a, b in zip(names, g_k, g_c)}
    chunked = {n_: rel(a, b) for n_, a, b in zip(names, g_ch, g_k)}
    log(f"[phase {phase}] {name} gradients at {res}^2, {spp} spp, {mb} bounces, explicit uniforms: "
        f"loss card {loss_k:.7e}, cpu {loss_c:.7e}; card vs cpu relative "
        + ", ".join(f"{k} {v:.2e}" for k, v in card_cpu.items())
        + "; chunked (spp_chunk=1) vs unchunked "
        + ", ".join(f"{k} {v:.2e}" for k, v in chunked.items())
        + f"; card {ms:.1f} ms (launches {launches}), cpu {cpu_s:.1f} s [{smi}]")
    check(all(np.isfinite(x.numpy()).all() for x in g_k), f"{name}: non-finite card gradients")
    check(float(g_k[0].abs().max()) > 0.0, f"{name}: zero color gradient")
    check(max(card_cpu.values()) <= 1e-4, f"{name}: card vs cpu gradients {card_cpu} > 1e-4")
    check(max(chunked.values()) <= 1e-5, f"{name}: chunked vs unchunked {chunked} > 1e-5")
    return dict(name=name, card_vs_cpu=card_cpu, chunked_vs_unchunked=chunked, card_ms=ms,
                cpu_s=cpu_s)


def grad_profile(forward, seed: int) -> dict:
    """One value+grad under torch.profiler, the forward and the backward
    each ended by a synchronize: device time of the record kernels, of the
    port's other kernels, of the rest of the forward (the replay) and of
    the backward, and the device's idle share of the profiled window."""
    import torch
    from torch.profiler import record_function

    with launch_registry().trace() as prof:
        t0 = time.perf_counter()
        with record_function("grad:forward"):
            loss, leaves = forward(seed)
            torch.cuda.synchronize()
        with record_function("grad:backward"):
            torch.autograd.grad(loss, leaves, allow_unused=True)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    bwd_start = min(ev.start_ns() for ev in events
                    if ev.name() == "grad:backward" and ev.device_type() != cuda)
    groups = dict(record=0.0, other_port=0.0, replay_forward=0.0, backward=0.0)
    spans, backward_by_name = [], {}
    for ev in events:
        if ev.device_type() != cuda or ev.is_user_annotation() or ev.name().startswith("grad:"):
            continue
        start, dur, k = ev.start_ns(), ev.duration_ns(), ev.name()
        spans.append((start, start + dur))
        if any(x in k for x in RECORD_SUBS):
            groups["record"] += dur
        elif any(x in k for x in OTHER_PORT_SUBS):
            groups["other_port"] += dur
        elif start >= bwd_start:
            groups["backward"] += dur
            backward_by_name[k] = backward_by_name.get(k, 0) + dur
        else:
            groups["replay_forward"] += dur
    if not spans:
        return dict(profile="not measured")
    busy = union_length(spans)
    busy_us = busy / 1e3
    out = {f"{k}_ms": v / 1e6 for k, v in groups.items()}
    top = sorted(backward_by_name.items(), key=lambda kv: -kv[1])[:3]
    out.update(profile_wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               idle_share=1 - busy_us / wall_us, device_events=len(spans),
               backward_top={k[:80]: v / 1e6 for k, v in top})
    return out


def phase_train_step(role, dev, smi: str) -> dict:
    """11.4 on one shape: value+grad of ``image_loss`` through
    ``render_for_grad`` (as bench.py times it, target zeros), its launches
    with the backward's apart (it must launch none of the port's kernels),
    peak memory, s per step and Mrays/s, the profile split, and one
    ``make_train_step`` step (Adam and the clamps) at the same width."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.optimize import (
        Adam,
        TrainableParams,
        image_loss,
        make_train_step,
        render_for_grad,
    )
    from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import resident
    from ensem3a_openclraytracer_tpu_torch.scene.materials import default_sky

    name, (res, spp, mb), sun = role["name"], role["shape"], role["sun"]
    g, m, e, c = role["make"](dev)
    if "ibl" in role:
        e = e._replace(ibl=torch.as_tensor(default_sky(*role["ibl"]), device=dev))
    nb = g.feats.block_bounds.shape[0]
    params = TrainableParams.from_scene_params(m, e)
    target = torch.zeros((res, res, 3), dtype=torch.float32, device=dev)
    kw = dict(height=res, width=res, spp=spp, max_bounce=mb, sun_enabled=sun)

    def forward(seed):
        leaves = [x.detach().requires_grad_(True) for x in params]
        gen = torch.Generator(device=dev).manual_seed(seed)
        img = render_for_grad(TrainableParams(*leaves), g, m, e, c, gen, **kw)
        return image_loss(img, target), leaves

    def value_and_grad(seed):
        loss, leaves = forward(seed)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)

    # one value+grad with the counts and peak memory (and the warm-up), one timed as bench.py
    # times it, one profiled, then one step of make_train_step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss, leaves = forward(1)
    torch.cuda.synchronize()
    fwd = read_launches()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    bwd = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    one = resident(g.feats)
    kern = "sample_fused" if one else "sample_fused_queue"
    want = no_launches(**{"closest_hit" if one else "pairs": 1, kern: spp})
    check(fwd == want, f"{name}: forward launches {fwd}, want {want}")
    check(bwd == fwd, f"{name}: the backward launched port kernels: {fwd} -> {bwd}")
    check(bool(torch.isfinite(loss)), f"{name}: non-finite loss")
    check(all(gx is None or bool(torch.isfinite(gx).all()) for gx in grads),
          f"{name}: non-finite gradients")
    check(float(grads[0].abs().max()) > 0.0, f"{name}: zero color gradient")
    texel_grad = None if grads[4] is None else float(grads[4].abs().max())
    del loss, leaves, grads
    _, step_ms = timed_once(lambda: value_and_grad(2))
    step_s = step_ms / 1e3
    rays = res * res * (1 + spp * (mb + 1) * (2 if sun else 1))  # counted as bench.py counts
    n = res * res
    rec_bytes, esc_bytes = spp * (mb + 1) * n * 16, spp * n * 12
    ibl_bytes = e.ibl.numel() * 4
    prof = grad_profile(forward, 4)
    init, step = make_train_step(g, m, e, c, Adam(5e-2), **kw)
    p, st = init()
    # the first step captures the step's graph (utils/graphs); the second replays it
    _, first_ms = timed_once(
        lambda: step(p, st, target, torch.Generator(device=dev).manual_seed(6)))
    (p2, _, loss2), train_ms = timed_once(
        lambda: step(p, st, target, torch.Generator(device=dev).manual_seed(5)))
    check(bool(torch.isfinite(loss2)), f"{name}: non-finite train-step loss")
    check(not torch.equal(p2.color, p.color), f"{name}: the train step left the colors alone")
    check(float(p2.color.min()) >= 0.0 and float(p2.color.max()) <= 1.0,
          f"{name}: colors outside [0, 1] after the clamp")
    log(f"[phase 11] {name} ({nb} blocks) value+grad at {res}^2, {spp} spp, {mb} bounces, "
        f"sun={sun}, IBL {tuple(e.ibl.shape)}: {step_s:.4f} s per step, "
        f"{rays / step_s / 1e6:.1f} Mrays/s; launches forward {fwd}, backward added none; peak "
        f"memory {peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB held before: records "
        f"{rec_bytes / 1e9:.3f} GB + {(peak - rec_bytes - ibl_bytes) / esc_bytes:.1f} [spp*N, 3] "
        f"escape tensors of {esc_bytes / 1e9:.4f} GB + one IBL-sized texel gradient of "
        f"{ibl_bytes / 1e9:.3f} GB; max |texel grad| {texel_grad}; train step (Adam, clamps) "
        f"{train_ms / 1e3:.4f} s replayed, its first call {first_ms / 1e3:.4f} s (warm-up "
        f"{step.graph.last_capture['warm_up_s']:.3f} s, capture "
        f"{step.graph.last_capture['capture_s']:.3f} s, instantiation "
        f"{step.graph.last_capture['instantiate_s']:.3f} s) [{smi}]")
    if "max_escape_tensors" in role:  # the replay keeps records and escapes, not every bounce
        limit = rec_bytes + role["max_escape_tensors"] * esc_bytes
        check(peak <= limit, f"{name}: peak memory {peak} B above records + "
              f"{role['max_escape_tensors']} escape tensors ({limit} B)")
    if "record_ms" in prof:
        log(f"[phase 11] {name} profiled value+grad: wall {prof['profile_wall_ms']:.1f} ms "
            f"(profiler on), device busy {prof['device_busy_ms']:.1f} ms, idle share "
            f"{prof['idle_share']:.3f}; record kernels {prof['record_ms']:.2f} ms, other port "
            f"kernels {prof['other_port_ms']:.2f} ms, replay forward "
            f"{prof['replay_forward_ms']:.2f} ms, backward {prof['backward_ms']:.2f} ms "
            f"({prof['device_events']} device events); largest backward kernels (ms) "
            f"{prof['backward_top']}")
    else:
        log(f"[phase 11] {name}: profiler saw no device time: breakdown not measured")
    return dict(name=name, res=res, spp=spp, max_bounce=mb, sun=sun, blocks=nb,
                ibl=list(e.ibl.shape), step_s=step_s, mrays_per_s=rays / step_s / 1e6,
                launches=fwd, peak_bytes=peak, base_bytes=base, record_bytes=rec_bytes,
                escape_bytes=esc_bytes, ibl_bytes=ibl_bytes, train_step_s=train_ms / 1e3,
                train_step_first_call_s=first_ms / 1e3, **prof)


def phase_trainer(dev, smi: str, workdir: Path) -> dict:
    """11.5: ``run_optimization`` on Cornell from perturbed colors toward a
    target rendered at the true ones, checkpointing every 4 iterations; the
    loss must fall, and a run stopped after 6 iterations and resumed from
    its checkpoint must give the same loss trajectory bit for bit."""
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.optimize import (
        Adam,
        make_train_step,
        run_optimization,
    )
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance

    res, spp, mb = TRAIN["res"], TRAIN["spp"], TRAIN["max_bounce"]
    g, m, e, c = tt.make_cornell_scene(device=dev)
    target = render_radiance(g, m, e, c, torch.Generator(device=dev).manual_seed(0), height=res,
                             width=res, spp=64, max_bounce=mb, sun_enabled=False)
    rng = np.random.default_rng(21)
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, size=tuple(m.color.shape)).astype(np.float32),
                            device=dev)
    m0 = m._replace(color=torch.clamp(m.color * scale, 0.0, 1.0))
    init, step = make_train_step(g, m0, e, c, Adam(TRAIN["lr"]), height=res, width=res, spp=spp,
                                 max_bounce=mb, sun_enabled=False)
    kw = dict(checkpoint_every=TRAIN["every"])
    full, resumed = [], []
    t0 = time.perf_counter()
    params, _, _ = run_optimization(init, step, target, 5, iters=TRAIN["iters"],
                                    checkpoint_path=str(workdir / "full.npz"),
                                    log=lambda i, x: full.append(x), **kw)
    run_s = time.perf_counter() - t0
    stop = str(workdir / "stopped.npz")
    run_optimization(init, step, target, 5, iters=TRAIN["stop"], checkpoint_path=stop,
                     log=lambda i, x: resumed.append(x), **kw)
    run_optimization(init, step, target, 5, iters=TRAIN["iters"], checkpoint_path=stop,
                     log=lambda i, x: resumed.append(x), **kw)
    err0 = float((m0.color - m.color).abs().mean())
    err1 = float((params.color - m.color).abs().mean())
    log(f"[phase 11] trainer: Cornell {res}^2, {spp} spp, {mb} bounces, {TRAIN['iters']} "
        f"iterations of Adam at lr {TRAIN['lr']}: losses {[f'{x:.6e}' for x in full]}; "
        f"{run_s:.2f} s ({run_s / TRAIN['iters']:.3f} s per iteration, checkpoints every "
        f"{TRAIN['every']}); mean color error {err0:.4f} -> {err1:.4f}; stopped after "
        f"{TRAIN['stop']} and resumed: trajectory bit-equal {resumed == full} [{smi}]")
    check(len(full) == TRAIN["iters"] and all(np.isfinite(full)), f"trainer losses {full}")
    check(full[-1] < full[0], f"trainer: the loss did not fall ({full[0]} -> {full[-1]})")
    check(resumed == full, f"trainer: resumed trajectory {resumed} != uninterrupted {full}")
    return dict(losses=full, seconds=run_s, color_error=[err0, err1], resume_bit_equal=True)


def phase_gradients(dev, smi: str, workdir: Path) -> tuple:
    """Phase 11, the gradient path on the card: ``(kernels lines, summary)``."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt

    cornell = lambda d: tt.make_cornell_scene(device=d)
    outdoor = lambda k: (lambda d: tt.make_outdoor_scene(n_cubes=k, device=d))
    t0 = time.perf_counter()
    records = [
        dict(name="cornell", make=cornell, shape=GRAD_SHAPE, sun=False, seed=31, iters=20),
        dict(name="outdoor_1000", make=outdoor(1000), shape=(512, 16, 4), sun=True, seed=32,
             iters=10),
    ]
    lines = [phase_records(r, dev, smi) for r in records]
    gathers = phase_gather_backward(dev, smi)
    t1 = time.perf_counter()
    cases = [
        dict(name="cornell", make=cornell, sun=False, seed=41),
        dict(name="outdoor_1000", make=outdoor(1000), sun=True, seed=42),
        dict(name="glass_light_nee", make=lambda d: tt.make_glass_light_scene(device=d),
             sun=False, nee=True, seed=43),
    ]
    parity = [phase_grad_parity(cs, dev, smi) for cs in cases]
    t2 = time.perf_counter()
    steps = [
        phase_train_step(dict(name="cornell_fwdbwd", make=cornell, shape=GRAD_SHAPE, sun=False,
                              max_escape_tensors=8), dev, smi),
        phase_train_step(dict(name="outdoor64_texelgrad", make=outdoor(64), shape=TEXEL_SHAPE,
                              sun=True, ibl=TEXEL_IBL), dev, smi),
    ]
    t3 = time.perf_counter()
    trainer = phase_trainer(dev, smi, workdir)
    t4 = time.perf_counter()
    log(f"[phase 11] wall: records {t1 - t0:.1f} s, gradient parity {t2 - t1:.1f} s, train steps "
        f"{t3 - t2:.1f} s, trainer {t4 - t3:.1f} s")
    # each record line's kernel in the train step that records on it (Cornell's fwd+bwd step on
    # fused_sample, the texel-gradient step on fused_queue), beside its launches in 11.1
    for line, st in zip(lines, steps):
        kern = "sample_fused_queue" if "fused_queue" in line["source"] else "sample_fused"
        line.update(train_step=st["name"], train_step_launches=st["launches"][kern])
    return lines, dict(gather_backward=gathers, grad_parity=parity, train_steps=steps,
                       trainer=trainer)


# ---------------------------------------------------------------------------
# Phase 12: the product surface (models/progressive.py, cli.py, parallel/)
# ---------------------------------------------------------------------------

CLI_CHUNK = 16  # --chunk-spp of the CLI renders
CLI_OPTIMIZE = (128, 8, 4)  # one optimize iteration: the CLI's resolution cap, spp, bounces
BENCH_ARGS = ()  # bench at bench.py's shapes: Cornell 512^2, 100 spp, 4 bounces


def cli_scenes() -> list:
    """The CLI renders at phase 3's ini settings: Cornell (one block) and
    outdoor_1000 (47 blocks), with the kernels each chunk launches."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt

    return [
        dict(name="cornell", make=lambda d: tt.make_cornell_scene(device=d),
             render=(512, MAIN_SPP, 4), sun=False, hit="closest_hit", sample="sample_fused"),
        dict(name="outdoor_1000", make=lambda d: tt.make_outdoor_scene(n_cubes=1000, device=d),
             render=(512, 16, 4), sun=True, hit="pairs", sample="sample_fused_queue"),
    ]


def cli(argv) -> str:
    """``cli.main(argv)`` in this process; its standard output, echoed."""
    import contextlib
    import io

    from ensem3a_openclraytracer_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    text = buf.getvalue()
    for line in text.strip().splitlines():
        log(f"[phase 12]   | {line}")
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return text


def cli_render(scn, path: Path, workdir: Path, smi: str, tag: str, extra=()) -> dict:
    """One ``cli render`` at the ini's settings with the launch counts set to
    0 just before it and read just after it."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveState

    res, spp, mb = scn["render"]
    ckpt = workdir / f"{tag}.npz"
    out = workdir / tag / "out.png"
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    text = cli(["render", str(path), "--chunk-spp", str(CLI_CHUNK), "--checkpoint", str(ckpt),
                "--out", str(out), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    line = [x for x in text.splitlines() if x.startswith("rendered ")]
    check(len(line) == 1 and f"@ {spp} spp" in line[0], f"{tag}: render line {line}")
    check(out.exists() and (out.parent / "src.png").exists(), f"{tag}: PNGs not written")
    st = ProgressiveState.load(str(ckpt))
    img = st.image
    check(st.spp_done == spp and img.shape == (res, res, 3), f"{tag}: {st.spp_done} spp, "
          f"image {img.shape}")
    check(bool(np.isfinite(img).all()) and 0.0 < float(np.clip(img, 0, 1).mean()) <= 1.0,
          f"{tag}: image not finite or black")
    rays = res * res * (1 + spp * (mb + 1) * (2 if scn["sun"] else 1))
    log(f"[phase 12] {tag}: cli render {res}^2 {spp} spp {mb} bounces in chunks of {CLI_CHUNK}, "
        f"checkpoint every chunk: wall {wall:.3f} s ({rays / wall / 1e6:.1f} Mrays/s), "
        f"launches {launches} [{smi}]")
    return dict(name=tag, res=res, spp=spp, max_bounce=mb, chunk_spp=CLI_CHUNK, seconds=wall,
                mrays_per_s=rays / wall / 1e6, launches=launches, cli_line=line[0],
                accum=st.accum)


def traced_call(fn) -> tuple:
    """``fn()`` under torch.profiler (``launches.trace``): ``(its result,
    the port's kernels the trace saw run, by counter)``."""
    with launch_registry().trace() as prof:
        out = fn()
    return out, traced_launches(prof)


def phase_product(dev, smi: str, workdir: Path, main_renders: dict) -> dict:
    """Phase 12: the CLI's renders at the ini's settings with their launch
    counts, a stopped and resumed render against an uninterrupted one and
    against the mean of its chunks' ``render_radiance`` calls, ``--mesh 1,1``
    through ``nccl`` against the plain render, one ``optimize`` iteration
    and ``bench``."""
    import contextlib
    import os
    import socket

    import torch
    import torch.distributed as dist

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.optimize import iteration_generator
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance, render_scene
    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveState
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene
    from ensem3a_openclraytracer_tpu_torch.utils.image import save_png

    scenes = cli_scenes()
    zero = {k: 0 for k in read_launches()}
    out = {}
    with contextlib.chdir(workdir):  # the CLI keeps ./config.ini
        paths = {}
        for scn in scenes:
            res, spp, mb = scn["render"]
            path = workdir / f"{scn['name']}.obj"
            tt.write_scene_files(str(path), *scn["make"]("cpu"), resolution=res, spp=spp,
                                 max_bounce=mb)
            paths[scn["name"]] = path
            cli(["render", str(path), "--resolution", "64", "--spp", "16",
                 "--out", str(workdir / "warm.png")])  # warm-up
            info = cli_render(scn, path, workdir, smi, scn["name"])
            # the wrappers count the first chunk, which warms up and captures the chunk's
            # graph; the later chunks replay it, and a trace counts every chunk's kernels
            chunks = spp // CLI_CHUNK
            fused_sample = scn["sample"] == "sample_fused"
            want = {**zero, scn["hit"]: 1, scn["sample"]: 1 if fused_sample else CLI_CHUNK}
            check(info["launches"] == want, f"{scn['name']}: cli launches {info['launches']}, "
                  f"want the first chunk's {want}")
            # the same render without checkpoints, and render_scene (one call)
            nockpt = ["render", str(path), "--chunk-spp", str(CLI_CHUNK), "--out"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli(nockpt + [str(workdir / "nockpt" / "out.png")])
            torch.cuda.synchronize()
            info["seconds_no_checkpoint"] = time.perf_counter() - t0
            _, traced = traced_call(lambda: cli(nockpt + [str(workdir / "traced" / "out.png")]))
            want = {**zero, scn["hit"]: chunks, scn["sample"]: chunks if fused_sample else spp}
            check(traced == want, f"{scn['name']}: a traced cli render ran {traced}, want {want}")
            info["traced_launches"] = traced
            log(f"[phase 12] {scn['name']}: cli render, first chunk's launches "
                f"{info['launches']}; a traced cli render ran {traced}")
            scene = Scene.load(str(path), device=dev)
            first_render(scene, {}, f"[phase 12] {scn['name']}", smi)
            _, info["render_scene_seconds"] = replayed(scene, {}, f"[phase 12] {scn['name']}")
            log(f"[phase 12] {scn['name']}: cli {info['seconds']:.3f} s with checkpoints, "
                f"{info['seconds_no_checkpoint']:.3f} s without, render_scene "
                f"{info['render_scene_seconds']:.3f} s (phase 3: "
                f"{main_renders[scn['name']]['seconds']:.3f} s) [{smi}]")
            out[scn["name"]] = info

        # 12.2: stopped after two chunks and resumed, against the run above
        cornell = scenes[0]
        res, spp, mb = cornell["render"]
        ckpt = workdir / "stopped.npz"
        stop = ["render", str(paths["cornell"]), "--chunk-spp", str(CLI_CHUNK), "--checkpoint",
                str(ckpt), "--out", str(workdir / "stopped" / "out.png")]
        cli(stop + ["--spp", str(2 * CLI_CHUNK)])
        text = cli(stop)
        st = ProgressiveState.load(str(ckpt))
        resumed_equal = bool(np.array_equal(st.accum, out["cornell"]["accum"]))
        check(f"resumed at {2 * CLI_CHUNK} spp" in text, "the second render did not resume")
        check(st.spp_done == spp and resumed_equal,
              f"stopped and resumed: {st.spp_done} spp, accum bit-equal {resumed_equal}")
        scene = Scene.load(str(paths["cornell"]), device=dev)
        acc = np.zeros((res, res, 3))
        for i in range(spp // CLI_CHUNK):
            chunk = render_radiance(scene.geometry, scene.material_params(), scene.env_params(),
                                    scene.camera_params(), iteration_generator(0, i, dev),
                                    height=res, width=res, spp=CLI_CHUNK, max_bounce=mb,
                                    sun_enabled=False)
            acc = acc + chunk.cpu().numpy().astype(np.float64) * CLI_CHUNK
        chunks_img = torch.as_tensor((acc / spp).astype(np.float32))
        forks, med, mx = image_forks(torch.as_tensor(st.image), chunks_img)
        check(forks == 0.0, f"progressive vs the mean of its chunk renders: forks {forks}")
        log(f"[phase 12] cornell stopped after 2 chunks and resumed: accum bit-equal to the "
            f"uninterrupted run {resumed_equal}; image vs the mean of {spp // CLI_CHUNK} "
            f"render_radiance chunk calls: forks {forks}, median {med:.3g}, max {mx:.3g}, "
            f"bit-equal {bool(np.array_equal(st.image, chunks_img.numpy()))}")

        # 12.3: --mesh 1,1 against the plain render; the CLI joins a one-rank
        # group itself from torchrun's environment (parallel/distributed.initialize)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        saved = {k: os.environ.get(k) for k in env}
        check(not dist.is_initialized(), "a process group exists before --mesh 1,1")
        os.environ.update(env)
        try:
            mesh_info = cli_render(cornell, paths["cornell"], workdir, smi, "cornell_mesh",
                                   extra=("--mesh", "1,1"))
            joined = dist.is_initialized()
            backend = dist.get_backend() if joined else None
            world = dist.get_world_size() if joined else None
            card = torch.cuda.current_device()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        mesh_equal = bool(np.array_equal(mesh_info["accum"], out["cornell"]["accum"]))
        check(joined and backend == "nccl" and world == 1 and card == 0,
              f"--mesh 1,1 joined {joined}, backend {backend}, world {world}, cuda:{card}")
        check(mesh_equal, f"--mesh 1,1: accum bit-equal to the plain render {mesh_equal}")
        log(f"[phase 12] --mesh 1,1 joined a one-rank {backend} group on cuda:{card} from "
            f"torchrun's environment: accum bit-equal to the render without --mesh "
            f"{mesh_equal}")

        # 12.4: one optimize iteration, --dry-run
        o_res, o_spp, o_mb = CLI_OPTIMIZE
        target = workdir / "target.png"
        save_png(render_scene(scene, seed=9, overrides={"resolution": o_res}), str(target))
        ini = (workdir / "cornell.ini").read_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = cli(["optimize", str(paths["cornell"]), "--target", str(target), "--iters", "1",
                    "--resolution", str(o_res), "--spp", str(o_spp), "--max-bounce", str(o_mb),
                    "--dry-run"])
        opt_s = time.perf_counter() - t0
        losses = [float(x.split()[-1]) for x in text.splitlines() if x.startswith("iter")]
        check(len(losses) == 1 and np.isfinite(losses[0]), f"optimize losses {losses}")
        check((workdir / "cornell.ini").read_bytes() == ini, "optimize --dry-run wrote the ini")
        log(f"[phase 12] optimize, 1 iteration at {o_res}^2, {o_spp} spp, {o_mb} bounces, "
            f"--dry-run: loss {losses[0]:.6e}, {opt_s:.2f} s (scene load included) [{smi}]")

        # 12.5: bench (its JSON lines are echoed above)
        t0 = time.perf_counter()
        text = cli(["bench", *BENCH_ARGS])
        bench = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
        check([b["metric"] for b in bench] == ["cornell_forward_mrays_per_s",
                                               "cornell_fwdbwd_mrays_per_s",
                                               "cornell_train_step_mrays_per_s",
                                               "first_call_seconds"]
              and all(b["value"] > 0 for b in bench[:3]) and all(b["card"] for b in bench),
              f"bench lines {bench}")
        for b in bench:
            log(json.dumps(b))
        log(f"[phase 12] bench {time.perf_counter() - t0:.1f} s [{smi}]")
    for info in list(out.values()) + [mesh_info]:
        info.pop("accum")
    return dict(cli_renders=out, resume_bit_equal=resumed_equal, chunks_forks=forks,
                mesh_1x1=dict(mesh_info, backend=backend, bit_equal=mesh_equal),
                optimize=dict(loss=losses[0], seconds=opt_s), bench=bench)


# ---------------------------------------------------------------------------
# Phase 13: the tree (accel/, ops/traversal.py, kernel bvh_trace)
# ---------------------------------------------------------------------------

TREE_RAYS = 65536  # the bounce rays of role_rays that the kernel and its plain version share
# FP32 operations of the tree walk, counted from csrc/bvh_trace.cu: per node
# popped, the slab test (3 axes x (2 sub, 2 mul, min, max), then 2 max, 2 min,
# 3 compares); per leaf test, Moller-Trumbore (9 sub, 2 cross products of 9,
# 3 dots of 5, a reciprocal, 3 mul, 1 add, 8 compares)
FLOPS_PER_NODE = 25
FLOPS_PER_LEAF_TEST = 60
TREE_FLUSH_BYTES = 64 << 20  # written between launches to flush the 50 MB L2
TREE_GRAD = dict(name="cornell_tree", seed=13, sun=False)


def phase_tree_build(dev, smi: str) -> dict:
    """13.1: outdoor_12500's LBVH built on the host and on the card, every
    array equal, ``validate_bvh``, the build times."""
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.accel import build_lbvh, validate_bvh
    from ensem3a_openclraytracer_tpu_torch.accel.lbvh_device import build_lbvh_device

    g = tt.make_outdoor_scene(n_cubes=12500, use_bvh=True, device="cpu")[0]
    v = [x.numpy() for x in (g.v0, g.v1, g.v2)]
    t0 = time.perf_counter()
    host = build_lbvh(*v)
    host_s = time.perf_counter() - t0
    vd = [torch.as_tensor(x, device=dev) for x in v]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_lbvh_device(*vd, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nodes = build_lbvh_device(*vd, device=dev)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    for f in ("left", "right", "bmin", "bmax", "tri"):
        a, b = getattr(nodes, f).cpu().numpy(), getattr(host, f)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"[phase 13] the device tree's {f} differs from the host tree's")
    info = validate_bvh(host, v[0].shape[0], np.minimum(np.minimum(*v[:2]), v[2]),
                        np.maximum(np.maximum(*v[:2]), v[2]))
    validate_bvh(nodes, v[0].shape[0])
    log(f"[phase 13] outdoor_12500 tree ({v[0].shape[0]} tris, {info['nodes']} nodes, max depth "
        f"{info['max_depth']}, mean leaf depth {info['mean_leaf_depth']:.2f}): host build_lbvh "
        f"{host_s:.3f} s, build_lbvh_device on the card {device_s * 1e3:.2f} ms (first call "
        f"{first_s * 1e3:.1f} ms); every array equal [{smi}]")
    return dict(tris=int(v[0].shape[0]), host_build_s=host_s, device_build_ms=device_s * 1e3,
                device_build_first_ms=first_s * 1e3, **info)


def hold_against_pairs(label: str, h, ref, g, o, d):
    """The tree's hits against ``pairs.cu``'s on the same triangles: ``tri``
    and ``hit`` agree on >= 99.9 % of rays, and where ``tri`` agrees,
    ``|dt| <= 1e-4 max(1, t)`` against ``pairs.cu``'s t or else against the
    triangle's plane distance in float64: the two kernels compute t by
    different formulas (Moller-Trumbore; the plane distance
    ``[o, 1] . plane / d . n``), and on a grazing ray leaving a surface
    either may lose digits, so a ray outside the band must have the tree's
    t within it of the exact one.  Returns (tri fork fraction, hit fork
    fraction, max |dt| where tri agrees, rays held to the float64 t)."""
    import torch

    same = h.tri == ref.tri
    tri_frac = float(same.float().mean())
    hit_frac = float((h.hit == ref.hit).float().mean())
    err = (h.t - ref.t).abs()
    out = same & (err > 1e-4 * torch.clamp(ref.t, min=1.0))
    rays = torch.nonzero(out).squeeze(1)
    tri = h.tri[rays]
    a, b, c = (x[tri].double() for x in (g.v0, g.v1, g.v2))
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    o, d = o[rays].double(), d[rays].double()
    t64 = torch.sum(n * (a - o), dim=-1) / torch.sum(n * d, dim=-1)
    tree_err = (h.t[rays].double() - t64).abs()
    bad = int((tree_err > 1e-4 * torch.clamp(t64, min=1.0)).sum())
    max_err = float(err[same].max()) if bool(same.any()) else 0.0
    log(f"{label}: tri forks {1 - tri_frac:.6f}, hit forks {1 - hit_frac:.6f}, max |dt| "
        f"{max_err:.3e}; {rays.numel()} rays outside 1e-4 max(1, t) of pairs.cu, there the tree's "
        f"|dt| to the float64 plane distance at most "
        f"{float(tree_err.max()) if rays.numel() else 0.0:.3e}, pairs.cu's "
        f"{float((ref.t[rays].double() - t64).abs().max()) if rays.numel() else 0.0:.3e}")
    check(tri_frac >= 0.999, f"{label}: tri agrees on {tri_frac:.6f} < 0.999")
    check(hit_frac >= 0.999, f"{label}: hit agrees on {hit_frac:.6f} < 0.999")
    check(bad == 0, f"{label}: {bad} rays with the tree's t off the float64 t by > 1e-4 max(1, t)")
    return 1 - tri_frac, 1 - hit_frac, max_err, int(rays.numel())


def tree_ms(fn, iters: int, flush: bool = False) -> float:
    """``fn``'s device time per call in ms: CUDA events around each call,
    all queued behind a 10 ms device sleep, so that the host's work per
    call (a wrapper's checks and allocations, which can outlast a Cornell
    trace) is not timed; with ``flush``, a 64 MB scratch buffer is written
    before each call, outside the timed spans, to evict the tree from the
    50 MB L2."""
    import torch

    scratch = torch.empty(TREE_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(20_000_000)
    for i, (start, end) in enumerate(spans):
        if flush:
            scratch.fill_(float(i))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / iters


def walk_counts(label: str, stats, plain_stats, k: int) -> dict:
    """The kernel's five counts, held equal to its plain version's: nodes
    popped, leaf tests, dropped pushes (none), the most nodes one ray
    popped and the sum over warps of each warp's most; with the mean, the
    SIMT efficiency (popped over 32 lanes x the warps' most) and max /
    mean."""
    got, want = stats.tolist(), plain_stats.tolist()
    check(got == want, f"{label}: counts {got}, plain {want}")
    popped, leaf_tests, dropped, most, warp_most = got
    check(dropped == 0, f"{label}: {dropped} pushes past the stack")
    mean = popped / k
    return dict(nodes_popped=popped, leaf_tests=leaf_tests, dropped_pushes=dropped,
                max_pops_per_ray=most, warp_max_pops_sum=warp_most, mean_pops_per_ray=mean,
                simt_efficiency=popped / (32 * warp_most), max_over_mean_pops=most / mean)


def bit_equal(label: str, h, ref) -> tuple:
    """Rays whose ``tri`` or ``hit`` differ and rays whose ``t`` bits
    differ between two hits; both must be 0."""
    import torch

    differ = int(((h.tri != ref.tri) | (h.hit != ref.hit)).sum())
    t_bits = int((h.t.view(torch.int32) != ref.t.view(torch.int32)).sum())
    check(differ == 0 and t_bits == 0,
          f"{label}: {differ} rays differ in tri/hit, {t_bits} in the bits of t")
    return differ, t_bits


def phase_tree_trace(role, dev, smi: str, logs: dict) -> dict:
    """13.2-13.3 on one scene: ``trace_bvh`` (kernel ``bvh_trace``) against
    ``trace_bvh_plain`` on the card on the last ``plain_rays`` of phase 10's
    ray set (outdoor: its 65,536 bounce rays; Cornell: 262,144 rays, the
    shape of a 512^2 render's trace): ``t``, ``tri``, ``hit`` and the five
    counts equal, two launches equal; then, on a scene of several blocks,
    on all of phase 10's rays against ``ops/pairs.trace_pairs`` on the same
    scene's features pack, held to phase 2's bounds.  Times warm
    (back-to-back launches) and with the L2 cache flushed before each
    launch, nodes popped and leaf tests per ray, the longest walk and the
    SIMT efficiency, ptxas registers, stack frame and spills.  The bound is
    the walk's own counted work; the needed pairs of a block-culled search
    stand beside it as ``pairs_work_bound_ms``."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp
    from ensem3a_openclraytracer_tpu_torch.ops import traversal as tv

    g_feat, _, _, c = role["make"](dev)
    g = role["tree"](dev)
    check(g.feats is None and torch.equal(g.v0, g_feat.v0), f"{role['name']}: tree pack")
    feats, name, nb = g_feat.feats, role["name"], g_feat.feats.block_bounds.shape[0]
    tree = lambda o, d, **kw: tv.trace_bvh(g.bvh, g.v0, g.v1, g.v2, o, d, **kw)
    m, t = g.bvh.tri.shape[0], g.v0.shape[0]
    o_all, d_all = role_rays(g_feat, c, dev, seed=nb)  # phase 10's rays on this scene
    o, d = o_all[-role["plain_rays"]:].contiguous(), d_all[-role["plain_rays"]:].contiguous()
    k = o.shape[0]
    # each input read once (rays; a node's 32-byte row and its tri; a
    # triangle's vertices), each output written once
    nbytes = lambda n: n * (24 + 4 + 8 + 1) + 36 * m + 36 * t
    walk_flops = lambda popped, leaves: popped * FLOPS_PER_NODE + leaves * FLOPS_PER_LEAF_TEST
    label = f"[phase 13] {name}"

    # 13.2: the kernel against its plain version on the card, and itself
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    h = tree(o, d, stats=stats)
    h2 = tree(o, d)
    torch.cuda.synchronize()
    plain_stats = torch.zeros(5, dtype=torch.int64, device=dev)
    hp, plain_ms = timed_once(
        lambda: tv.trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o, d, stats=plain_stats))
    forks = hold(f"{label} bvh_trace vs trace_bvh_plain ({k} rays)", h.t, h.tri, h.hit, hp)
    differ, t_bits = bit_equal(f"{label} bvh_trace vs trace_bvh_plain ({k} rays)", h, hp)
    bit_equal(f"{label} bvh_trace, two launches ({k} rays)", h2, h)
    walk = walk_counts(f"{label} ({k} rays)", stats, plain_stats, k)
    ms = tree_ms(lambda: tree(o, d), role["iters"])
    flushed_ms = tree_ms(lambda: tree(o, d), role["iters"], flush=True)
    bound_ms, bound_by = bound(walk_flops(walk["nodes_popped"], walk["leaf_tests"]), nbytes(k))
    needed = needed_pairs(feats, o, d, hp.t)
    pairs_work_ms = bound(needed * FLOPS_PER_PAIR, nbytes(k))[0]
    regs = ptxas(logs["bvh_trace"], "bvh_trace_kernel")
    log(f"{label} ({t} tris, {m} nodes) {k} rays: rays differing from plain {differ}, t bits "
        f"differing {t_bits}, two launches equal; counts {stats.tolist()} equal to plain's; "
        f"bvh_trace {ms:.4f} ms warm, {flushed_ms:.4f} ms with L2 flushed (ptxas {regs}), "
        f"trace_bvh_plain {plain_ms:.1f} ms; per ray {walk['mean_pops_per_ray']:.1f} nodes popped "
        f"(most {walk['max_pops_per_ray']}, max / mean {walk['max_over_mean_pops']:.2f}), "
        f"{walk['leaf_tests'] / k:.1f} leaf tests; SIMT efficiency "
        f"{walk['simt_efficiency']:.3f}; bound {bound_ms:.4f} ms by {bound_by} (the walk's own "
        f"work); needed pairs {needed / k:.1f} per ray, their work {pairs_work_ms:.4f} ms [{smi}]")
    line = dict(
        name=f"bvh_trace:{name}", route="cuda",
        source="ensem3a_openclraytracer_tpu_torch/csrc/bvh_trace.cu",
        replaces="ensem3a_openclraytracer_tpu/ops/traversal.py:53", pallas=False,
        launches=0, max_abs_err=forks[2], rays=k, ms=ms, flushed_ms=flushed_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        pairs_work_bound_ms=pairs_work_ms, library_ms=None, rays_differing_from_plain=differ,
        t_bits_differing=t_bits, two_launches_equal=True, nodes=m, tris=t, **walk,
        needed_pairs=needed, tri_fork_fraction=forks[0], hit_fork_fraction=forks[1], ptxas=regs,
    )
    if nb < 2:
        return line

    # 13.3: against pairs.cu on all of phase 10's rays
    n = o_all.shape[0]
    all_stats = torch.zeros(5, dtype=torch.int64, device=dev)
    ha = tree(o_all, d_all, stats=all_stats)
    hq = pp.trace_pairs(feats, o_all, d_all)
    torch.cuda.synchronize()
    bit_equal(f"{label} bvh_trace on {n} rays, its last {k} against the {k}-ray launch",
              type(h)(*(x[-k:] for x in ha)), h)
    vs_pairs = hold_against_pairs(f"{label} bvh_trace vs trace_pairs ({n} rays)", ha, hq, g,
                                  o_all, d_all)
    a_popped, a_leaf, a_dropped, a_most, a_warp_most = all_stats.tolist()
    check(a_dropped == 0, f"{name}: {a_dropped} pushes past the stack")
    all_ms = tree_ms(lambda: tree(o_all, d_all), role["iters"])
    all_flushed_ms = tree_ms(lambda: tree(o_all, d_all), role["iters"], flush=True)
    pairs_ms = tree_ms(lambda: pp.trace_pairs(feats, o_all, d_all), role["iters"])
    a_needed = needed_pairs(feats, o_all, d_all, hq.t)
    a_bound_ms, a_bound_by = bound(walk_flops(a_popped, a_leaf), nbytes(n))
    a_pairs_work_ms = bound(a_needed * FLOPS_PER_PAIR, nbytes(n))[0]
    log(f"{label} ({nb} blocks) on phase 10's {n} rays: bvh_trace {all_ms:.4f} ms warm, "
        f"{all_flushed_ms:.4f} ms with L2 flushed, trace_pairs {pairs_ms:.4f} ms (tree / pairs "
        f"{all_ms / pairs_ms:.3f}); per ray {a_popped / n:.1f} nodes popped (most {a_most}), "
        f"{a_leaf / n:.1f} leaf tests, SIMT efficiency {a_popped / (32 * a_warp_most):.3f}, "
        f"{a_needed / n:.1f} needed pairs; bvh_trace's bound {a_bound_ms:.4f} ms by {a_bound_by} "
        f"(the walk's own work); the needed pairs' work {a_pairs_work_ms:.4f} ms (phase 10's "
        f"bound of pairs.cu) [{smi}]")
    line.update(
        pairs_rays=n, pairs_ms=pairs_ms, ms_on_pairs_rays=all_ms,
        flushed_ms_on_pairs_rays=all_flushed_ms,
        bound_on_pairs_rays_ms=a_bound_ms, pairs_work_bound_on_pairs_rays_ms=a_pairs_work_ms,
        nodes_popped_on_pairs_rays=a_popped, leaf_tests_on_pairs_rays=a_leaf,
        max_pops_per_ray_on_pairs_rays=a_most,
        simt_efficiency_on_pairs_rays=a_popped / (32 * a_warp_most),
        needed_pairs_on_pairs_rays=a_needed, tri_forks_vs_pairs=vs_pairs[0],
        hit_forks_vs_pairs=vs_pairs[1], max_abs_dt_vs_pairs=vs_pairs[2],
        rays_held_to_float64_t=vs_pairs[3],
    )
    return line


def phase_tree_render(scn, dev, workdir: Path, smi: str) -> dict:
    """13.4 on one scene: its written files loaded with ``Scene.load(...,
    use_bvh=True)`` and rendered with ``render_scene`` at the ini settings
    (the scan estimator: the pack has no features), the launch counts set
    to 0 just before its first call and read just after (the warm-up's
    launches); a replay timed, the image against the features pack's scan
    render (same seed and stream); one more replay profiled, its kernels
    counted from the trace."""
    import dataclasses

    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import fused_by_default
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene, pack_geometry

    res, spp, mb = scn["render"]
    obj = workdir / f"{scn['name']}.obj"
    g, m, e, c = scn["make"]("cpu")
    tt.write_scene_files(str(obj), g, m, e, c, resolution=res, spp=spp, max_bounce=mb)
    t0 = time.perf_counter()
    scene = Scene.load(str(obj), use_bvh=True, device=dev)
    load_s = time.perf_counter() - t0
    check(scene.geometry.feats is None and scene.geometry.bvh is not None,
          f"{scn['name']}: Scene.load(use_bvh=True) is not a tree-only pack")
    check(not fused_by_default(scene.geometry, dev), f"{scn['name']}: a tree pack took fused")
    sun = float(scene.env_params().sun_power) != 0.0
    _, launches = first_render(scene, {}, f"[phase 13] {scn['name']} tree", smi)
    img, dt = replayed(scene, {}, f"[phase 13] {scn['name']} tree")
    traces = 1 + spp * (mb + 1 + (1 if sun else 0))
    want = {k: 0 for k in launches}
    want.update(bvh_trace=traces, uniforms=launches["uniforms"])
    check(launches == want, f"{scn['name']}: tree render launches {launches}, want {want}")
    check(tuple(img.shape) == (res, res, 3) and bool(torch.isfinite(img).all()),
          f"{scn['name']}: tree image {tuple(img.shape)}")
    feat_scene = dataclasses.replace(scene, geometry=pack_geometry(scene.mesh, device=dev))
    first_render(feat_scene, {"fused": False}, f"[phase 13] {scn['name']} features scan", smi)
    img_f, dt_f = timed_render(feat_scene, {"fused": False})
    frac, med, mx = image_forks(img, img_f)
    rays = res * res * (1 + spp * (mb + 1) * (2 if sun else 1))
    log(f"[phase 13] {scn['name']} tree ({scene.num_tris} tris) {res}^2 {spp} spp {mb} bounces "
        f"sun={sun}: load {load_s:.2f} s, render {dt:.3f} s, {rays / dt / 1e6:.1f} Mrays/s, "
        f"launches {launches} (rng {launches['uniforms']}); features pack scan render "
        f"{dt_f:.3f} s; pixel forks {frac:.5f}, median {med:.2e}, max {mx:.3e} [{smi}]")
    check(frac < 0.02 and med < 1e-5,
          f"{scn['name']}: tree render vs features scan forks {frac:.4f}, median {med:.2e}")
    info = dict(name=f"{scn['name']}_tree", res=res, spp=spp, max_bounce=mb, sun=sun,
                engine="scan", seconds=dt, mrays_per_s=rays / dt / 1e6, launches=launches,
                load_s=load_s, features_scan_seconds=dt_f, pixel_forks=frac, median_diff=med)
    info.update(phase_profile(scene, f"{scn['name']}_tree", {}, phase="13", want=launches))
    return info


def phase_tree(dev, smi: str, logs: dict, workdir: Path, outdoor) -> tuple:
    """Phase 13: the build, the kernel against its plain version and against
    ``pairs.cu``, the tree renders through the entry point, and one replay
    gradient on a tree, card against CPU."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt

    build = phase_tree_build(dev, smi)
    tree = lambda cubes: lambda d: tt.make_outdoor_scene(n_cubes=cubes, use_bvh=True, device=d)[0]
    roles = [dict(name="cornell", make=lambda d: tt.make_cornell_scene(device=d),
                  tree=lambda d: tt.make_cornell_scene(use_bvh=True, device=d)[0],
                  plain_rays=262144, iters=10),
             dict(name="outdoor_1300", make=outdoor(1300), tree=tree(1300), plain_rays=TREE_RAYS,
                  iters=10),
             dict(name="outdoor_12500", make=outdoor(12500), tree=tree(12500),
                  plain_rays=TREE_RAYS, iters=5)]
    lines = [phase_tree_trace(r, dev, smi, logs) for r in roles]
    scenes = [
        dict(name="cornell", make=lambda d: tt.make_cornell_scene(device=d),
             render=(512, MAIN_SPP, 4)),
        dict(name="outdoor_1300", make=lambda d: tt.make_outdoor_scene(n_cubes=1300, device=d),
             render=(512, 16, 4)),
        dict(name="outdoor_12500", make=lambda d: tt.make_outdoor_scene(n_cubes=12500, device=d),
             render=(256, 16, 4)),
    ]
    renders = {s["name"]: phase_tree_render(s, dev, workdir, smi) for s in scenes}
    for line, r in zip(lines, roles):
        render = renders[r["name"]]
        line["launches"] = render["launches"]["bvh_trace"]
        # per launch in the profiled render, where the tree meets the scan
        # estimator's tensor ops between traces (the render's own ray counts)
        line["in_render_ms"] = (render["bvh_trace_ms"] / line["launches"]
                                if "bvh_trace_ms" in render else "not measured")
        line["in_render_rays"] = render["res"] ** 2
        log(f"[phase 13] {r['name']}: bvh_trace in the profiled tree render "
            f"{line['in_render_ms']} ms per launch ({line['launches']} launches of "
            f"{line['in_render_rays']} rays); alone {line['ms']:.4f} ms warm, "
            f"{line['flushed_ms']:.4f} ms with L2 flushed at {line['rays']} rays [{smi}]")
    check(sum(r["launches"]["bvh_trace"] for r in renders.values()) > 0,
          "the tree renders launched no bvh_trace kernel")
    case = dict(TREE_GRAD, make=lambda d: tt.make_cornell_scene(use_bvh=True, device=d))
    grad = phase_grad_parity(case, dev, smi, phase="13", trace_kernels=("bvh_trace",))
    return lines, dict(build=build, renders=list(renders.values()), gradient=grad)


def phases_2_to_12(dev, smi: str, logs: dict) -> tuple:
    """Phases 2-12: their kernels' lines and their parts of the summary."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt

    cornell = lambda d: tt.make_cornell_scene(device=d)
    outdoor = lambda k: (lambda d: tt.make_outdoor_scene(n_cubes=k, device=d))
    outdoor_panel = lambda d: tt.make_outdoor_scene(n_cubes=1000, emissive_panel=True, device=d)
    panel_blocks = outdoor_panel("cpu")[0].feats.block_bounds.shape[0]  # read, not assumed
    big_cfg = bench_config("outdoor600k")
    big_render = tuple(big_cfg["ini"][k] for k in ("resolution", "spp", "maxBounce"))
    # the scene phase 3 loaded and rendered, on the card
    big = lambda d: (lambda s: (s.geometry, s.material_params(), s.env_params(),
                                s.camera_params()))(loaded["outdoor600k"])
    roles = [
        dict(name="closest_hit:role1", scene="cornell", blocks=1, iters=50, sun=False,
             make=cornell, replaces="ensem3a_openclraytracer_tpu/ops/intersect_mxu.py:431"),
        dict(name="closest_hit:role3", scene="outdoor_1300", blocks=61, iters=10, sun=True,
             make=outdoor(1300), replaces="ensem3a_openclraytracer_tpu/ops/pairs.py:99",
             render_res=512),
        dict(name="closest_hit:role4", scene="outdoor_12500", blocks=586, iters=5, sun=True,
             make=outdoor(12500), replaces="ensem3a_openclraytracer_tpu/ops/pairs.py:330",
             render_res=256),
    ]
    kernels = [phase_kernel_vs_plain(roles[0], dev, logs)]  # roles 3-4: phase 10

    scenes = [  # the main path: renders at the scene's ini settings, default engine
        dict(name="cornell", scene="cornell", make=cornell, render=(512, MAIN_SPP, 4), sun=False),
        dict(name="cornell_nee", scene="cornell", make=cornell, render=(512, MAIN_SPP, 4),
             sun=False, overrides={"nee": True}),
        dict(name="outdoor_1000", scene="outdoor_1000", make=outdoor(1000), render=(512, 16, 4),
             sun=True),
        dict(name="outdoor_1000_nee", scene="outdoor_1000_panel", make=outdoor_panel,
             render=(512, 16, 4), sun=True, overrides={"nee": True}),
        dict(name="outdoor_1300", scene="outdoor_1300", make=outdoor(1300), render=(512, 16, 4),
             sun=True),
        dict(name="outdoor_12500", scene="outdoor_12500", make=outdoor(12500),
             render=(256, 16, 4), sun=True),
        # outdoor600k.render's scene and settings, above AGG_BLOCKS and SEL_BLOCKS
        dict(name="outdoor600k", scene="outdoor600k", config=big_cfg, render=big_render,
             sun=True),
    ]
    (ROOT / "build").mkdir(exist_ok=True)
    renders, loaded = [], {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for scn in scenes:
            loaded[scn["name"]], info = phase_main_path(scn, dev, Path(tmp), smi)
            renders.append(info)
    by_render = {r["name"]: r["launches"] for r in renders}
    kernels[0]["launches"] = by_render["cornell"]["closest_hit"]
    kernels[0]["role_on_main_path"] = kernels[0]["launches"] > 0
    for kern in ("closest_hit", "pairs", "sample_fused", "sample_fused_queue"):
        total = sum(r[kern] for r in by_render.values())
        check(total > 0, f"the main path launched no {kern} kernel")

    for r in roles[:2]:
        phase_same_stream(r, dev)

    fused_roles = [
        dict(name="sample_fused:cornell", render="cornell", blocks=1, sun=False, make=cornell,
             iters=20, record=True),
        dict(name="sample_fused:outdoor_1000", render="outdoor_1000", blocks=47, sun=True,
             make=outdoor(1000), iters=10, record=True),
        dict(name="sample_fused:cornell_nee", render="cornell_nee", blocks=1, sun=False,
             make=cornell, iters=20, nee=True),
        dict(name="sample_fused:outdoor_1000_nee", render="outdoor_1000_nee", blocks=panel_blocks,
             sun=True, make=outdoor_panel, iters=10, nee=True),
        # the queue kernel at the other block counts and ray counts of the main path
        dict(name="sample_fused:outdoor_1300", render="outdoor_1300", blocks=61, sun=True,
             make=outdoor(1300), iters=10, whole_render=((256, 100), (512, 16))),
        dict(name="sample_fused:outdoor_12500", render="outdoor_12500", blocks=586, sun=True,
             make=outdoor(12500), iters=5, res=256),
        dict(name="sample_fused:outdoor600k", render="outdoor600k", blocks=2344, sun=True,
             make=big, iters=3, res=big_render[0]),
    ]
    for fr in fused_roles:
        if fr["blocks"] == 1:
            line, kern = phase_fused_resident(fr, dev, smi, logs), "sample_fused"
        else:
            line, kern = phase_fused_queue(fr, dev, smi), "sample_fused_queue"
        line["launches"] = by_render[fr["render"]][kern]  # in the role's render
        kernels.append(line)
    rng_line = phase_stream_identity(fused_roles, dev)
    # the scan estimator's stream: off the main path, whose renders all take the fused engine
    rng_line["launches"] = sum(r["uniforms"] for r in by_render.values())
    rng_line["on_main_path"] = rng_line["launches"] > 0
    kernels.append(rng_line)

    versus = [phase_fused_vs_scan(scn, loaded[scn["name"]]) for scn in scenes
              if scn["name"] in ("cornell", "outdoor_1000", "outdoor_1300", "outdoor_12500")]

    proto_scenes = [
        dict(name="outdoor_1300", blocks=61, make=outdoor(1300), iters=5),
        dict(name="outdoor_12500", blocks=586, make=outdoor(12500), iters=3),
    ]
    t8 = time.perf_counter()
    inputs = [proto_inputs(scn, dev, smi) for scn in proto_scenes]
    kernels += [phase_grouped(scn, inp, dev, smi, logs) for scn, inp in zip(proto_scenes, inputs)]
    t9 = time.perf_counter()
    log(f"[phase 8] wall {t9 - t8:.1f} s")
    kernels += [phase_compact(scn, inp, dev, smi, logs)
                for scn, inp in zip(proto_scenes, inputs)]
    t10 = time.perf_counter()
    log(f"[phase 9] wall {t10 - t9:.1f} s")

    for role, scn, inp in zip(roles[1:], ("outdoor_1300", "outdoor_12500"), inputs):
        line = phase_pairs(role, dev, smi, inp)
        line["launches"] = by_render[scn]["pairs"]
        check(line["launches"] > 0, f"{scn}: the render launched no pairs kernel")
        kernels.append(line)
    big_role = dict(name="closest_hit:outdoor600k", scene="outdoor600k", blocks=2344, iters=3,
                    sun=True, make=big, replaces="ensem3a_openclraytracer_tpu/ops/pairs.py:99",
                    render_res=big_render[0], phase2_res=big_render[0])
    line = phase_pairs(big_role, dev, smi, None)
    line["launches"] = by_render["outdoor600k"]["pairs"]
    check(line["launches"] > 0, "outdoor600k: the render launched no pairs kernel")
    kernels.append(line)
    log(f"[phase 10] wall {time.perf_counter() - t10:.1f} s")

    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        grad_lines, gradients = phase_gradients(dev, smi, Path(tmp))
    kernels += grad_lines
    log(f"[phase 11] wall {time.perf_counter() - t11:.1f} s")

    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        product = phase_product(dev, smi, Path(tmp), {r["name"]: r for r in renders})
    log(f"[phase 12] wall {time.perf_counter() - t12:.1f} s")
    return kernels, {"renders": renders, "fused_vs_scan": versus, "gradients": gradients,
                     "product": product}


# ---------------------------------------------------------------------------
# Phase 14: the compiled entry points as captured CUDA graphs (utils/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_RUNS = 5  # warm calls timed per path, eager and graphed: the median is kept
GRAPH_TRAIN = dict(res=128, spp=8, max_bounce=4, steps=3)  # the trainer's steps (phase 11's)
# phase 14's Cornell value+grad step at 512^2: phase 11 times the graphed step at its 100
# samples; here at 16 the eager calls and the profiles of its 40 k kernels keep the script short
GRAPH_STEP_SPP = 16
GRAPH_RES = 512  # the renders', the progressive chunk's and the Cornell step's resolution


def median_s(fn, runs: int = GRAPH_RUNS) -> float:
    """Median wall of ``fn(i)`` over ``runs`` calls, each ended by a
    synchronize."""
    import torch

    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(10 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def profiled(fn) -> dict:
    """``fn()`` once under torch.profiler, ended by a synchronize: the device
    kernels it ran, memsets and copies, the device's busy time (the union of
    their spans), its idle share of the window and the port's kernels among
    them, by counter."""
    import torch

    with launch_registry().trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, kernels, other = [], 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start = ev.time_range.start
        spans.append((start, start + ev.time_range.elapsed_us()))
        name = ev.name.lower()
        if "memset" in name or "memcpy" in name:
            other += 1
        else:
            kernels += 1
    if not spans:
        return dict(profile="not measured")
    busy = union_length(spans)
    return dict(kernels=kernels, memsets_and_copies=other, wall_ms=wall_us / 1e3,
                device_busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
                port_launches=traced_launches(prof))


def same_tensors(a, b) -> bool:
    """Equal structure and every tensor equal bit for bit."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.utils.graphs import flatten

    (la, sa), (lb, sb) = flatten(a), flatten(b)
    return sa == sb and len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def graph_path(name: str, graphed, eager, graph, smi: str, runs: int = GRAPH_RUNS) -> dict:
    """One path of phase 14.  ``graphed(seed)`` and ``eager(seed)`` call the
    graphed entry point and its eager form on the same inputs with a
    generator seeded ``seed``; ``graph`` is the entry point's ``Graphed``.
    The first call captures (its wall, warm-up, capture, instantiation and
    pool bytes are printed on a line of their own); it, the first replay
    (same seed) and a replay with a new key must equal the eager call bit
    for bit.  The wrappers count the launches of the first call's warm-up,
    which must be the eager call's, and none in a replay; the graph must
    have recorded them, and a profiled replay must run them (counted in its
    trace).  Then eager and graphed walls (median of ``runs``) and one
    profiled call of each."""
    import torch

    captures = graph.captures
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    first = graphed(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_launches = read_launches()
    check(graph.captures == captures + 1, f"[phase 14] {name}: the first call captured "
          f"{graph.captures - captures} graphs, want 1")
    cap = dict(graph.last_capture)
    log(f"[phase 14] {name}: first call {first_s:.3f} s = warm-up {cap['warm_up_s']:.3f} s + "
        f"capture {cap['capture_s']:.3f} s + instantiation {cap['instantiate_s']:.3f} s + "
        f"copies; graph pool {cap['pool_bytes'] / 1e6:.1f} MB; port kernel launches the graph "
        f"recorded {cap['launches']} [{smi}]")
    reset_launches()
    ref1 = eager(1)
    eager_launches = read_launches()
    reset_launches()
    rep1 = graphed(1)
    replay_launches = read_launches()
    ref2, rep2 = eager(2), graphed(2)
    torch.cuda.synchronize()
    equal = dict(first_call=same_tensors(first, ref1), first_replay=same_tensors(rep1, ref1),
                 new_key=same_tensors(rep2, ref2))
    check(all(equal.values()), f"[phase 14] {name}: graphed vs eager bit-equal {equal}")
    check(not same_tensors(rep1, rep2), f"[phase 14] {name}: a new key gave the same output")
    nonzero = {k: v for k, v in eager_launches.items() if v}
    counted = {k: v for k, v in replay_launches.items() if v}
    check(first_launches == eager_launches and not counted and cap["launches"] == nonzero,
          f"[phase 14] {name}: launches first call {first_launches}, replay {counted}, "
          f"recorded by the capture {cap['launches']}, eager {eager_launches}")
    eager_s = median_s(eager, runs)
    graph_s = median_s(graphed, runs)
    prof_e = profiled(lambda: eager(3))
    prof_g = profiled(lambda: graphed(3))
    check("kernels" in prof_g and "kernels" in prof_e,
          f"[phase 14] {name}: the profiler saw no device time: the replay's kernels uncounted")
    check(prof_g["port_launches"] == prof_e["port_launches"] == eager_launches,
          f"[phase 14] {name}: the profiled replay ran {prof_g['port_launches']}, the profiled "
          f"eager call {prof_e['port_launches']}, the eager call launched {eager_launches}")
    check(graph.captures == captures + 1, f"[phase 14] {name}: warm calls captured again")
    show = lambda p: ("not measured" if "kernels" not in p else
                      f"{p['kernels']} kernels + {p['memsets_and_copies']} memsets/copies, "
                      f"wall {p['wall_ms']:.1f} ms, device busy {p['device_busy_ms']:.1f} ms, "
                      f"idle share {p['idle_share']:.3f}")
    log(f"[phase 14] {name}: port kernels of the first call's warm-up {nonzero}, counted in "
        f"a profiled replay {prof_g['port_launches']} [{smi}]")
    log(f"[phase 14] {name}: bit-equal to eager {equal}; wall eager {eager_s:.4f} s, graphed "
        f"{graph_s:.4f} s ({eager_s / graph_s:.2f}x; median of {runs}); profiled eager: "
        f"{show(prof_e)}; profiled replay: {show(prof_g)} [{smi}]")
    return dict(name=name, bit_equal=equal, first_call_s=first_s, capture=cap,
                launches=nonzero, eager_s=eager_s, graph_s=graph_s, profile_eager=prof_e,
                profile_graph=prof_g, runs=runs)


def graph_renders(dev, smi: str) -> list:
    """14.1: ``render_radiance_jit`` against ``render_radiance`` on Cornell
    (whole-render launch), Cornell with NEE, outdoor_1300 (2b) and a
    tree-only outdoor_1300 (the scan estimator: ``bvh_trace`` and the RNG
    kernel), at phase 3's and phase 13's settings."""
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import (
        render_radiance,
        render_radiance_jit,
    )
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    cornell = tt.make_cornell_scene(device=dev)
    outdoor = tt.make_outdoor_scene(n_cubes=1300, device=dev)
    tree = tt.make_outdoor_scene(n_cubes=1300, use_bvh=True, device=dev)
    main = dict(height=GRAPH_RES, width=GRAPH_RES, max_bounce=4)
    paths = [
        ("render:cornell", cornell, dict(main, spp=MAIN_SPP, sun_enabled=False)),
        ("render:cornell_nee", cornell, dict(main, spp=MAIN_SPP, sun_enabled=False, nee=True,
                                             lights=build_light_pack(cornell[0], cornell[1]))),
        ("render:outdoor_1300", outdoor, dict(main, spp=16, sun_enabled=True)),
        ("render:outdoor_1300_tree", tree, dict(main, spp=16, sun_enabled=True)),
    ]
    out = []
    for name, scene, kw in paths:
        gen = lambda s: torch.Generator(device=dev).manual_seed(s)
        out.append(graph_path(name, lambda s: render_radiance_jit(*scene, gen(s), **kw),
                              lambda s: render_radiance(*scene, gen(s), **kw),
                              render_radiance_jit.graph, smi))
        if name in ("render:cornell_nee", "render:outdoor_1300"):
            out[-1]["new_values"] = graph_new_values(name, scene, kw)
    return out


def new_values(scene, kw) -> list:
    """``(label, (geom, materials, env, camera), kw)``: the scene with one
    copied input changed at a time (the camera, a material's colour, the
    emitters' power, the sun, the NEE lights), then all of them."""
    import torch

    g, m, e, c = scene
    shift = lambda t, v: t + torch.as_tensor(v, dtype=t.dtype, device=t.device)
    m_color = m._replace(color=m.color * 0.8 + 0.1)
    m_power = m._replace(roughness=torch.where(m.mtype == 0, m.roughness * 1.25, m.roughness))
    e_sun = e._replace(sun_power=e.sun_power * 0.5 + 0.25,
                       sun_angles_deg=shift(e.sun_angles_deg, [3.0, -2.0, 1.0]))
    c_new = c._replace(position=shift(c.position, [0.05, -0.03, 0.02]),
                       rotation_deg=shift(c.rotation_deg, [1.0, -1.0, 0.5]))
    out = [("camera", (g, m, e, c_new), kw), ("material colour", (g, m_color, e, c), kw),
           ("emitter power", (g, m_power, e, c), kw), ("sun", (g, m, e_sun, c), kw)]
    kw_all = kw
    if kw.get("lights") is not None:
        lp, d = kw["lights"], [0.01, 0.0, -0.01]
        kw_all = dict(kw, lights=lp._replace(v0=shift(lp.v0, d), v1=shift(lp.v1, d),
                                             v2=shift(lp.v2, d), power=lp.power * 1.5))
        out.append(("lights", (g, m, e, c), kw_all))
    m_all = m_color._replace(roughness=m_power.roughness)
    out.append(("all", (g, m_all, e_sun, c_new), kw_all))
    return out


def graph_new_values(name: str, scene, kw) -> dict:
    """After the capture, each copied input given new values (``new_values``)
    and the IBL, read in place, changed in place: each replay bit-equal to
    ``render_radiance`` on the new values, and no new capture."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import (
        render_radiance,
        render_radiance_jit,
    )

    graph = render_radiance_jit.graph
    captures = graph.captures
    dev = scene[1].color.device
    gen = lambda: torch.Generator(device=dev).manual_seed(4)
    before = render_radiance_jit(*scene, gen(), **kw)
    equal, moved = {}, {}
    for label, args, kw2 in new_values(scene, kw):
        img = render_radiance_jit(*args, gen(), **kw2)
        equal[label] = torch.equal(img, render_radiance(*args, gen(), **kw2))
        moved[label] = not torch.equal(img, before)
    ibl = scene[2].ibl
    saved = ibl.clone()
    ibl.mul_(0.75)
    img = render_radiance_jit(*scene, gen(), **kw)
    equal["IBL in place"] = torch.equal(img, render_radiance(*scene, gen(), **kw))
    moved["IBL in place"] = not torch.equal(img, before)
    ibl.copy_(saved)
    check(all(equal.values()) and moved["all"] and graph.captures == captures,
          f"[phase 14] {name}: replays on new values bit-equal to eager {equal}, changed the "
          f"image {moved}, {graph.captures - captures} new captures")
    log(f"[phase 14] {name}: replays after new values, bit-equal to eager on them {equal}; "
        f"image changed {moved}; no new capture")
    return dict(bit_equal=equal, changed=moved)


def graph_progressive(dev, smi: str, workdir: Path) -> dict:
    """14.2: the progressive chunk function (Cornell 512^2, chunks of
    ``CLI_CHUNK`` samples) against its eager form, and a render stopped after
    two chunks and resumed whose sum equals the float64 fold of eager
    ``render_radiance`` chunks bit for bit."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.optimize import iteration_generator
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveRenderer

    g, m, e, c = tt.make_cornell_scene(device=dev)
    res, spp, mb = GRAPH_RES, MAIN_SPP, 4
    kw = dict(height=res, width=res, max_bounce=mb, chunk_spp=CLI_CHUNK, sun_enabled=False)
    r = ProgressiveRenderer(g, m, e, c, base_seed=7, **kw)
    gen = lambda s: iteration_generator(7, s, dev)
    info = graph_path("progressive:cornell_chunk", lambda s: r._chunk_fn(gen(s)),
                      lambda s: r._render.eager(g, m, e, c, gen(s)), r._render.graph, smi)
    ckpt = str(workdir / "graphs_progressive.npz")
    ProgressiveRenderer(g, m, e, c, base_seed=7, **kw).render(2 * CLI_CHUNK, checkpoint_path=ckpt)
    resumed = ProgressiveRenderer.resume(ckpt, g, m, e, c, **kw)
    resumed.render(spp)
    acc = np.zeros((res, res, 3))
    for i in range(spp // CLI_CHUNK):
        chunk = render_radiance(g, m, e, c, gen(i), height=res, width=res, spp=CLI_CHUNK,
                                max_bounce=mb, sun_enabled=False)
        acc = acc + chunk.cpu().numpy().astype(np.float64) * CLI_CHUNK
    equal = bool(np.array_equal(resumed.state.accum, acc))
    check(equal, "[phase 14] progressive: the resumed graphed render differs from the eager fold")
    log(f"[phase 14] progressive: Cornell {res}^2, {spp} spp in chunks of {CLI_CHUNK}, stopped "
        f"after 2 chunks and resumed: accum bit-equal to the eager fold {equal}")
    return dict(info, resumed_bit_equal=equal)


def graph_steps(dev, smi: str) -> list:
    """14.3: ``make_train_step``'s step against ``step.eager``: the Cornell
    trainer (``GRAPH_TRAIN``: one step as a path, then three chained steps
    from the same start, bit-equal), the texel step (phase 11's), and
    Cornell value+grad at 512^2 (``GRAPH_STEP_SPP`` samples)."""
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.optimize import (
        Adam,
        iteration_generator,
        make_train_step,
    )
    from ensem3a_openclraytracer_tpu_torch.scene.materials import default_sky

    cornell = tt.make_cornell_scene(device=dev)
    texel = tt.make_outdoor_scene(n_cubes=64, device=dev)
    texel = (*texel[:2], texel[2]._replace(ibl=torch.as_tensor(default_sky(*TEXEL_IBL),
                                                                device=dev)), texel[3])
    t_res, t_spp, t_mb = GRAPH_TRAIN["res"], GRAPH_TRAIN["spp"], GRAPH_TRAIN["max_bounce"]
    x_res, x_spp, x_mb = TEXEL_SHAPE
    cases = [
        ("step:cornell_trainer", cornell, dict(height=t_res, width=t_res, spp=t_spp,
                                               max_bounce=t_mb, sun_enabled=False), GRAPH_RUNS),
        ("step:outdoor64_texel", texel, dict(height=x_res, width=x_res, spp=x_spp,
                                             max_bounce=x_mb, sun_enabled=True), GRAPH_RUNS),
        ("step:cornell_fwdbwd", cornell, dict(height=GRAPH_RES, width=GRAPH_RES,
                                              spp=GRAPH_STEP_SPP, max_bounce=4,
                                              sun_enabled=False), GRAPH_RUNS),
    ]
    out = []
    for name, (g, m, e, c), kw, runs in cases:
        init, step = make_train_step(g, m, e, c, Adam(5e-2), **kw)
        p, st = init()
        target = torch.zeros((kw["height"], kw["width"], 3), device=dev)
        gen = lambda s: torch.Generator(device=dev).manual_seed(s)
        info = graph_path(name, lambda s: step(p, st, target, gen(s)),
                          lambda s: step.eager(p, st, target, gen(s)), step.graph, smi, runs)
        if name == "step:cornell_trainer":
            runs_of = {}
            for label, fn in (("graphed", step), ("eager", step.eager)):
                q, s_, losses = p, st, []
                for i in range(GRAPH_TRAIN["steps"]):
                    q, s_, loss = fn(q, s_, target, iteration_generator(5, i, dev))
                    losses.append(loss)
                runs_of[label] = (q, s_, losses)
            equal = same_tensors(runs_of["graphed"], runs_of["eager"])
            check(equal, f"[phase 14] {name}: {GRAPH_TRAIN['steps']} chained steps differ")
            log(f"[phase 14] {name}: {GRAPH_TRAIN['steps']} chained steps bit-equal to eager "
                f"{equal}: losses {[float(x) for x in runs_of['graphed'][2]]}")
            info["chained_bit_equal"] = equal
        out.append(info)
        del step, init
    return out


def phase_graphs(dev, smi: str, workdir: Path) -> dict:
    """Phase 14: every graphed entry point against its eager form."""
    renders = graph_renders(dev, smi)
    progressive = graph_progressive(dev, smi, workdir)
    steps = graph_steps(dev, smi)
    return dict(renders=renders, progressive=progressive, steps=steps)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch import testing as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    smi = smi_line()
    log(f"[phase 1] nvidia-smi: {smi}")
    log(f"[phase 1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    fresh = [n for n in _build.sources() if not _build._target(n).exists()]
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[phase 1] kernels {sorted(logs)}: built {fresh or 'none (up to date)'} "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"[phase 1] nvcc {name}: {line}")

    kernels, summary = phases_2_to_12(dev, smi, logs)
    outdoor = lambda k: (lambda d: tt.make_outdoor_scene(n_cubes=k, device=d))

    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tree_lines, tree = phase_tree(dev, smi, logs, Path(tmp), outdoor)
    kernels += tree_lines
    log(f"[phase 13] wall {time.perf_counter() - t13:.1f} s")

    t14 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        graphs = phase_graphs(dev, smi, Path(tmp))
    log(f"[phase 14] wall {time.perf_counter() - t14:.1f} s")

    summary = {"card": smi, **summary, "tree": tree, "graphs": graphs}
    log(f"[summary] {json.dumps(summary)}")
    log(f"[summary] total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
