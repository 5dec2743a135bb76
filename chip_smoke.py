#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``ensem3a_openclraytracer_tpu_torch/csrc``
and drives the port's main path, a scene loaded from an ``.obj`` + ``.ini``
and rendered at its ini settings, on the card:

1. environment and build: the card's name and power limit, versions, and
   the kernels' build time and ``-Xptxas -v`` report;
2. kernel against plain, once per role of the closest-hit kernel (1, 61
   and 586 triangle blocks): ``trace_blocks`` against ``trace_plain`` on
   the same 512^2 primary rays plus 65,536 bounce rays, with times, the
   (ray, triangle) pairs tested and the least time the card could take;
3. the main path at full size: ``Scene.load`` -> ``render_scene`` on the
   three scenes, with the kernel's launch count checked against the
   traces the estimator makes, and one more render of each traced with
   ``torch.profiler`` (kernel time by name, device idle share);
4. the same random stream through the kernel and through the plain scan
   on the card, at 64^2, 2 spp, 3 bounces: pixel forks below 2 %.

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
# FP32 operations (FMA counted as two) per (ray, triangle) pair tested:
# three 6-term side tests (33), d.n (5), [o,1].plane (6), one divide (1)
FLOPS_PER_PAIR = 45
# per (ray, triangle block) slab test: 3 axes x (2 sub, 2 mul, min, max,
# max, min) plus the 6-operation epsilon margin
FLOPS_PER_SLAB = 30
RAYS_PER_CTA = 128


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


def phase_kernel_vs_plain(role, dev):
    import torch

    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    g, _, _, c = role["make"](dev)
    nb = g.feats.block_bounds.shape[0]
    check(nb == role["blocks"], f"{role['name']}: {nb} blocks, want {role['blocks']}")
    o, d = role_rays(g, c, dev, seed=nb)
    order = ch.coherent_order(o, d)
    o, d = o[order].contiguous(), d[order].contiguous()
    n = o.shape[0]

    t, tri = ch.trace_blocks(g.feats, o, d)
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
    ch.trace_blocks(g.feats, o, d, stats=stats)
    pairs, stagings = (int(x) for x in stats.cpu())
    ms = cuda_ms(lambda: ch.trace_blocks(g.feats, o, d), iters=role["iters"])
    plain_ms = cuda_ms(lambda: ch.trace_plain(g.feats, o, d), iters=2)
    tp = g.feats.edges.shape[-1]
    flops = (pairs * FLOPS_PER_PAIR + n * nb * FLOPS_PER_SLAB
             + stagings * RAYS_PER_CTA * FLOPS_PER_SLAB)
    nbytes = n * (24 + 8) + 4 * 25 * tp + 32 * nb
    bound_ms = 1e3 * max(flops / PEAK_FP32, nbytes / PEAK_BYTES)
    log(f"[phase 2] {role['name']}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"pairs tested {pairs} ({pairs / n:.1f} per ray, {pairs / (n * tp):.4f} of all), "
        f"block stagings {stagings}, bound {bound_ms:.4f} ms "
        f"({flops:.3e} FP32 ops, {nbytes} bytes)")
    return dict(
        name=role["name"], route="cuda",
        source="ensem3a_openclraytracer_tpu_torch/csrc/closest_hit.cu",
        replaces=role["replaces"], launches=0, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="operations" if flops / PEAK_FP32 >= nbytes / PEAK_BYTES
        else "bytes", library_ms=None,
        rays=n, pairs_tested=pairs, tri_fork_fraction=1 - tri_frac,
        hit_fork_fraction=1 - hit_frac,
    )


def phase_main_path(role, dev, workdir: Path, smi: str):
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
    from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    res, spp, mb = role["render"]
    g, m, e, c = role["make"]("cpu")
    obj = workdir / f"{role['scene']}.obj"
    tt.write_scene_files(str(obj), g, m, e, c, resolution=res, spp=spp, max_bounce=mb)
    t0 = time.perf_counter()
    scene = Scene.load(str(obj), device=dev)
    load_s = time.perf_counter() - t0
    sun = float(scene.env_params().sun_power) != 0.0
    check(sun == role["sun"], f"{role['scene']}: sun_enabled {sun}")
    render_scene(scene, seed=1, overrides={"resolution": 64, "spp": 1})  # warm-up
    torch.cuda.synchronize()

    ch.LAUNCHES["closest_hit"] = 0
    t0 = time.perf_counter()
    img = render_scene(scene, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ch.LAUNCHES["closest_hit"]

    expected = 1 + spp * (mb + 1 + int(sun))
    mean = float(img.mean())
    check(tuple(img.shape) == (res, res, 3), f"{role['scene']}: image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{role['scene']}: non-finite pixels")
    check(0.0 < mean <= 1.0, f"{role['scene']}: image mean {mean}")
    check(launches == expected, f"{role['scene']}: {launches} kernel launches, want {expected}")
    rays = res * res * (1 + spp * (mb + 1) * (2 if sun else 1))  # counted as bench.py counts
    cam = scene.camera_params()
    o, d = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, res, res)
    o, d = o.contiguous(), d.contiguous()
    if scene.geometry.feats.block_bounds.shape[0] > 1:
        order = ch.coherent_order(o, d)
        o, d = o[order].contiguous(), d[order].contiguous()
    prim_ms = cuda_ms(lambda: ch.trace_blocks(scene.geometry.feats, o, d), iters=10)
    log(f"[phase 3] {role['scene']} ({scene.num_tris} tris) {res}^2 {spp} spp {mb} bounces "
        f"sun={sun}: load {load_s:.2f} s, render {dt:.3f} s, {rays / dt / 1e6:.1f} Mrays/s, "
        f"mean {mean:.4f}, kernel launches {launches}, kernel on the {res * res} primary rays "
        f"{prim_ms:.4f} ms (CUDA events) [{smi}]")
    info = dict(scene=role["scene"], res=res, spp=spp, max_bounce=mb, sun=sun, seconds=dt,
                mrays_per_s=rays / dt / 1e6, launches=launches, primary_trace_ms=prim_ms,
                mean=mean)
    info.update(phase_profile(scene, role["scene"]))
    return launches, info


def phase_profile(scene, name: str) -> dict:
    """Where the time goes in one more render of the scene, traced with
    torch.profiler: device time of the closest-hit kernel and of the
    other kernels, and the device's idle share of the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_scene(scene, seed=2)
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
        log(f"[phase 3] {name}: profiler saw no device time: breakdown not measured")
        return dict(profile="not measured")
    busy, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    hit_us = sum(v for k, v in by_name.items() if "closest_hit" in k)
    total_us = sum(by_name.values())
    top = sorted(((v, k) for k, v in by_name.items() if "closest_hit" not in k), reverse=True)[:4]
    log(f"[phase 3] {name} profiled render: wall {wall_us / 1e3:.1f} ms (profiler on), device "
        f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}; closest_hit "
        f"{hit_us / 1e3:.1f} ms = {hit_us / total_us:.3f} of device time; other kernels "
        f"{(total_us - hit_us) / 1e3:.1f} ms, largest: "
        + "; ".join(f"{k[:60]} {v / 1e3:.1f} ms" for v, k in top))
    return dict(profile_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                idle_share=1 - busy / wall_us, closest_hit_ms=hit_us / 1e3,
                other_kernels_ms=(total_us - hit_us) / 1e3)


def phase_same_stream(role, dev):
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    res, spp, mb = 64, 2, 3
    g, m, e, c = role["make"](dev)
    rng = np.random.default_rng(11)
    u = torch.as_tensor(rng.random(size=(spp, mb + 1, res * res, 2), dtype=np.float64)
                        .astype(np.float32), device=dev)
    kw = dict(height=res, width=res, spp=spp, max_bounce=mb, sun_enabled=role["sun"], uniforms=u)
    before = ch.LAUNCHES["closest_hit"]
    img_k = render_radiance(g, m, e, c, engine="kernel", **kw)
    check(ch.LAUNCHES["closest_hit"] > before, f"{role['scene']}: kernel path made no launch")
    img_p = render_radiance(g, m, e, c, engine="plain", **kw)
    torch.cuda.synchronize()
    diff = (img_k - img_p).abs().amax(dim=-1)
    frac = float((diff > 1e-3).float().mean())
    log(f"[phase 4] {role['scene']}: kernel vs plain pixel forks {frac:.5f}, "
        f"max diff {float(diff.max()):.3e}")
    check(bool(torch.isfinite(img_k).all()), f"{role['scene']}: non-finite pixels")
    check(frac < 0.02, f"{role['scene']}: pixel forks {frac:.5f} >= 0.02")


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

    roles = [
        dict(name="closest_hit:role1", scene="cornell", blocks=1, iters=50, sun=False,
             make=lambda d: tt.make_cornell_scene(device=d), render=(512, 64, 4),
             replaces="ensem3a_openclraytracer_tpu/ops/intersect_mxu.py:431"),
        dict(name="closest_hit:role3", scene="outdoor_1300", blocks=61, iters=10, sun=True,
             make=lambda d: tt.make_outdoor_scene(n_cubes=1300, device=d), render=(512, 16, 4),
             replaces="ensem3a_openclraytracer_tpu/ops/pairs.py:99"),
        dict(name="closest_hit:role4", scene="outdoor_12500", blocks=586, iters=5, sun=True,
             make=lambda d: tt.make_outdoor_scene(n_cubes=12500, device=d), render=(256, 16, 4),
             replaces="ensem3a_openclraytracer_tpu/ops/pairs.py:330"),
    ]
    kernels = [phase_kernel_vs_plain(r, dev) for r in roles]

    (ROOT / "build").mkdir(exist_ok=True)
    renders = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for r, k in zip(roles, kernels):
            k["launches"], info = phase_main_path(r, dev, Path(tmp), smi)
            renders.append(info)

    for r in roles[:2]:
        phase_same_stream(r, dev)

    log(f"[summary] {json.dumps({'card': smi, 'renders': renders})}")
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
