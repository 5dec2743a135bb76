"""Command-line product surface (the reference's Tkinter UI as subcommands).

Counterpart of the JAX package's ``cli.py``, with the same subcommands and
flags:

  render    path-trace a scene to PNG (progressive, resumable; --mesh shards it)
  optimize  inverse rendering: fit material/env parameters to a target
  bench     throughput of the Cornell render and fwd+bwd, JSON lines
  info      scene statistics (triangles, materials, lights, config)
  set/get   edit per-scene ini parameters

Every subcommand takes ``--device`` (default ``cuda``, which raises
without a card; ``--device cpu`` runs the plain PyTorch path):

  python -m ensem3a_openclraytracer_tpu_torch render scene.obj --device cpu
  torchrun --nproc-per-node 4 -m ensem3a_openclraytracer_tpu_torch render scene.obj --mesh 2,2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

GLOBAL_CONFIG = "config.ini"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _load_scene(path: str, dev):
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    return Scene.load(path, device=dev)


def _parse_mesh(spec: Optional[str], dev):
    """``--mesh dp,sp`` (or ``auto``: every rank, dp only) -> ``(mesh,
    member)``: joins ``torch.distributed`` from ``torchrun``'s environment
    first.  ``member`` is False on a rank outside a mesh smaller than the
    world, which then has nothing to do.  Without ``--mesh`` the mesh is
    1x1 and nothing is joined."""
    from ensem3a_openclraytracer_tpu_torch.parallel.mesh import make_mesh, single_device_mesh

    if not spec:
        return single_device_mesh(), True
    import torch.distributed as dist

    from ensem3a_openclraytracer_tpu_torch.parallel.distributed import initialize

    initialize(device=dev)
    if spec == "auto":
        mesh = make_mesh(sp=1)
        return mesh, mesh is not None
    dp, sp = (int(x) for x in spec.split(","))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * sp > world:
        raise SystemExit(f"--mesh {spec} needs {dp * sp} ranks, have {world} "
                         "(launch with torchrun --nproc-per-node)")
    mesh = make_mesh(sp=sp, world=dp * sp)
    return mesh, mesh is not None


def _global_scene_path() -> Optional[str]:
    """``scenePath`` from ``./config.ini``: the reference's last-scene
    memory (config.ini:1, UI.py:57-61)."""
    try:
        with open(GLOBAL_CONFIG) as f:
            for line in f:
                k, _, v = line.partition("=")
                if k.strip() == "scenePath":
                    return v.strip()
    except OSError:
        return None
    return None


def _remember_scene_path(path: str) -> None:
    """Set ``scenePath`` in ``./config.ini``, keeping every other line."""
    try:
        with open(GLOBAL_CONFIG) as f:
            lines = f.read().splitlines()
    except OSError:
        lines = []
    entry = f"scenePath={os.path.abspath(path)}"
    keys = [line.partition("=")[0].strip() for line in lines]
    if "scenePath" in keys:
        lines[keys.index("scenePath")] = entry
    else:
        lines.append(entry)
    try:
        with open(GLOBAL_CONFIG, "w") as f:
            f.write("\n".join(lines) + "\n")
    except OSError:
        pass  # read-only cwd: the last-scene memory is best-effort


def _lights(sc, materials, args):
    """``(lights, nee, mis)`` from ``--nee``/``--mis`` (MIS implies NEE);
    both need emissive faces."""
    mis = bool(args.mis)
    nee = bool(args.nee) or mis
    lights = None
    if nee:
        lights = sc.light_pack(materials)
        if lights is None:
            print("warning: --nee/--mis requested but scene has no emissive faces; disabled")
            nee = mis = False
    return lights, nee, mis


def cmd_render(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ensem3a_openclraytracer_tpu_torch._device import resolve_device
    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveRenderer
    from ensem3a_openclraytracer_tpu_torch.ops.tonemap import postprocess
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene
    from ensem3a_openclraytracer_tpu_torch.utils.image import save_png
    from ensem3a_openclraytracer_tpu_torch.utils.profiling import (
        StageTimer,
        rays_per_render,
        torch_trace,
    )

    dev = resolve_device(args.device)
    if not args.scene:
        args.scene = _global_scene_path()
        if not args.scene:
            raise SystemExit("no scene given and no scenePath in ./config.ini")
    mesh, member = _parse_mesh(args.mesh, dev)
    if not member:
        return 0
    if args.watch is not None and mesh.size > 1:
        raise SystemExit("--watch re-renders in one process; drop --mesh or use --mesh 1,1")
    writer = _rank() == 0  # with a mesh only rank 0 writes files and prints
    timer = StageTimer()
    with timer.stage("scene_load"):
        sc = _load_scene(args.scene, dev)
    if writer:
        _remember_scene_path(args.scene)

    def one_render(sc):
        """One full render of ``sc`` at its current config; ``--watch``
        re-enters it with the geometry reused (UI.py:92-104)."""
        rs = sc.config.render_settings()
        res = args.resolution or rs.resolution
        spp = args.spp or rs.spp
        max_bounce = args.max_bounce or rs.max_bounce
        env = sc.env_params()
        materials = sc.material_params()
        sun_enabled = float(env.sun_power) != 0.0
        lights, nee, mis = _lights(sc, materials, args)
        kw = dict(height=res, width=res, max_bounce=max_bounce,
                  chunk_spp=min(args.chunk_spp, spp), sun_enabled=sun_enabled, lights=lights,
                  nee=nee, glass_mode=args.glass, mis=mis, mesh=mesh)
        ckpt = args.checkpoint
        t0 = time.time()
        with timer.stage("setup"):
            if ckpt and os.path.exists(ckpt) and not args.restart:
                r = ProgressiveRenderer.resume(ckpt, sc.geometry, materials, env,
                                               sc.camera_params(), **kw)
                if writer:
                    print(f"resumed at {r.state.spp_done} spp from {ckpt}")
            else:
                r = ProgressiveRenderer(sc.geometry, materials, env, sc.camera_params(),
                                        base_seed=args.seed, **kw)
            if mesh.group is not None:
                dist.barrier(group=mesh.group)  # every rank has read the checkpoint
        progress = None
        if args.verbose and writer:
            progress = lambda done, total: print(f"  {done}/{total} spp", flush=True)
        with torch_trace(args.profile if writer else None), timer.stage("render", sync=dev):
            img = r.render(spp, checkpoint_path=ckpt if writer else None, progress=progress)
        wall = time.time() - t0
        spp_done = r.state.spp_done
        if not writer:
            return
        out = args.out or os.path.join("output", "out.png")
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with timer.stage("write"):
            save_png(postprocess(torch.from_numpy(img), mode=args.tonemap), out)
            # the raw clamp beside it, as the reference writes output/out.png
            # and output/src.png (main.py:101-104)
            save_png(np.clip(img, 0.0, 1.0), os.path.join(os.path.dirname(out) or ".", "src.png"))
        mrays_per_s = rays_per_render(res, spp_done, max_bounce, sun_enabled) / wall / 1e6
        print(f"rendered {res}x{res} @ {spp_done} spp in {wall:.2f}s "
              f"({mrays_per_s:.1f} Mrays/s) -> {out}", flush=True)
        if args.profile:
            print(f"torch trace -> {args.profile}")
        if args.verbose:
            print("stages:", timer.report())

    one_render(sc)
    if args.watch is not None:
        # the reference UI's edit -> render -> refresh loop (UI.py:92-104):
        # poll the ini and re-render on change without re-importing the
        # geometry (UI.py:98); --watch N stops after N re-renders (0: never)
        ini = sc.config.config_path

        def ini_bytes():
            # content, not mtime: 1 s mtime granularity misses quick edits
            try:
                with open(ini, "rb") as f:
                    return f.read()
            except OSError:
                return b""

        last = ini_bytes()
        done = 0
        print(f"watching {ini} (ctrl-C to stop)", flush=True)
        try:
            while args.watch == 0 or done < args.watch:
                time.sleep(args.watch_poll)
                cur = ini_bytes()
                if cur == last:
                    continue
                last = cur
                with timer.stage("scene_reload"):
                    sc = Scene.load(args.scene, rebuild_accel=False, geometry=sc.geometry,
                                    device=dev)
                one_render(sc)
                done += 1
        except KeyboardInterrupt:
            pass
    return 0


def cmd_optimize(args) -> int:
    import torch

    from ensem3a_openclraytracer_tpu_torch._device import resolve_device
    from ensem3a_openclraytracer_tpu_torch.models.optimize import (
        Adam,
        make_train_step,
        run_optimization,
    )
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
    from ensem3a_openclraytracer_tpu_torch.parallel.render import shard_target_image
    from ensem3a_openclraytracer_tpu_torch.utils.image import load_png, save_png

    dev = resolve_device(args.device)
    sc = _load_scene(args.scene, dev)
    rs = sc.config.render_settings()
    res = args.resolution or min(rs.resolution, 128)
    env = sc.env_params()
    materials = sc.material_params()
    target = torch.as_tensor(load_png(args.target), device=dev)
    if target.shape[0] != res or target.shape[1] != res:
        raise SystemExit(f"target is {target.shape[0]}x{target.shape[1]}, render is "
                         f"{res}x{res}; pass --resolution to match")
    mesh, member = _parse_mesh(args.mesh, dev)
    if not member:
        return 0
    writer = _rank() == 0
    lights, nee, mis = _lights(sc, materials, args)
    sun_enabled = float(env.sun_power) != 0.0
    init, step = make_train_step(
        sc.geometry, materials, env, sc.camera_params(), Adam(args.lr),
        height=res, width=res, spp=args.spp, max_bounce=args.max_bounce,
        sun_enabled=sun_enabled, mesh=mesh, nee=nee, lights=lights, mis=mis)
    every = max(1, args.iters // 20)

    def log(i, loss):
        if writer and (i % every == 0 or i == args.iters - 1):
            print(f"iter {i:4d}  loss {loss:.6f}", flush=True)

    params, _, _ = run_optimization(
        init, step, shard_target_image(mesh, target), args.seed,
        iters=args.iters, checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, log=log)
    if not writer:
        return 0
    m, e = params.apply(materials, env)
    if not args.dry_run:  # the UI round trip: fitted values back into the scene's ini
        table = m.to_table()
        for idx in range(table.shape[0]):
            sc.config.set_material(idx, color=table[idx, 1:4], roughness=table[idx, 4])
        sc.config.set_many({"sun_Power": float(e.sun_power), "IBL_Power": float(e.ibl_power)})
        print(f"wrote fitted parameters back to {sc.config.config_path}")
    if args.out:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        img = render_radiance(sc.geometry, m, e, sc.camera_params(), gen, height=res,
                              width=res, spp=args.spp * 4, max_bounce=args.max_bounce,
                              sun_enabled=sun_enabled)
        save_png(torch.clamp(img, 0.0, 1.0), args.out)
        print(f"fitted render -> {args.out}")
    return 0


def card_line(dev) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of ``dev``'s card; None on the
    CPU or when ``nvidia-smi`` cannot say."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    idx = dev.index or 0
    return lines[idx].strip() if out.returncode == 0 and idx < len(lines) else None


def _median_s(fn, dev, runs: int = 3) -> float:
    """Median wall time of ``fn(i)`` over ``runs`` calls after one warm-up,
    each ending in a device synchronize."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn(0)
    sync()
    times = []
    for i in range(runs):
        t0 = time.perf_counter()
        fn(i + 1)
        sync()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _first_call_s(fn, dev) -> float:
    """Wall time of ``fn(0)``, the call that captures a graph on the card."""
    import torch

    t0 = time.perf_counter()
    fn(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def cmd_bench(args) -> int:
    """``bench.py``'s Cornell throughput metrics measured on the port, as the
    JAX package times its compiled functions: the forward render (512^2,
    100 spp, 4 bounces, no sun) through ``render_radiance_jit``, value+grad
    of the image loss at the same shape through a graphed
    ``value_and_grad`` (as bench.py jits it), and a whole train step (the
    same value+grad, Adam and the clamps) through ``make_train_step``, one
    JSON line each, timed after the call that captures their graphs; then a
    line with those first calls' seconds (capture included)."""
    if args.scaling:
        return cmd_bench_scaling(args)
    import torch

    from ensem3a_openclraytracer_tpu_torch._device import resolve_device
    from ensem3a_openclraytracer_tpu_torch.models.optimize import (
        Adam,
        TrainableParams,
        make_train_step,
        value_and_grad,
    )
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance_jit
    from ensem3a_openclraytracer_tpu_torch.ops.rng import key_from_generator
    from ensem3a_openclraytracer_tpu_torch.testing import make_cornell_scene
    from ensem3a_openclraytracer_tpu_torch.utils.graphs import Graphed
    from ensem3a_openclraytracer_tpu_torch.utils.profiling import rays_per_render

    dev = resolve_device(args.device)
    res, spp, mb = args.resolution or 512, args.spp or 100, 4
    geom, materials, env, camera = make_cornell_scene(device=dev)
    kw = dict(height=res, width=res, spp=spp, max_bounce=mb, sun_enabled=False)
    where = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
             "card": card_line(dev), "workload": f"cornell {res}^2/{spp}spp/{mb}b"}

    def gen(i):
        g = torch.Generator(device=dev)
        g.manual_seed(i)
        return g

    def emit(metric, seconds):
        print(json.dumps({"metric": metric,
                          "value": round(rays_per_render(res, spp, mb, False) / seconds / 1e6, 3),
                          "unit": "Mrays/s", "seconds": seconds, **where}), flush=True)

    forward = lambda i: render_radiance_jit(geom, materials, env, camera, gen(i), **kw)
    with torch.no_grad():
        first = {"forward": _first_call_s(forward, dev)}
        emit("cornell_forward_mrays_per_s", _median_s(forward, dev))

    def loss_and_grads(params, target, key):
        return value_and_grad(params, target, geom, materials, env, camera, key=key, **kw)

    params = TrainableParams.from_scene_params(materials, env)
    target = torch.zeros((res, res, 3), device=dev)
    graphed = Graphed(loss_and_grads)
    fwdbwd = lambda i: graphed(params, target, key_from_generator(gen(i), dev))
    first["fwdbwd"] = _first_call_s(fwdbwd, dev)
    emit("cornell_fwdbwd_mrays_per_s", _median_s(fwdbwd, dev))
    graphed.clear()  # its memory pool, before the step captures its own

    init, step = make_train_step(geom, materials, env, camera, Adam(1e-2), **kw)
    params, opt_state = init()
    train = lambda i: step(params, opt_state, target, gen(i))
    first["train_step"] = _first_call_s(train, dev)
    emit("cornell_train_step_mrays_per_s", _median_s(train, dev))
    print(json.dumps({"metric": "first_call_seconds", **first, "unit": "s",
                      "note": "warm-up and graph capture on the card", **where}), flush=True)
    return 0


def cmd_bench_scaling(args) -> int:
    """Rank-count scaling of the sharded Cornell render over the current
    ``torch.distributed`` world (one process: the one-rank record), as
    the JAX CLI sweeps devices: (1) meshes of the first 1, 2, ... ranks
    (dp only) with Mrays/s and ``efficiency`` = rate / (n * rate_1);
    (2) every (dp, sp) shape of the whole world.  ``--out FILE`` also
    writes the records as JSON lines."""
    import torch
    import torch.distributed as dist

    from ensem3a_openclraytracer_tpu_torch._device import resolve_device
    from ensem3a_openclraytracer_tpu_torch.parallel.distributed import initialize
    from ensem3a_openclraytracer_tpu_torch.parallel.mesh import make_mesh
    from ensem3a_openclraytracer_tpu_torch.parallel.render import render_radiance_sharded
    from ensem3a_openclraytracer_tpu_torch.testing import make_cornell_scene
    from ensem3a_openclraytracer_tpu_torch.utils.profiling import rays_per_render

    dev = resolve_device(args.device)
    initialize(device=dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    writer = _rank() == 0
    geom, materials, env, camera = make_cornell_scene(device=dev)
    # 120 divides by 1..6 and 8: the sweep includes rank counts that are
    # not powers of two
    res, spp, mb = args.resolution or 120, args.spp or 16, 4
    records = []

    def emit(rec):
        if writer:
            records.append(rec)
            print(json.dumps(rec), flush=True)

    def measure(mesh) -> Optional[float]:
        """Mrays/s of the gathered render on ``mesh`` (None off the mesh)."""
        if mesh is not None:
            dt = _median_s(lambda i: render_radiance_sharded(
                mesh, geom, materials, env, camera, i, height=res, width=res, spp=spp,
                max_bounce=mb, sun_enabled=False, gather=True), dev)
        if dist.is_initialized():
            dist.barrier()
        return None if mesh is None else rays_per_render(res, spp, mb, False) / dt / 1e6

    base = {"platform": dev.type, "card": card_line(dev),
            "workload": f"cornell {res}^2/{spp}spp/{mb}b"}
    if dev.type == "cpu":
        base["note"] = ("ranks share one host's CPU: efficiency here proves the harness, "
                        "not interconnect scaling")
    rate1 = None
    for n in [c for c in range(1, min(world, 32) + 1) if res % c == 0]:
        mrays = measure(make_mesh(sp=1, world=n))
        if writer:
            rate1 = rate1 or mrays
            emit({"metric": f"scaling_nranks{n}_mrays_per_s", "value": round(mrays, 3),
                  "unit": "Mrays/s", "efficiency": round(mrays / (n * rate1), 3), **base})
    shape_base = None
    for sp in range(1, world + 1) if world > 1 else ():
        if world % sp == 0 and spp % sp == 0 and res % (world // sp) == 0:
            mrays = measure(make_mesh(sp=sp))
            if writer:
                shape_base = shape_base or mrays
                emit({"metric": f"scaling_dp{world // sp}_sp{sp}_mrays_per_s",
                      "value": round(mrays, 3), "unit": "Mrays/s",
                      "vs_first_shape": round(mrays / shape_base, 3), **base})
    if writer and args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(rec) + "\n" for rec in records)
        print(f"scaling sweep -> {args.out}")
    return 0


def cmd_info(args) -> int:
    from ensem3a_openclraytracer_tpu_torch._device import resolve_device

    sc = _load_scene(args.scene, resolve_device(args.device))
    rs = sc.config.render_settings()
    cam = sc.config.camera_settings()
    env = sc.config.environment_settings()
    info = {
        "scene": args.scene,
        "triangles": sc.num_tris,
        "materials": int(sc.material_table.shape[0]),
        "emissive_faces": int(len(sc.light_faces)),
        # triangles in Morton-ordered blocks, each with a bounding box the
        # closest-hit kernels cull by; the CLI builds no tree (a JAX scene
        # over MXU_TRACE_MAX_TRIS would carry one: a TPU rule)
        "accel": "lbvh" if sc.geometry.bvh is not None else "morton-blocks",
        "resolution": rs.resolution,
        "spp": rs.spp,
        "max_bounce": rs.max_bounce,
        "camera": {"position": cam.position, "rotation_deg": cam.rotation_deg,
                   "fov_deg": cam.fov_deg},
        "environment": {"sun_power": env.sun_power, "ibl_power": env.ibl_power,
                        "sun_angles_deg": env.sun_angles_deg, "ibl_file": env.ibl_file},
        "material_table": sc.material_table.tolist(),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_set(args) -> int:
    from ensem3a_openclraytracer_tpu_torch._device import resolve_device

    sc = _load_scene(args.scene, resolve_device(args.device))
    sc.config.setParameter(args.key, args.value)
    print(f"{args.key}={args.value} -> {sc.config.config_path}")
    return 0


def cmd_get(args) -> int:
    from ensem3a_openclraytracer_tpu_torch._device import resolve_device

    sc = _load_scene(args.scene, resolve_device(args.device))
    print(sc.config.getParameter(args.key))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ensem3a_openclraytracer_tpu_torch",
                                description="differentiable path tracer (PyTorch/CUDA)")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain PyTorch path)")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", parents=[common], help="path-trace a scene to PNG")
    r.add_argument("scene", nargs="?", help="scene .obj (default: scenePath from ./config.ini)")
    r.add_argument("--watch", type=int, nargs="?", const=0, default=None,
                   help="re-render when the scene ini changes, reusing the imported "
                        "geometry (N = stop after N re-renders; no N = forever)")
    r.add_argument("--watch-poll", type=float, default=0.5, dest="watch_poll",
                   help="ini poll interval seconds")
    r.add_argument("--resolution", type=int)
    r.add_argument("--spp", type=int)
    r.add_argument("--max-bounce", type=int, dest="max_bounce")
    r.add_argument("--out", help="output PNG path (default output/out.png)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--chunk-spp", type=int, default=16, dest="chunk_spp")
    r.add_argument("--checkpoint", help="progressive .npz checkpoint path (resume if exists)")
    r.add_argument("--restart", action="store_true", help="ignore an existing checkpoint")
    r.add_argument("--tonemap", default="clamp", choices=["clamp", "gamma", "reference_gamma"],
                   help="output transform (reference default: clamp)")
    r.add_argument("--nee", action="store_true",
                   help="next-event estimation (lower variance; needs emissive faces)")
    r.add_argument("--mis", action="store_true",
                   help="balance-heuristic BSDF+NEE combination (implies --nee)")
    r.add_argument("--glass", default="tint", choices=["tint", "refract"],
                   help="glass model: the reference's straight-through tint, or refraction "
                        "with the material ior")
    r.add_argument("--mesh", help="(dp,sp) rank mesh, e.g. 2,2 - or 'auto' (torchrun ranks)")
    r.add_argument("--profile", help="write a torch.profiler Chrome trace into this dir")
    r.add_argument("--verbose", action="store_true")
    r.set_defaults(fn=cmd_render)

    o = sub.add_parser("optimize", parents=[common],
                       help="fit material/env params to a target image")
    o.add_argument("scene")
    o.add_argument("--target", required=True, help="target PNG")
    o.add_argument("--iters", type=int, default=100)
    o.add_argument("--lr", type=float, default=1e-2)
    o.add_argument("--spp", type=int, default=4)
    o.add_argument("--max-bounce", type=int, default=3, dest="max_bounce")
    o.add_argument("--resolution", type=int)
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--out", help="render the fitted scene to this PNG")
    o.add_argument("--dry-run", action="store_true", help="do not write the ini back")
    o.add_argument("--checkpoint", help="optimizer .npz checkpoint (resume if exists)")
    o.add_argument("--checkpoint-every", type=int, default=25, dest="checkpoint_every")
    o.add_argument("--mesh", help="(dp,sp) rank mesh, e.g. 2,2 - or 'auto' (torchrun ranks)")
    o.add_argument("--nee", action="store_true",
                   help="next-event estimation for the optimization renders")
    o.add_argument("--mis", action="store_true",
                   help="balance-heuristic BSDF+NEE combination (implies --nee)")
    o.set_defaults(fn=cmd_optimize)

    b = sub.add_parser("bench", parents=[common], help="throughput benchmark (JSON lines)")
    b.add_argument("--scaling", action="store_true",
                   help="sweep rank counts and (dp,sp) shapes of the torch.distributed world")
    b.add_argument("--resolution", type=int)
    b.add_argument("--spp", type=int)
    b.add_argument("--out", help="also write the scaling records as JSON lines")
    b.set_defaults(fn=cmd_bench)

    i = sub.add_parser("info", parents=[common], help="scene statistics as JSON")
    i.add_argument("scene")
    i.set_defaults(fn=cmd_info)

    s = sub.add_parser("set", parents=[common], help="set a per-scene ini parameter")
    s.add_argument("scene")
    s.add_argument("key")
    s.add_argument("value")
    s.set_defaults(fn=cmd_set)

    g = sub.add_parser("get", parents=[common], help="read a per-scene ini parameter")
    g.add_argument("scene")
    g.add_argument("key")
    g.set_defaults(fn=cmd_get)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
