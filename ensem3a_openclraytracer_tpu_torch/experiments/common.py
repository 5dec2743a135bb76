"""What the two prototypes share: their rays, their timer and the body of
their ``main``; and what the block queues' tests and experiments share: NEE's
shadow rays, a floor of many blocks, and the benchmark's scenes."""

from __future__ import annotations

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

MAX_RT = 1024  # the most threads a CUDA block may have


def bounce_rays(geom, n: int, seed: int = 0, offset: float = 1e-4):
    """``n`` rays as the prototypes build them: a uniform point on a random
    triangle, a random unit direction (numpy, from ``seed``), the origin
    moved ``offset`` along it.  Returns ``(o, d)`` f32 ``[n, 3]`` on the
    geometry's device."""
    v0, v1, v2 = (x.cpu().numpy() for x in (geom.v0, geom.v1, geom.v2))
    rng = np.random.default_rng(seed)
    ti = rng.integers(0, len(v0), n)
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    p = (v0[ti] * (1 - s)[:, None] + v1[ti] * (s * (1 - r2))[:, None]
         + v2[ti] * (s * r2)[:, None])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dev = geom.v0.device
    return (torch.as_tensor((p + offset * d).astype(np.float32), device=dev),
            torch.as_tensor(d, device=dev))


def shadow_rays(geom, n: int, seed: int = 0, offset: float = 1e-4):
    """``n`` rays as next-event estimation casts them: from a uniform point
    on a random triangle towards a uniform point on another random one
    (numpy, from ``seed``), the origin moved ``offset`` along the
    direction.  Returns ``(o, d)`` f32 ``[n, 3]`` on the geometry's
    device."""
    v0, v1, v2 = (x.cpu().numpy() for x in (geom.v0, geom.v1, geom.v2))
    rng = np.random.default_rng(seed)

    def points():
        ti = rng.integers(0, len(v0), n)
        s, r2 = np.sqrt(rng.random(n)), rng.random(n)
        return (v0[ti] * (1 - s)[:, None] + v1[ti] * (s * (1 - r2))[:, None]
                + v2[ti] * (s * r2)[:, None])

    p, q = points(), points()
    d = q - p
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    dev = geom.v0.device
    return (torch.as_tensor((p + offset * d).astype(np.float32), device=dev),
            torch.as_tensor(d.astype(np.float32), device=dev))


def floor_features(bx: int, by: int, device) -> ch.TriFeatures:
    """The features of a flat floor of ``bx`` x ``by`` triangle blocks
    centred on the origin, each block one unit quad (two triangles; the rest
    of the block repeats the quad's centre, triangles of zero area that are
    never hit), so the side tests are conditioned as on the outdoor
    scenes."""
    x0, y0 = (g.reshape(-1).astype(np.float32) - n / 2 for g, n in
              zip(np.meshgrid(np.arange(bx), np.arange(by), indexing="ij"), (bx, by)))
    z = np.zeros_like(x0)
    corner = lambda dx, dy: np.stack([x0 + dx, y0 + dy, z], axis=-1)  # noqa: E731
    quad = [(corner(0, 0), corner(1, 0), corner(1, 1)), (corner(0, 0), corner(1, 1), corner(0, 1))]
    mid = np.repeat(corner(0.5, 0.5)[:, None], ch.TRI_TILE - 2, axis=1)  # [blocks, 254, 3]
    v = [np.concatenate([quad[0][k][:, None], quad[1][k][:, None], mid], axis=1).reshape(-1, 3)
         for k in range(3)]
    feats = ch.build_tri_features(*v, resolve_device(device))
    if feats.block_bounds.shape[0] != bx * by:
        raise ValueError(f"{bx} x {by} floor packed into {feats.block_bounds.shape[0]} blocks")
    return feats


def floor_sample_inputs(side: int, n: int, device):
    """``(args, kw)`` of a one-bounce fused sample (``max_bounce`` 0, sun) of
    ``n`` lanes on a ``side`` x ``side``-block floor (:func:`floor_features`),
    for ``ops/fused.sample_fused_*(*args, **kw)``: each bounce and sun ray
    leaves a quad's inner part within 45 degrees of the zenith and enters
    its own block alone, so each trace is one round of every lane."""
    dev = resolve_device(device)
    feats = floor_features(side, side, dev)
    tp = feats.edges.shape[-1]
    rng = np.random.default_rng(40)
    xy = np.floor(rng.uniform(-side / 2, side / 2, (n, 2))) + rng.uniform(0.2, 0.8, (n, 2))
    p = torch.as_tensor(np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32), device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3).contiguous()
    attrs = torch.zeros((tp, 8), device=dev)
    attrs[:, 2], attrs[:, 3], attrs[:, 4:7] = 1.0, 1.0, 0.5  # upward normal, diffuse, grey
    args = (feats, attrs, p, up, torch.ones(n, dtype=torch.int32, device=dev),
            torch.full((n, 3), 0.5, device=dev), torch.full((n,), 0.5, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), -up,
            torch.nn.functional.normalize(torch.tensor([0.2, 0.1, 1.0], device=dev), dim=0),
            torch.ones(1, device=dev))
    u = torch.as_tensor(rng.random((1, n, 2)).astype(np.float32), device=dev)
    u[..., 0] *= 0.5  # within 45 degrees of the normal
    return args, dict(max_bounce=0, sun_enabled=True, uniforms=u)


def bench_scene(config: str, device):
    """The benchmark's configuration ``config``'s scene, written from
    ``port_bench/configs/<config>.json`` with the seed 0 (its sky) and
    loaded as its cells load it: ``(geometry, materials, env, camera)``."""
    import json
    import sys
    import tempfile
    from pathlib import Path

    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    root = Path(__file__).resolve().parents[2]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from port_bench.scenes import files

    cfg = json.loads((root / "port_bench" / "configs" / f"{config}.json").read_text())
    with tempfile.TemporaryDirectory() as d:
        s = Scene.load(files.write_scene(cfg, 0, d, device), device=device)
        return s.geometry, s.material_params(), s.env_params(), s.camera_params()


def closedbox(device):
    """The benchmark's ``closedbox15k`` scene (the Cornell box and a
    15,720-triangle glossy sphere, 62 blocks, lit by its panel)."""
    return bench_scene("closedbox15k", device)


def outdoor600k(device):
    """The benchmark's ``outdoor600k`` scene: the ground and 50,000 jittered
    cubes (600,002 triangles, 2,344 blocks) under a sun and an 8192 x 4096
    sky."""
    return bench_scene("outdoor600k", device)


def cuda_median_ms(fn, runs: int = 5) -> float:
    """Median time of ``fn()`` on the card over ``runs`` calls, after one
    warm-up, each call timed with CUDA events."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def run_main(label: str, trace, device: DeviceLike, n: int, n_cubes: int):
    """The body of both prototypes' ``main`` (``proto_grouped.py:190-246``
    of the JAX package, outdoor_``n_cubes`` standing in for the Monkey
    scene): ``trace(feats, o, d)`` on :func:`bounce_rays`, its hit and tri
    mismatches and largest relative ``t`` gap against ``trace_plain``
    printed and returned; on the card also its time against
    ``ops/closest_hit.trace``.  Returns ``(that dict, the trace's fourth
    output)``."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt

    dev = resolve_device(device)
    geom = tt.make_outdoor_scene(n_cubes=n_cubes, device=dev)[0]
    feats = geom.feats
    print("tris", feats.num_tris, "blocks", feats.block_bounds.shape[0])
    o, d = bounce_rays(geom, n)
    t, tri, hit, extra = trace(feats, o, d)
    ref = ch.trace_plain(feats, o, d)
    both = hit & ref.hit
    rel = (t - ref.t).abs() / torch.clamp(ref.t.abs(), min=1e-9)
    out = dict(hit_mismatch=int((hit != ref.hit).sum()),
               tri_same=float((tri[both] == ref.tri[both]).float().mean()) if bool(both.any()) else 1.0,
               t_rel_max=float(rel[both].max()) if bool(both.any()) else 0.0)
    print(f"hit match: {out['hit_mismatch'] == 0} mismatch: {out['hit_mismatch']} "
          f"t rel max: {out['t_rel_max']:.3e} tri same: {out['tri_same']:.4f}")
    if dev.type == "cuda":
        ms = cuda_median_ms(lambda: trace(feats, o, d))
        cur = cuda_median_ms(lambda: ch.trace(geom, o, d))
        print(f"{label}: {ms:.3f} ms  current: {cur:.3f} ms  speedup {cur / ms:.2f}x")
        print(f"{label} Mrays/s: {n / ms / 1e3:.1f}  current: {n / cur / 1e3:.1f}")
        out.update(ms=ms, current_ms=cur)
    return out, extra
