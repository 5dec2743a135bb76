"""What the two prototypes share: their rays, their timer and the body of
their ``main``."""

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
