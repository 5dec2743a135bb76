"""Tree walks head to head on the card: this checkout's ``csrc/bvh_trace.cu``
against other sources of the same C entry point, timed in turns.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.ab_bvh_trace SRC [SRC ...]

Each SRC is a CUDA source with ``bvh_trace_launch``'s C interface, such as
``csrc/bvh_trace.cu`` in a ``git archive`` of another commit.  Each is
built with ``_build``'s nvcc flags (its ptxas registers, stack frame and
spills printed) and launched through ``ops/traversal.trace_bvh`` in place
of this checkout's walk.  On each of ``chip_smoke.py`` phase 13's ray sets
(Cornell 262,144 rays; the 65,536 bounce rays and all 327,680 rays of
outdoor_1300 and outdoor_12500) every walk is held bit-equal to this one in
``t``, ``tri`` and ``hit``, then timed with ``chip_smoke.tree_ms``, warm
and with L2 flushed, in turns: the walks in order, then in reverse, the
mean of the two.  Then phase 13's tree renders are profiled in the same
turns, giving each walk's device time per launch inside the render.  The
last line is one JSON object with every number.  Needs a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]


def _smoke():
    """``chip_smoke.py`` of this checkout, imported as a module."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def build_walks(cs, sources):
    """``[(label, C entry point, ptxas report)]``: this checkout's walk, then
    each source, compiled together."""
    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch.ops import traversal as tv

    logs = _build.build(["bvh_trace"])
    walks = [("this", tv._launcher(), cs.ptxas(logs["bvh_trace"], "bvh_trace_kernel"))]
    procs = []
    for src in map(Path, sources):
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = _build.BUILD_DIR / f"ab_{src.stem}-{tag}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for src, out, proc in procs:
        text = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed on {src}:\n{text}")
        fn = ctypes.CDLL(str(out)).bvh_trace_launch
        fn.argtypes, fn.restype = tv._KERNEL_ARGTYPES, ctypes.c_int
        walks.append((str(src), fn, cs.ptxas(text, "bvh_trace_kernel")))
    return walks


@contextlib.contextmanager
def launching(fn):
    """``trace_bvh`` launches the C entry point ``fn`` inside the block."""
    from ensem3a_openclraytracer_tpu_torch.ops import traversal as tv

    with mock.patch.object(tv, "_launcher", lambda: fn):
        yield


def in_turns(walks, measure) -> dict:
    """``measure()`` under each walk, in order then in reverse: per label,
    the two readings (a dict of numbers each) and their means."""
    got = {label: [] for label, _, _ in walks}
    for label, fn, _ in walks + walks[::-1]:
        with launching(fn):
            got[label].append(measure())
    return {label: dict(turns=r, **{k: sum(x[k] for x in r) / len(r) for k in r[0]})
            for label, r in got.items()}


def ray_sets(cs, dev):
    """Phase 13's ray sets: ``(name, tree pack, rays o, d, timing iterations)``."""
    from ensem3a_openclraytracer_tpu_torch import testing as tt

    scenes = [("cornell", lambda **kw: tt.make_cornell_scene(device=dev, **kw), 10),
              ("outdoor_1300", lambda **kw: tt.make_outdoor_scene(1300, device=dev, **kw), 10),
              ("outdoor_12500", lambda **kw: tt.make_outdoor_scene(12500, device=dev, **kw), 5)]
    for name, make, iters in scenes:
        g_feat, _, _, c = make()
        g = make(use_bvh=True)[0]
        o, d = cs.role_rays(g_feat, c, dev, seed=g_feat.feats.block_bounds.shape[0])
        if name == "cornell":
            yield name, g, o[-262144:].contiguous(), d[-262144:].contiguous(), iters
        else:
            yield name, g, o[-cs.TREE_RAYS:].contiguous(), d[-cs.TREE_RAYS:].contiguous(), iters
            yield f"{name}, all", g, o, d, iters


def main(sources) -> int:
    import torch

    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.ops import traversal as tv
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    if not torch.cuda.is_available():
        print("ab_bvh_trace: no CUDA card", file=sys.stderr)
        return 1
    cs = _smoke()
    dev = torch.device("cuda")
    smi = cs.smi_line()
    walks = build_walks(cs, sources)
    for label, _, regs in walks:
        cs.log(f"[ab] {label}: ptxas {regs}")
    result = dict(card=smi, walks={label: regs for label, _, regs in walks}, rays={},
                  in_render={})

    for name, g, o, d, iters in ray_sets(cs, dev):
        trace = lambda: tv.trace_bvh(g.bvh, g.v0, g.v1, g.v2, o, d)
        ref = trace()
        for label, fn, _ in walks[1:]:
            with launching(fn):
                cs.bit_equal(f"[ab] {name} {o.shape[0]} rays, {label} against this walk",
                             trace(), ref)
        got = in_turns(walks, lambda: dict(ms=cs.tree_ms(trace, iters),
                                           flushed_ms=cs.tree_ms(trace, iters, flush=True)))
        result["rays"][f"{name} ({o.shape[0]} rays)"] = got
        cs.log(f"[ab] {name}, {o.shape[0]} rays, each bit-equal to this walk; ms warm / L2 "
               "flushed, means of two turns: "
               + "; ".join(f"{k} {v['ms']:.4f} / {v['flushed_ms']:.4f}" for k, v in got.items())
               + f" [{smi}]")

    renders = [("cornell", tt.make_cornell_scene, 512, cs.MAIN_SPP),
               ("outdoor_1300", lambda device: tt.make_outdoor_scene(1300, device=device), 512, 16),
               ("outdoor_12500", lambda device: tt.make_outdoor_scene(12500, device=device), 256,
                16)]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, make, res, spp in renders:
            obj = str(Path(tmp) / f"{name}.obj")
            tt.write_scene_files(obj, *make(device="cpu"), resolution=res, spp=spp, max_bounce=4)
            scene = Scene.load(obj, use_bvh=True, device=dev)
            sun = float(scene.env_params().sun_power) != 0.0
            traces = 1 + spp * (4 + 1 + (1 if sun else 0))
            cs.timed_render(scene, {"resolution": 64, "spp": 1}, seed=1)  # warm-up

            def per_launch():
                prof = cs.phase_profile(scene, f"{name}_tree", {}, phase="ab")
                cs.check("bvh_trace_ms" in prof, f"{name}: the profiler saw no device time")
                return dict(ms=prof["bvh_trace_ms"] / traces)

            got = in_turns(walks, per_launch)
            result["in_render"][f"{name} ({res * res} rays, {traces} launches)"] = got
            cs.log(f"[ab] {name} tree render, ms per bvh_trace launch, means of two turns: "
                   + "; ".join(f"{k} {v['ms']:.4f}" for k, v in got.items()) + f" [{smi}]")
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
