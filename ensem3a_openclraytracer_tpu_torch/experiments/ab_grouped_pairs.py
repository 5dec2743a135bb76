"""Grouped-pair kernels head to head on the card: this checkout's
``csrc/grouped_pairs.cu`` against other sources, timed in turns.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.ab_grouped_pairs SRC [SRC ...] [--packed SRC ...]

Each SRC before ``--packed`` is a CUDA source whose ``grouped_pairs_launch``
takes the row-major features (rays, ``edges``, ``plane``, ``normal_d``,
``block_bounds``, the schedule, outputs, stats, stream), as the kernel did
before its redesign: ``csrc/grouped_pairs.cu`` in a ``git archive`` of
that commit::

    git archive e6660c1 ensem3a_openclraytracer_tpu_torch/csrc | tar -x -C build/parent

Each SRC after ``--packed`` has this checkout's C interface (the packed
features), such as a variant of this checkout's kernel.  Every source is
built with ``_build``'s nvcc flags (its ptxas registers, stack frame and
spills printed) and called through its own ctypes signature.  On
``chip_smoke.py`` phase 8's rays (65,536 rays as the prototypes build them
on outdoor_1300 and outdoor_12500, one ``build_schedule`` each) every
kernel is held bit-equal to this checkout's in ``t``, ``tri`` and ``hit``,
its pairs tested and stagings are read, and all are timed with
``chip_smoke.tree_ms`` in turns: in order, then in reverse, the mean of the
two.  The last line is one JSON object with every number.  Needs a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

from ensem3a_openclraytracer_tpu_torch.experiments.ab_bvh_trace import _smoke

# grouped_pairs_launch on row-major features
ROW_MAJOR_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # ray_o, ray_d, n, rt
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3  # edges, plane, normal_d, bounds; tp, tile, nb
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]  # offsets, blk, lod; tiles
    + [ctypes.c_void_p] * 4  # out_t, out_tri, stats, stream
)
SCENES = (("outdoor_1300", 1300, 5), ("outdoor_12500", 12500, 3))  # name, cubes, iterations


def build_sources(cs, sources, packed=()):
    """``[(label, C entry point, ptxas report)]`` of each source, compiled
    together with ``_build``'s flags: ``sources`` on row-major features,
    ``packed`` with this checkout's interface (labelled ``packed:<path>``)."""
    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch.experiments import proto_grouped as pg

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, on_packed in [(Path(x), False) for x in sources] + [(Path(x), True) for x in packed]:
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = _build.BUILD_DIR / f"ab_{src.stem}-{tag}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((src, on_packed, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
    built = []
    for src, on_packed, out, proc in procs:
        text = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed on {src}:\n{text}")
        fn = ctypes.CDLL(str(out)).grouped_pairs_launch
        fn.argtypes = pg._KERNEL_ARGTYPES if on_packed else ROW_MAJOR_ARGTYPES
        fn.restype = ctypes.c_int
        built.append((f"packed:{src}" if on_packed else str(src), fn,
                      cs.ptxas(text, "grouped_pairs_kernel")))
    return built


def row_major_call(fn, feats, sched, stats=None):
    """``(t, tri)`` of the schedule's rays through an entry point on
    row-major features."""
    return _call(fn, (feats.edges, feats.plane, feats.normal_d), feats, sched, stats)


def packed_call(fn, feats, sched, stats=None):
    """``(t, tri)`` of the schedule's rays through an entry point with this
    checkout's C interface."""
    return _call(fn, (feats.packed,), feats, sched, stats)


def _call(fn, features, feats, sched, stats):
    import torch

    n, g, dev = sched.n, sched.offsets.numel() - 1, sched.o.device
    nb = feats.block_bounds.shape[0]
    tp = feats.edges.shape[-1]
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    err = fn(sched.o.data_ptr(), sched.d.data_ptr(), n, sched.rt,
             *(x.data_ptr() for x in features), feats.block_bounds.data_ptr(), tp, tp // nb, nb,
             sched.offsets.data_ptr(), sched.blk.data_ptr(), sched.lod.data_ptr(), g,
             out_t.data_ptr(), out_tri.data_ptr(), None if stats is None else stats.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_pairs_launch failed: CUDA error {err}")
    return out_t, out_tri


def main(sources, packed=()) -> int:
    import torch

    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.experiments import common
    from ensem3a_openclraytracer_tpu_torch.experiments import proto_grouped as pg
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

    if not torch.cuda.is_available():
        print("ab_grouped_pairs: no CUDA card", file=sys.stderr)
        return 1
    cs = _smoke()
    dev = torch.device("cuda")
    smi = cs.smi_line()
    logs = _build.build(["grouped_pairs"])
    kernels = [("this", None, cs.ptxas(logs["grouped_pairs"], "grouped_pairs_kernel"))]
    kernels += build_sources(cs, sources, packed)
    for label, _, regs in kernels:
        cs.log(f"[ab] {label}: ptxas {regs}")
    result = dict(card=smi, kernels={label: regs for label, _, regs in kernels}, scenes={})

    for name, cubes, iters in SCENES:
        g = tt.make_outdoor_scene(n_cubes=cubes, device=dev)[0]
        o, d = common.bounce_rays(g, cs.PROTO_RAYS)
        sched = pg.build_schedule(g.feats, o, d)

        def run_of(label, fn):
            if fn is None:
                return lambda s=None: pg.grouped_pairs(g.feats, sched, s)
            call = packed_call if label.startswith("packed:") else row_major_call
            return lambda s=None: call(fn, g.feats, sched, s)

        runs = {label: run_of(label, fn) for label, fn, _ in kernels}
        ref = ch.Hit(*pg.unsort(sched, *runs["this"]()))
        counts = {}
        for label, run in runs.items():
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            h = ch.Hit(*pg.unsort(sched, *run(stats)))
            if label != "this":
                cs.bit_equal(f"[ab] {name}: {label} against this kernel", h, ref)
            counts[label] = dict(pairs_per_ray=int(stats[0]) / sched.n, stagings=int(stats[1]))
        got = {label: [] for label in runs}
        for label in list(runs) + list(runs)[::-1]:
            got[label].append(cs.tree_ms(runs[label], iters))
        scene = {label: dict(ms=sum(t) / len(t), turns=t, **counts[label])
                 for label, t in got.items()}
        result["scenes"][name] = dict(blocks=g.feats.block_bounds.shape[0], rays=sched.n,
                                      kernels=scene)
        cs.log(f"[ab] {name} ({g.feats.block_bounds.shape[0]} blocks, {sched.n} rays), each "
               "bit-equal to this kernel; ms (tree_ms, mean of two turns), pairs per ray, "
               "stagings: " + "; ".join(
                   f"{k} {v['ms']:.4f} / {v['pairs_per_ray']:.1f} / {v['stagings']}"
                   for k, v in scene.items()) + f" [{smi}]")
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    cut = args.index("--packed") if "--packed" in args else len(args)
    sys.exit(main(args[:cut], args[cut + 1:]))
