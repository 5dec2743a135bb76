"""Pair-compaction kernels head to head on the card: this checkout's
``csrc/pair_compact.cu`` against other sources, timed in turns.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.ab_pair_compact \\
        [--slot-keys SRC ...] [--row-major SRC ...] [--packed SRC ...]

Three C interfaces of ``pair_compact_launch`` are taken:

- ``--slot-keys``: the kernel before its redesign, which writes one key per
  queue slot on row-major features (rays, ``edges``, ``plane``,
  ``normal_d``, ``block_bounds``, the queues, the keys, stats, stream);
  each round's keys are then folded by ``proto_compact.combine``.  Its
  source is ``csrc/pair_compact.cu`` in a ``git archive`` of that commit::

      git archive b84ca82 ensem3a_openclraytracer_tpu_torch/csrc | tar -x -C build/parent

- ``--row-major``: the same arguments, but the pointer after the queues is
  ``best_key [n + 1]``, lowered in place (a kernel that folds on row-major
  features);
- ``--packed``: this checkout's interface (``TriFeatures.packed``, folding
  into ``best_key``), such as a variant of this checkout's kernel.

Every source is built with ``_build``'s nvcc flags (its ptxas registers,
stack frame and spills printed).  On ``chip_smoke.py`` phase 9's rays
(65,536 rays as the prototypes build them on outdoor_1300 and
outdoor_12500) the rounds' queues are recorded once, from one
``trace_compact``; every kernel folds them from no hit and is held bit-equal
to this checkout's ``best_key``, its pairs tested and stagings are read, and
each is timed with ``chip_smoke.tree_ms`` in turns (in order, then in
reverse, the mean of the two): the kernel alone over the rounds, the kernel
with its fold over the rounds (for ``--slot-keys``, the launches and
``combine``; the others fold inside the kernel), and the whole trace
(``proto_compact.trace_rounds``).  The last line is one JSON object with
every number.  Needs a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

from ensem3a_openclraytracer_tpu_torch.experiments.ab_bvh_trace import _smoke

# pair_compact_launch on row-major features; the int64 pointer after the
# queues is the per-slot keys (--slot-keys) or best_key (--row-major)
ROW_MAJOR_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # ray_o, ray_d, n
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3  # edges, plane, normal_d, bounds; tp, tile, nb
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2  # queue_rid, tile_blk, tile_live; tiles, rt
    + [ctypes.c_void_p] * 3  # keys or best_key, stats, stream
)
SCENES = (("outdoor_1300", 1300, 5), ("outdoor_12500", 12500, 3))  # name, cubes, iterations
KINDS = ("slot-keys", "row-major", "packed")


def build_sources(cs, sources):
    """``[(label, kind, C entry point, ptxas report)]`` of each ``(kind,
    path)``, compiled together with ``_build``'s flags."""
    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact as pc

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for kind, path in sources:
        src = Path(path)
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = _build.BUILD_DIR / f"ab_{src.stem}-{tag}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((kind, src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    built = []
    for kind, src, out, proc in procs:
        text = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed on {src}:\n{text}")
        fn = ctypes.CDLL(str(out)).pair_compact_launch
        fn.argtypes = pc._KERNEL_ARGTYPES if kind == "packed" else ROW_MAJOR_ARGTYPES
        fn.restype = ctypes.c_int
        built.append((f"{kind}:{src}", kind, fn, cs.ptxas(text, "pair_compact_kernel")))
    return built


def launcher(kind, fn, feats, dev, slots):
    """``(launch, fold)`` of one entry point, both with a round's fold
    signature ``(feats, o, d, q, best_key, stats)``: ``launch`` runs the
    kernel alone (for ``slot-keys`` into a buffer of ``slots`` keys), and
    ``fold`` then folds that buffer into ``best_key`` by ``combine``."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact as pc

    nb, tp = feats.block_bounds.shape[0], feats.edges.shape[-1]
    keys = torch.empty(slots, dtype=torch.int64, device=dev)
    if kind == "packed":
        features = (feats.packed,)
    else:
        features = (feats.edges, feats.plane, feats.normal_d, feats.block_bounds)

    def launch(f, o, d, q, best_key, stats=None):
        out = keys if kind == "slot-keys" else best_key
        tiles = q.tile_blk.numel()
        err = fn(o.data_ptr(), d.data_ptr(), o.shape[0], *(x.data_ptr() for x in features),
                 tp, tp // nb, nb, q.queue_rid.data_ptr(), q.tile_blk.data_ptr(),
                 q.tile_live.data_ptr(), tiles, q.queue_rid.numel() // tiles, out.data_ptr(),
                 None if stats is None else stats.data_ptr(),
                 torch.cuda.current_stream(o.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pair_compact_launch failed: CUDA error {err}")
        return best_key

    def fold(f, o, d, q, best_key, stats=None):
        launch(f, o, d, q, best_key, stats)
        return pc.combine(best_key, keys, q.queue_rid) if kind == "slot-keys" else best_key

    return launch, fold


def main(sources) -> int:
    import torch

    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.experiments import common
    from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact as pc

    if not torch.cuda.is_available():
        print("ab_pair_compact: no CUDA card", file=sys.stderr)
        return 1
    cs = _smoke()
    dev = torch.device("cuda")
    smi = cs.smi_line()
    logs = _build.build(["pair_compact"])
    kernels = [("this", "this", None, cs.ptxas(logs["pair_compact"], "pair_compact_kernel"))]
    kernels += build_sources(cs, sources)
    for label, _, _, regs in kernels:
        cs.log(f"[ab] {label}: ptxas {regs}")
    result = dict(card=smi, kernels={label: regs for label, _, _, regs in kernels}, scenes={})

    for name, cubes, iters in SCENES:
        g = tt.make_outdoor_scene(n_cubes=cubes, device=dev)[0]
        f = g.feats
        o, d = common.bounce_rays(g, cs.PROTO_RAYS)
        queues = []
        pc.trace_compact(f, o, d, queues=queues)
        slots = queues[0].queue_rid.numel()
        arms = {}
        for label, kind, fn, _ in kernels:
            if fn is None:
                arms[label] = (pc.pair_compact, pc.pair_compact)
            else:
                arms[label] = launcher(kind, fn, f, dev, slots)
        ref = cs.compact_fold(f, o, d, queues, pc.pair_compact)[0]
        counts = {}
        for label, (_, fold) in arms.items():
            best, stats = cs.compact_fold(f, o, d, queues, fold)
            differ = int((best != ref).sum())
            cs.check(differ == 0, f"[ab] {name}: {label} differs from this kernel on {differ} rays")
            counts[label] = dict(pairs_per_ray=int(stats[0]) / cs.PROTO_RAYS,
                                 stagings=int(stats[1]))
        scratch = ref.clone()
        timed = {}
        for label, (launch, fold) in arms.items():
            timed[label] = dict(
                kernel=lambda launch=launch: [launch(f, o, d, q, scratch) for q in queues],
                fold=lambda fold=fold: [fold(f, o, d, q, scratch) for q in queues],
                trace=lambda fold=fold: pc.trace_rounds(f, o, d, fold))
        got = {label: {m: [] for m in ("kernel", "fold", "trace")} for label in arms}
        for label in list(arms) + list(arms)[::-1]:
            for m, fn in timed[label].items():
                got[label][m].append(cs.tree_ms(fn, iters))
        scene = {label: dict(**{f"{m}_ms": sum(t) / len(t) for m, t in ms.items()},
                             turns=ms, **counts[label]) for label, ms in got.items()}
        result["scenes"][name] = dict(blocks=f.block_bounds.shape[0], rays=cs.PROTO_RAYS,
                                      rounds=len(queues), kernels=scene)
        cs.log(f"[ab] {name} ({f.block_bounds.shape[0]} blocks, {cs.PROTO_RAYS} rays, "
               f"{len(queues)} rounds), each bit-equal to this kernel; per trace ms (tree_ms, "
               "mean of two turns): kernel / kernel with fold / whole trace, pairs per ray, "
               "stagings: " + "; ".join(
                   f"{k} {v['kernel_ms']:.4f} / {v['fold_ms']:.4f} / {v['trace_ms']:.4f}, "
                   f"{v['pairs_per_ray']:.1f}, {v['stagings']}" for k, v in scene.items())
               + f" [{smi}]")
    cs.log(json.dumps(result))
    return 0


def parse(args):
    """``[(kind, path)]`` from ``--slot-keys``/``--row-major``/``--packed``
    groups of paths."""
    out, kind = [], None
    for a in args:
        if a.startswith("--"):
            kind = a[2:]
            if kind not in KINDS:
                raise SystemExit(f"unknown option {a}: want --{', --'.join(KINDS)}")
        elif kind is None:
            raise SystemExit(f"{a}: name its interface first (--{', --'.join(KINDS)})")
        else:
            out.append((kind, a))
    return out


if __name__ == "__main__":
    sys.exit(main(parse(sys.argv[1:])))
