"""How often a torch.profiler trace of a render's graph replay loses the
records of kernels that ran, with and without ``ops/launches.trace``'s
margins of idle time at each end of the window.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.trace_window [--runs N]

Loads ``chip_smoke.py`` phase 3's outdoor_12500 scene (256^2, 16 spp,
4 bounces; ``pairs`` once, ``fused_queue`` once per sample) and renders it
once with the launch counts set to 0 (the eager warm-up, which captures
``render_radiance_jit``'s graph).  Then it traces N replays with a margin
of 0 (the window opens just before the render and closes just after its
synchronize) and N with ``TRACE_MARGIN_S``, in turns.  For each margin it
prints the traces whose port kernels, counted by ``launches.count_kernels``,
differ from the warm-up's launches, and the first device record's time
after the first host record in the window (min, median, max, in µs).
The last line is one JSON object.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _smoke():
    """``chip_smoke.py`` of this checkout, imported as a module."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def one_trace(scene, margin_s: float, seed: int) -> dict:
    """One replay of ``scene``'s render traced with ``margin_s``: the port's
    kernels the trace saw, by counter, and where its device records lie."""
    import torch

    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene
    from ensem3a_openclraytracer_tpu_torch.ops import launches

    with launches.trace(margin_s) as prof:
        render_scene(scene, seed=seed)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = min(ev.start_ns() for ev in events if ev.device_type() != cuda)
    device = sorted(ev.start_ns() for ev in events if ev.device_type() == cuda)
    seen = launches.count_kernels(ev.name() for ev in events if ev.device_type() == cuda)
    return dict(seen=seen, records=len(device),
                first_device_us=(device[0] - host) / 1e3 if device else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=300, help="traces per margin")
    args = ap.parse_args(argv)
    import torch

    from ensem3a_openclraytracer_tpu_torch import _build
    from ensem3a_openclraytracer_tpu_torch import testing as tt
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene
    from ensem3a_openclraytracer_tpu_torch.ops import launches

    cs = _smoke()
    _build.build()
    smi = cs.smi_line()
    scn = dict(name="outdoor_12500", scene="outdoor_12500", render=(256, 16, 4),
               make=lambda d: tt.make_outdoor_scene(n_cubes=12500, device=d))
    (ROOT / "build").mkdir(exist_ok=True)
    margins = (0.0, launches.TRACE_MARGIN_S)
    rows = {m: [] for m in margins}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        scene, _ = cs.load_scene(scn, torch.device("cuda"), Path(tmp))
        cs.reset_launches()
        render_scene(scene, seed=1)
        torch.cuda.synchronize()
        want = cs.read_launches()
        for i in range(args.runs):
            for m in margins:
                rows[m].append(one_trace(scene, m, seed=2 + i))
    result = dict(card=smi, scene=scn["name"], runs=args.runs, launches=want, margins=[])
    for m in margins:
        lost = [r for r in rows[m] if r["seen"] != want]
        first = sorted(r["first_device_us"] for r in rows[m] if r["first_device_us"] is not None)
        line = dict(margin_s=m, traces_losing_kernels=len(lost),
                    lost_examples=[dict(seen={k: v for k, v in r["seen"].items() if v},
                                        records=r["records"],
                                        first_device_us=r["first_device_us"]) for r in lost[:5]],
                    first_device_us=[first[0], first[len(first) // 2], first[-1]] if first else None)
        print(f"[trace_window] margin {m} s: {len(lost)} of {args.runs} traces lost port kernels "
              f"[{smi}]", flush=True)
        result["margins"].append(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
