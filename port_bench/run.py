"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The run
makes the cell's scene files from the seed and loads them through
``Scene.load``, warms up the cell's own calls (set-up), then runs the
closed-loop window for ``--seconds``.  With ``--trace 1`` a few more
calls run under the profiler.  Then the program's state is freed, the
plain reference (``port_bench/reference``) recomputes the window's
sampled answers, and the last line of standard output is the result: the
cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``), ``correct``, the card, and last the compared numbers with
their limits, which also end standard error.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "ensem3a_openclraytracer_tpu_torch"
TRACE_S = 0.5  # host seconds of calls under the profiler, at least 3 calls and at most 40


def _env(root: Path) -> None:
    """Build and kernel caches in the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def on_card_device(device) -> bool:
    return str(device).startswith("cuda")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def traced_calls(mix, window):
    """A few calls past the window's under the profiler."""
    from torch.profiler import record_function

    from port_bench.harness import trace

    n = min(40, max(3, math.ceil(TRACE_S / window.per_call())))
    with trace.profile() as prof:
        for j in range(n):
            with record_function(trace.CALL):
                mix.call(window.calls + 1000 + j)
    return trace.read(prof)


def main(argv=None, *, device: str = "cuda", root: Path = ROOT, require_card: bool = True) -> int:
    """One run; ``device``, ``root`` and ``require_card`` let the tests drive
    a run on the CPU on a shrunken copy of the benchmark."""
    args = parse(argv)
    _env(root)
    sys.path.insert(0, str(root))
    from port_bench.harness import device as card
    from port_bench.harness.cells import Cell
    from port_bench.harness.isolation import forbidden_modules
    from port_bench.harness.window import closed_loop

    cell = Cell(args.workload, root)
    if require_card:
        card.require_cards(cell.chips)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"port_bench: the program's package {PROGRAM} is not in this checkout",
              file=sys.stderr)
        return 3
    t_import = time.perf_counter()
    import torch

    if on_card_device(device):
        torch.cuda.init()
    t_cuda = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    directory = tempfile.mkdtemp(prefix="port_bench_")
    try:
        mix = cell.kind().Mix(cell, args.seed, device, directory)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0
        window = closed_loop(mix.call, args.seconds, mix.keep)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        t_trace = time.perf_counter()
        traced = traced_calls(mix, window) if args.trace else None
        mix.free()
        t_ref = time.perf_counter()
        numbers = mix.compare()
        t_end = time.perf_counter()
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    from ensem3a_openclraytracer_tpu_torch.ops import launches

    found = forbidden_modules()
    if found:
        print("port_bench: the run loaded " + ", ".join(found), file=sys.stderr)
        return 3
    limits = cell.settings["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    run = SimpleNamespace(window=window, setup_s=setup_s, mix=mix, trace=traced,
                          program_kernels={n for names in launches.KERNELS.values() for n in names})
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = card.info(cell.chips, peak) if on_card else {"platform": "cpu", "count": 0,
                                                        "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": window.calls, "failed": 0, "metrics": metrics,
              "device": info}
    if traced is not None:
        info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    marks = [("python", t_import - T0), ("cuda", t_cuda - t_import),
             ("imports", mix.phases[0][1] - t_cuda)]
    marks += [(n, b - a) for (_, a), (n, b) in zip(mix.phases, mix.phases[1:])]
    print("port_bench: setup " + ", ".join(f"{n} {v:.3f}" for n, v in marks), file=sys.stderr)
    lat = ", ".join(f"p{q} {window.percentile(q) * 1e3:.3f}" for q in (5, 50, 95, 99))
    print(f"port_bench: setup {setup_s:.3f} s, window {window.seconds:.3f} s ({window.calls} "
          f"calls; ms {lat}), trace {t_ref - t_trace:.3f} s, reference {t_end - t_ref:.3f} s, "
          f"card {card.card_line() if on_card else 'none'}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # Python's bytecode cache at a fixed path in the checkout, written even
    # where the environment says not to: the first run compiles the modules
    # it imports (torch's lazily imported ones among them, seconds on a slow
    # disk), later runs read them
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
