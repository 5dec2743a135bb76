"""The ``texel8k.grad`` cell on the CPU at a small size: its kind
(``kinds/optimize_blocks``) comes out correct on the program's lanes and
not correct under each fault, its control and faults read past the
cell's limits, the three readers of the deployment's counters and work
read a stand-in run, and the work count of ``roofline.opt`` stays under a
plain step's.

The run skips its look for a card and steps on the CPU at 16^2, 2 spp, on
30 cubes (2 blocks) under a 64 x 32 sky.  The CPU's recorder takes pixel
lanes; the fused recorder's route, forced, takes Morton lanes, as the card
does, and the reference is told so by ``fused_lane_order``."""

import functools
import json
import types

import pytest
import torch

from port_bench import run
from port_bench.harness import control, counts, step_work
from port_bench.harness.cells import Cell
from port_bench.harness.trace import Span
from port_bench.reference import render as ref_render

CELL = "texel8k.grad"
SEED = 2147483907


@pytest.fixture
def texel_root(tiny_root):
    """The shrunk benchmark with the ``optimize_blocks`` mix at 16^2, 2 spp."""
    path = tiny_root / "port_bench" / "traffic" / "optimize_blocks.json"
    mix = json.loads(path.read_text())
    mix.update(resolution_cap=16, spp=2)
    path.write_text(json.dumps(mix))
    return tiny_root


def result_of(root, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3"],
                  device="cpu", root=root, require_card=False)
    out = capsys.readouterr()
    assert rc == 0
    return json.loads(out.out.strip().splitlines()[-1])


def force_morton(monkeypatch):
    """The program on the fused recorder (Morton lanes on 2 blocks), and
    the reference told that the program takes Morton lanes."""
    from ensem3a_openclraytracer_tpu_torch.models import optimize, replay

    monkeypatch.setattr(optimize, "radiance_for_rays_replay",
                        functools.partial(replay.radiance_for_rays_replay, fused=True))
    monkeypatch.setattr(ref_render, "fused_lane_order", lambda scene, device: True)


@pytest.mark.parametrize("route", ["scan", "fused"])
def test_the_cell_is_correct_on_the_programs_lanes(texel_root, capsys, monkeypatch, route):
    if route == "fused":
        force_morton(monkeypatch)
    result = result_of(texel_root, capsys)
    assert result["correct"] is True
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "texel_gap"}
    assert set(result["metrics"]) == {"opt_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "pixel_lanes"])
def test_the_cell_is_not_correct_under_a_fault(texel_root, capsys, monkeypatch, fault):
    from ensem3a_openclraytracer_tpu_torch.models import optimize, replay

    sound_make, sound_gen = optimize.make_train_step, optimize.iteration_generator

    def make(*args, spp, **kw):
        init, step = sound_make(*args, spp=spp // 2 if fault == "half_batch" else spp, **kw)
        if fault != "unchanged":
            return init, step
        return init, lambda p, s, t, g: (p, s) + tuple(step(p, s, t, g)[2:])

    monkeypatch.setattr(optimize, "make_train_step", make)
    if fault == "altered":
        monkeypatch.setattr(optimize, "iteration_generator",
                            lambda seed, i, device=None: sound_gen(seed, i + 1, device))
    if fault == "pixel_lanes":  # the program on Morton lanes, the reference on pixel lanes
        monkeypatch.setattr(optimize, "radiance_for_rays_replay",
                            functools.partial(replay.radiance_for_rays_replay, fused=True))
    assert result_of(texel_root, capsys)["correct"] is False


def test_control_and_faults_read_past_the_limits(texel_root):
    cell = Cell(CELL, texel_root)
    limits = cell.settings["limits"]
    readings = control.readings(cell, SEED, "cpu")
    assert set(readings) == {"control", "half_batch", "altered", "unchanged", "pixel_lanes"}
    for name, numbers in readings.items():
        assert set(numbers) == set(limits)
        assert any(numbers[k] > limits[k] for k in limits), name
    assert readings["pixel_lanes"]["texel_gap"] > 10 * limits["texel_gap"]


@pytest.fixture
def record():
    from ensem3a_openclraytracer_tpu_torch.utils import profiling

    profiling.clear_counters()
    yield profiling
    profiling.clear_counters()


def _run(calls=4, busy_s=0.2, work=None):
    spans = [Span("port_bench.call", j, j + 0.5) for j in range(calls)]
    trace = types.SimpleNamespace(calls=spans, busy_s=busy_s)
    return types.SimpleNamespace(trace=trace, mix=types.SimpleNamespace(counts=work))


def test_the_counter_readers(record):
    copies = Cell(CELL).reader("state_copy_gb.opt")
    sweep = Cell(CELL).reader("scatter_entries_per_lane.opt")
    run_ = _run()
    assert copies(run_) is None and sweep(run_) is None  # nothing recorded (the parent)
    for _ in range(4):
        record.record_counters("graphs", torch.tensor([1, 1_200_000_000, 1_300_000_000]),
                               ("calls", "copy_in_bytes", "clone_out_bytes"))
        record.record_counters("scatter", torch.tensor([3, 1000, 250_000]),
                               ("calls", "lanes", "entries"))
    assert copies(run_) == pytest.approx(2.5)
    assert sweep(run_) == pytest.approx(250.0)
    assert copies(types.SimpleNamespace(trace=None)) is None
    assert sweep(types.SimpleNamespace(trace=None)) is None


def test_the_roofline_reader():
    read = Cell(CELL).reader("roofline.opt")
    work = dict(segments=2e6, lanes=1e6, sun=5e5, bytes=3.35e8)
    least = max((45 * 2e6 + 148 * 1e6 + 27 * 5e5) / 67e12, 3.35e8 / 3.35e12)
    assert read(_run(calls=4, busy_s=0.2, work=work)) == pytest.approx(100 * least / 0.05)
    assert read(_run(work=None)) is None


def test_the_step_work_is_at_most_a_plain_steps(texel_root):
    """On a plain step, computed by the reference at the cell's small size:
    the counted work is that step's forward and a dense Adam's bytes over
    the values it reached, so its least time is no more than that of a
    step which traces the same paths and passes over every value once,
    the dense sweep the program makes: ``roofline.opt`` <= 100 %."""
    from port_bench.kinds import optimize_blocks

    cell = Cell(CELL, texel_root)
    scene = optimize_blocks.mix.reference_scene(cell, SEED, "cpu")
    kw = optimize_blocks.optimize.step_settings(cell, scene.resolution)
    target = optimize_blocks.optimize.make_target(SEED, kw["resolution"], "cpu")
    tally = dict(segments=0, lanes=0, sun=0)
    steps = optimize_blocks.ref_lanes.train_steps(scene, target, SEED, 3, morton=False,
                                                  counts=tally, **kw)
    work = step_work.step_counts(scene, tally, steps[-1]["nu"], kw["resolution"])
    values = sum(v.numel() for v in steps[-1]["nu"].values())
    texels = steps[-1]["nu"]["ibl"].numel()
    live = int(torch.count_nonzero(steps[-1]["nu"]["ibl"]))
    assert 0 < live < texels and tally["segments"] > 0 and tally["sun"] > 0
    dense = counts.least_seconds(work["segments"], work["lanes"], work["sun"],
                                 step_work.BYTES_PER_LIVE_VALUE * values + scene.input_bytes())
    least = counts.least_seconds(work["segments"], work["lanes"], work["sun"], work["bytes"])
    assert 0 < least <= dense
    read = cell.reader("roofline.opt")
    assert read(_run(calls=1, busy_s=dense, work=work)) <= 100.0
