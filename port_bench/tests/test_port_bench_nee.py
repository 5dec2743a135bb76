"""The ``closedbox15k.nee`` cell on the CPU at a small size: its kind
(``kinds/render_overrides``) refuses the overrides its reference does not
follow, comes out correct on the program's lanes and not correct under
each fault, its control and faults read past the cell's limits, and the
two readers of the deployment's counter and span read a stand-in run.

The run skips its look for a card and renders on the CPU at 16^2, 2 spp,
with a sphere of 9 bands x 16 segments (292 triangles, 2 blocks).  The
CPU's scan estimator takes pixel lanes; the fused route, forced, takes
Morton lanes, as the card does, and the reference is told so by
``fused_lane_order``."""

import json
import types

import pytest
import torch

from port_bench import run
from port_bench.harness import control, mix
from port_bench.harness.cells import Cell
from port_bench.harness.trace import Span, TraceRead
from port_bench.reference import render as ref_render

CELL = "closedbox15k.nee"
SEED = 2147483909


@pytest.fixture
def nee_root(tiny_root):
    """The shrunk benchmark with the sphere at 9 bands x 16 segments."""
    path = tiny_root / "port_bench" / "configs" / "closedbox15k.json"
    cfg = json.loads(path.read_text())
    cfg["params"].update(bands=9, segments=16)
    path.write_text(json.dumps(cfg))
    return tiny_root


def result_of(root, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3"],
                  device="cpu", root=root, require_card=False)
    out = capsys.readouterr()
    assert rc == 0
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("overrides", [{"mis": True}, {"fused": True}, {"fused": None},
                                       {"glass_mode": "refract"}, {"spp": 4}])
def test_kind_refuses_what_the_reference_does_not_follow(overrides):
    kind = Cell(CELL).kind()
    with pytest.raises(ValueError, match="does not follow"):
        kind.checked_overrides({"overrides": {"nee": True, **overrides}})


def test_kind_follows_nee_and_tint_glass():
    kind = Cell(CELL).kind()
    assert kind.checked_overrides(Cell(CELL).traffic) == {"nee": True}
    assert kind.checked_overrides({"overrides": {"nee": False, "glass_mode": "tint"}}) == {
        "nee": False}


def render_fault(kind):
    """``render_scene`` broken underneath: half the samples, another seed's
    stream, no NEE, or every light sample on light 0 (each row of the
    light table replaced by the first, as the upstream ``sampleLight``)."""
    from ensem3a_openclraytracer_tpu_torch.models import pathtracer

    sound = pathtracer.render_scene

    def broken(scene, seed=0, overrides=None):
        overrides = dict(overrides or {})
        if kind == "half_batch":
            overrides["spp"] = scene.config.render_settings().spp // 2
        elif kind == "altered":
            seed = seed + 1
        elif kind == "no_nee":
            overrides["nee"] = False
        elif kind == "first_light":
            pack = scene.light_pack

            def first(materials=None):
                lights = pack(materials)
                return type(lights)(*(x[:1].expand_as(x).contiguous() for x in lights))

            scene.light_pack = first
        return sound(scene, seed, overrides)

    return broken


@pytest.mark.parametrize("route", ["scan", "fused"])
@pytest.mark.parametrize("fault", [None, "half_batch", "altered", "no_nee", "first_light"])
def test_render_faults_are_not_correct(nee_root, capsys, monkeypatch, route, fault):
    from ensem3a_openclraytracer_tpu_torch.models import pathtracer

    if route == "fused":  # the card's route and lanes
        sound = pathtracer.render_scene
        monkeypatch.setattr(pathtracer, "render_scene", lambda scene, seed=0, overrides=None:
                            sound(scene, seed, {**(overrides or {}), "fused": True}))
        monkeypatch.setattr(ref_render, "fused_lane_order", lambda scene, device: True)
    if fault is not None:
        monkeypatch.setattr(pathtracer, "render_scene", render_fault(fault))
    result = result_of(nee_root, capsys)
    assert result["correct"] is (fault is None), result["checks"]


def test_control_and_faults_fail_at_a_small_size(nee_root):
    cell = Cell(CELL, nee_root)
    readings = control.readings(cell, 2147483653, "cpu")
    assert sorted(readings) == ["altered", "control", "first_light", "half_batch", "no_nee"]
    for kind, numbers in readings.items():
        assert any(numbers[k] > v for k, v in cell.settings["limits"].items()), (kind, numbers)


def test_compare_counts_the_nee_shadow_rays(nee_root):
    """The kind's work for the roofline counts the reference's NEE shadow
    segments among its segments."""
    cell = Cell(CELL, nee_root)
    kind = cell.kind()
    scene = mix.reference_scene(cell, SEED, "cpu")
    pixels = torch.arange(scene.resolution ** 2)
    with_nee, without = (dict(segments=0, lanes=0, sun=0, nee=0) for _ in "ab")
    kind.reference_images(cell, scene, [SEED], pixels, tally=with_nee)
    kind.reference_images(cell, scene, [SEED], pixels, tally=without, nee=False)
    assert with_nee["nee"] > 0 and without["nee"] == 0
    assert with_nee["segments"] == with_nee["lanes"] + with_nee["nee"]  # no sun in the box


@pytest.fixture
def record():
    from ensem3a_openclraytracer_tpu_torch.utils import profiling

    profiling.clear_counters()
    yield profiling
    profiling.clear_counters()


def _run(trace):
    return types.SimpleNamespace(trace=trace)


def test_nee_rays_per_lane_reads_the_fused_queue_record(record):
    read = Cell(CELL).reader("nee_rays_per_lane.render")
    run_ = _run(TraceRead(calls=[Span("port_bench.call", 0.0, 1.0)], device=[], host=[]))
    assert read(run_) is None and read(_run(None)) is None  # nothing recorded
    from ensem3a_openclraytracer_tpu_torch.ops.fused import queue_stats_fields

    old = tuple(f for f in queue_stats_fields(1) if f != "nee_rays")  # a program without it
    record.record_counters("fused_queue", torch.tensor([7] * len(old)), old)
    assert read(run_) is None
    record.clear_counters()
    fields = queue_stats_fields(1)
    for nee, lanes in ((30, (60, 40)), (10, (40, 60))):
        named = dict.fromkeys(fields, 0)
        named.update({"nee_rays": nee, "lanes.0": lanes[0], "lanes.1": lanes[1]})
        record.record_counters("fused_queue", torch.tensor([named[f] for f in fields]), fields)
    assert read(run_) == pytest.approx(40 / 200)


def test_lights_ms_is_the_mean_span_inside_each_call():
    read = Cell(CELL).reader("lights_ms.render")
    calls, host = [], []
    for j, ms in enumerate((1.0, 2.0, 3.0)):
        t = 10.0 + j
        calls.append(Span("port_bench.call", t, t + 0.5))
        host += [Span("render_scene", t + 0.001, t + 0.4),
                 Span("render_scene.lights", t + 0.002, t + 0.002 + ms * 1e-3)]
    host.append(Span("render_scene.lights", 30.0, 30.5))  # outside every call: not read
    assert read(_run(TraceRead(calls=calls, device=[], host=host))) == pytest.approx(2.0)
    bare = [h for h in host if h.name != "render_scene.lights"]
    assert read(_run(TraceRead(calls=calls, device=[], host=bare))) is None
    assert read(_run(None)) is None


def test_the_cell_reports_its_metrics():
    cell = Cell(CELL)
    e2e = {m["name"] for m in cell.metrics(False)}
    traced = {m["name"] for m in cell.metrics(True)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert {"nee_rays_per_lane.render", "lights_ms.render", "roofline.render"} <= traced
    for m in e2e | traced:
        assert callable(cell.reader(m))
