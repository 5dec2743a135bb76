"""Next-event estimation on a closed box of several triangle blocks, held
against the benchmark's plain NEE reference (``port_bench/reference/nee``),
and the deployment's scene, counter and span.

The scene is the benchmark's ``closedbox15k`` configuration at test size:
the Cornell box and a glossy UV sphere of 9 bands x 16 segments (256 + 36
= 292 triangles, 2 blocks), lit by its panel alone, written as OBJ + ini
and read by both sides, rendered through ``render_scene(scene, seed,
overrides={"nee": True})`` at 16^2, 4 spp, 4 bounces.  The scan estimator
(the CPU's default) takes pixel lanes; the fused engine's route
(``fused=True``: its plain versions on the CPU, as on the card its
kernels) takes the Morton order of the primary hits.  Each is compared
with the reference on its own lanes, and fails the same tolerances on the
other order, without NEE, and with every light sample on light 0."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ensem3a_openclraytracer_tpu_torch.models import pathtracer as pt
from ensem3a_openclraytracer_tpu_torch.ops import fused as tf
from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene
from ensem3a_openclraytracer_tpu_torch.utils import profiling
from port_bench.harness.compare import render_numbers
from port_bench.reference import nee as ref_nee
from port_bench.reference import render as ref_render
from port_bench.reference import scene as ref_scene
from port_bench.scenes import closedbox, cornell, files
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

CONFIG = Path(__file__).resolve().parents[1] / "port_bench" / "configs" / "closedbox15k.json"
RES, SPP, MB, BANDS, SEGMENTS = 16, 4, 4, 9, 16
SEEDS = (2147483903, 11)
# Float32 on both sides and the same paths: the program and the reference
# each shade in their own order of operations (the kernels' plain versions
# and the scan estimator against the reference's per-pass arithmetic), a
# few float32 ulps a lane, ~1e-8 of a pixel's mean (at most 1.3e-7 seen).
# A light sample that flips visible on a rounding difference (a knife edge
# at the panel's rim) moves one pixel by ~1e-2 at 4 spp, so up to 2 of
# the 256 pixels may fork.  Another random stream, another estimator or
# another light moves nearly every pixel by 1e-3 or more (0.91-0.94 of
# them) and the mean by 0.06 or more.
FORK_ABS, FORK_SHARE, MEAN_ABS = 1e-3, 2.0 / (RES * RES), 1e-5


def _config(**params):
    cfg = json.loads(CONFIG.read_text())
    cfg["params"].update(params)
    cfg["ini"].update(resolution=RES, spp=SPP, maxBounce=MB)
    return cfg


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The program's and the reference's scene, from the same files."""
    obj = files.write_scene(_config(bands=BANDS, segments=SEGMENTS), 3,
                            str(tmp_path_factory.mktemp("closedbox")), "cpu")
    return Scene.load(obj, device="cpu"), ref_scene.load(obj, "cpu")


@pytest.fixture(scope="module")
def renders(scenes):
    """Per seed: the program's images by engine, the reference's by lane
    order, and the two faults on the engine's lanes."""
    scene, ref = scenes
    pixels = torch.arange(RES * RES)
    out = {}
    for seed in SEEDS:
        prog = {"scan": pt.render_scene(scene, seed, {"nee": True}).reshape(-1, 3),
                "fused": pt.render_scene(scene, seed, {"nee": True, "fused": True}).reshape(-1, 3)}
        lanes = {"scan": False, "fused": True}  # Morton lanes on the fused route
        refs = {k: ref_nee.render_pixels(ref, seed, pixels, morton=m) for k, m in lanes.items()}
        faults = {k: {"no_nee": ref_render.render_pixels(ref, seed, pixels, morton=m),
                      "first_light": ref_nee.render_pixels(ref, seed, pixels, morton=m,
                                                           first_light=True),
                      "lane_order": refs["fused" if k == "scan" else "scan"]}
                  for k, m in lanes.items()}
        out[seed] = prog, refs, faults
    return out


def _numbers(a, b):
    return render_numbers([a], [b], FORK_ABS)


def test_the_scene_at_test_size_has_two_blocks_and_the_panel(scenes):
    scene, ref = scenes
    assert scene.num_tris == ref.num_tris == 36 + 2 * SEGMENTS * (BANDS - 1) == 292
    assert scene.geometry.feats.block_bounds.shape[0] == 2
    assert scene.light_faces.shape == (2,)
    assert ref_nee.light_table(ref).v0.shape == (2, 3)


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("seed", SEEDS)
def test_nee_render_matches_reference(renders, engine, seed):
    """The scan estimator on pixel lanes and the fused route on Morton lanes
    against the reference on the same lanes."""
    prog, refs, _ = renders[seed]
    got = _numbers(prog[engine], refs[engine])
    assert got["fork_share"] <= FORK_SHARE and got["mean_abs"] <= MEAN_ABS, got
    assert 0.05 < float(refs[engine].mean()) < 0.95  # lit, not blown out


@pytest.mark.parametrize("fault", ["no_nee", "first_light", "lane_order"])
@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_faults_fail_the_tolerances(renders, engine, fault):
    """The reference without NEE, with every light sample on light 0, and on
    the other lane order, each in the program's place, fails both."""
    for seed in SEEDS:
        _, refs, faults = renders[seed]
        got = _numbers(faults[engine][fault], refs[engine])
        assert got["fork_share"] > 0.5 and got["mean_abs"] > 100 * MEAN_ABS, (seed, got)


def test_fused_route_counts_the_reference_shadow_rays(scenes):
    """A profiled fused render keeps 2b's counters (here its plain version's)
    under ``"fused_queue"``: ``nee_rays`` is the reference's NEE shadow rays
    on the same lanes, and the segments hold them."""
    scene, ref = scenes
    seed = SEEDS[0]
    profiling.clear_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pt.render_scene(scene, seed, {"nee": True, "fused": True})
        totals = profiling.counter_totals("fused_queue")
    finally:
        profiling.clear_counters()
    tally = dict(segments=0, lanes=0, sun=0, nee=0)
    ref_nee.render_pixels(ref, seed, torch.arange(RES * RES), morton=True, counts=tally)
    assert list(totals) == list(tf.queue_stats_fields(MB))
    assert totals["nee_rays"] == tally["nee"] > 0
    assert totals["segments"] == tally["segments"] >= 2 * tally["nee"]
    assert sum(totals[f"lanes.{b}"] for b in range(MB + 1)) == totals["segments"]


@pytest.mark.parametrize("nee", [False, True])
def test_render_scene_lights_span(scenes, nee):
    """With NEE the light table's build is the span ``render_scene.lights``
    inside ``render_scene.settings``; without it there is none."""
    scene, _ = scenes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.render_scene(scene, 5, {"nee": nee, "spp": 1})
    events = list(prof.events())
    lights = [e for e in events if e.name == "render_scene.lights"]
    if not nee:
        assert lights == []
        return
    (span,) = lights
    assert span.cpu_parent is not None and span.cpu_parent.name == "render_scene.settings"


def _point_triangle_distance(p, a, b, c):
    """The distance from point ``p`` to each triangle ``(a, b, c)`` ``[T, 3]``
    (the closest point by Voronoi regions, Ericson's "Real-Time Collision
    Detection" 5.1.5)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = np.einsum("ij,ij->i", ab, ap), np.einsum("ij,ij->i", ac, ap)
    bp, cp = p - b, p - c
    d3, d4 = np.einsum("ij,ij->i", ab, bp), np.einsum("ij,ij->i", ac, bp)
    d5, d6 = np.einsum("ij,ij->i", ab, cp), np.einsum("ij,ij->i", ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    denom = np.where(va + vb + vc == 0, 1.0, va + vb + vc)
    q = a + ab * (vb / denom)[:, None] + ac * (vc / denom)[:, None]  # inside the face
    cases = [  # (region, closest point), the later ones taking precedence below
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         b + (c - b) * ((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-300))[:, None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * (d2 / np.maximum(d2 - d6, 1e-300))[:, None]),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * (d1 / np.maximum(d1 - d3, 1e-300))[:, None]),
        ((d6 >= 0) & (d5 <= d6), c),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d1 <= 0) & (d2 <= 0), a),
    ]
    for region, point in cases:
        q = np.where(region[:, None], point, q)
    return np.linalg.norm(q - p, axis=-1)


def test_point_triangle_distance():
    a, b, c = (np.array([[0.0, 0.0, 0.0]]), np.array([[1.0, 0.0, 0.0]]),
               np.array([[0.0, 1.0, 0.0]]))
    for p, want in (((0.2, 0.2, 1.0), 1.0), ((-1.0, -1.0, 0.0), np.sqrt(2.0)),
                    ((2.0, 0.0, 0.0), 1.0), ((0.5, -2.0, 0.0), 2.0), ((1.0, 1.0, 0.0), 0.5 ** 0.5)):
        got = _point_triangle_distance(np.asarray(p), a, b, c)[0]
        assert abs(got - want) < 1e-12, (p, got, want)


def test_full_size_closedbox():
    """The configuration as the benchmark runs it: 15,756 triangles in 62
    blocks, the panel's 2 emissive faces, an outward-wound sphere, and every
    triangle of the box farther from the sphere's centre than its radius, so
    the sphere (whose facets lie inside that radius) crosses none."""
    cfg = json.loads(CONFIG.read_text())
    params = cfg["params"]
    tris = closedbox.triangles(params, 0)
    assert len(tris) == 15756 and -(-len(tris) // 256) == 62
    table = cfg["materials"]
    assert sum(1 for t in tris if table[t[3]][0] == 0) == 2
    box, ball = tris[:36], tris[36:]
    assert box == cornell.triangles({}, 0) and {t[3] for t in ball} == {cornell.M_GLOSSY}
    assert table[cornell.M_GLOSSY][0] == 2  # GGX
    centre, radius = np.asarray(params["center"]), float(params["radius"])
    a, b, c = (np.asarray([t[k] for t in ball], np.float64) for k in range(3))
    for v in (a, b, c):
        assert np.allclose(np.linalg.norm(v - centre, axis=-1), radius)
    out = np.einsum("ij,ij->i", np.cross(b - a, c - a), (a + b + c) / 3 - centre)
    assert bool((out > 0).all())
    a, b, c = (np.asarray([t[k] for t in box], np.float64) for k in range(3))
    gap = _point_triangle_distance(centre, a, b, c) - radius
    assert float(gap.min()) > 0.04, gap.min()
