"""roofline.render's work count against a count made another way: on a
4^2-pixel render with 2 bounces, the rays that the port's plain fused
sample traces (``sample_fused_plain(traces=...)`` logs every trace loop's
rays), and the least time by hand from those counts."""

import dataclasses
import types

import pytest
import torch

from port_bench.harness import counts
from port_bench.harness.cells import Cell
from port_bench.reference import render as ref_render
from port_bench.reference import scene as ref_scene
from port_bench.tests.test_port_bench_reference import tiny_scene


@pytest.mark.parametrize("name", ["cornell", "outdoor15k"])
def test_work_count_is_the_rays_the_plain_sample_traces(name):
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import _gather_surface
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit, fused
    from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
    from ensem3a_openclraytracer_tpu_torch.ops.rng import key_from_generator
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    obj = tiny_scene(name)
    prog = Scene.load(obj, device="cpu")
    ref = dataclasses.replace(ref_scene.load(obj, "cpu"), resolution=4, spp=3, max_bounce=2)
    geom, mats, env, cam = (prog.geometry, prog.material_params(), prog.env_params(),
                            prog.camera_params())
    o, d = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, 4, 4)
    hit = closest_hit.trace(geom, o, d, "plain")
    args, _ = fused.fused_args(geom, mats, env, o, d, hit, _gather_surface(geom, mats, o, d, hit))
    gen = torch.Generator()
    gen.manual_seed(21)
    key = key_from_generator(gen, torch.device("cpu"))
    logged = []
    for s in range(3):
        fused.sample_fused_plain(*args, key, s, max_bounce=2, sun_enabled=ref.sun_enabled,
                                 traces=logged)
    sizes = [oa.shape[0] for oa, _, _ in logged]
    bounce = sum(sizes[::2] if ref.sun_enabled else sizes)
    sun = sum(sizes[1::2]) if ref.sun_enabled else 0

    tally = dict(segments=0, lanes=0, sun=0)
    morton = ref.num_tris > ref_render.TRI_TILE  # fused_args permutes the lanes of 2+ blocks
    ref_render.render_pixels(ref, 21, torch.arange(16), morton=morton, counts=tally)
    assert tally == dict(segments=bounce + sun, lanes=bounce, sun=sun)
    assert bounce > 0 and (sun > 0) == ref.sun_enabled

    nbytes = ref.input_bytes() + 16 * 3 * 4
    by_hand = max((45 * (16 + bounce + sun) + 148 * bounce + 27 * sun) / 67e12, nbytes / 3.35e12)
    assert counts.least_seconds(16 + bounce + sun, bounce, sun, nbytes) == pytest.approx(by_hand)


def test_roofline_reader_is_least_time_over_busy_time_per_call():
    read = Cell("cornell.render").reader("roofline.render")
    trace = types.SimpleNamespace(busy_s=0.03, calls=[0, 1, 2])
    c = dict(segments=1e9, lanes=5e8, sun=0.0, bytes=1e6)
    run = types.SimpleNamespace(trace=trace, mix=types.SimpleNamespace(counts=c))
    least = (45 * 1e9 + 148 * 5e8) / 67e12
    assert read(run) == pytest.approx(100 * least / 0.01)
    assert read(types.SimpleNamespace(trace=None, mix=run.mix)) is None
