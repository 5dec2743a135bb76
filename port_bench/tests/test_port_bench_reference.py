"""The plain reference against the port's CPU path at 16^2, 2 spp: the
same scene files, the same seeds, the same images and steps."""

import json
import tempfile

import pytest
import torch

from port_bench.reference import optimize as ref_optimize
from port_bench.reference import render as ref_render
from port_bench.reference import scene as ref_scene
from port_bench.scenes import files
from port_bench.tests.conftest import ROOT, TINY_INI, TINY_SKY


def tiny_scene(name, n_cubes=30):
    cfg = json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())
    cfg["ini"].update(TINY_INI)
    if "n_cubes" in cfg["params"]:
        cfg["params"]["n_cubes"] = n_cubes
    if cfg.get("sky"):
        cfg["sky"] = TINY_SKY
    return files.write_scene(cfg, 5, tempfile.mkdtemp(), "cpu")


@pytest.mark.parametrize("name", ["cornell", "outdoor15k"])
@pytest.mark.parametrize("use_bvh", [False, True])
def test_reference_scene_is_the_loaders(name, use_bvh):
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    obj = tiny_scene(name)
    ref, prog = ref_scene.load(obj, "cpu"), Scene.load(obj, use_bvh=use_bvh or None, device="cpu")
    g = prog.geometry
    assert torch.equal(g.v0, ref.v0) and torch.equal(g.v2, ref.v2)
    assert torch.equal(g.n, ref.normal) and torch.equal(g.mat.long(), ref.mat)
    assert torch.equal(prog.env_params().ibl, ref.ibl)
    if not use_bvh:
        t = ref.num_tris
        assert torch.equal(g.feats.edges[:, :, :t], ref.edges)
        assert torch.equal(g.feats.plane[:, :t], ref.plane)


@pytest.mark.parametrize("name", ["cornell", "outdoor15k"])
@pytest.mark.parametrize("use_bvh", [False, True])
def test_reference_render_is_render_scene(name, use_bvh):
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    obj = tiny_scene(name)
    ref, prog = ref_scene.load(obj, "cpu"), Scene.load(obj, use_bvh=use_bvh or None, device="cpu")
    pixels = torch.arange(ref.resolution ** 2)
    for seed in (3, 2 ** 31 + 7):
        img = render_scene(prog, seed).reshape(-1, 3)
        out = ref_render.render_pixels(ref, seed, pixels, morton=False)
        diff = (img - out).abs().amax(dim=-1)
        if use_bvh:  # the tree's Moller-Trumbore test forks from the Plucker test on an edge
            assert float((diff > 1e-3).float().mean()) <= 0.02 and float(diff.median()) == 0.0
        else:
            assert diff.max() <= 1e-6
        # any subset of pixels renders alone
        some = pixels[::5]
        assert torch.equal(ref_render.render_pixels(ref, seed, some, morton=False), out[some])


def test_reference_lanes_follow_the_fused_engines_morton_order():
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    obj = tiny_scene("outdoor15k")
    ref, prog = ref_scene.load(obj, "cpu"), Scene.load(obj, device="cpu")
    assert ref.num_tris > ref_render.TRI_TILE  # two blocks: the fused engine permutes
    gen = torch.Generator()
    gen.manual_seed(11)
    rad = render_radiance(prog.geometry, prog.material_params(), prog.env_params(),
                          prog.camera_params(), gen, height=16, width=16, spp=2,
                          max_bounce=4, sun_enabled=True, fused=True, engine="plain")
    img = torch.clamp(rad, 0.0, 1.0).reshape(-1, 3)
    out = ref_render.render_pixels(ref, 11, torch.arange(256), morton=True)
    assert (img - out).abs().max() <= 1e-6
    assert not torch.equal(out, ref_render.render_pixels(ref, 11, torch.arange(256), morton=False))


def test_reference_steps_are_the_train_steps():
    from ensem3a_openclraytracer_tpu_torch.models.optimize import (
        Adam,
        iteration_generator,
        make_train_step,
    )
    from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

    obj = tiny_scene("cornell")
    prog, ref = Scene.load(obj, device="cpu"), ref_scene.load(obj, "cpu")
    init, step = make_train_step(prog.geometry, prog.material_params(), prog.env_params(),
                                 prog.camera_params(), Adam(1e-2), height=16, width=16, spp=2,
                                 max_bounce=3, sun_enabled=False)
    target = torch.rand((16, 16, 3), generator=torch.Generator().manual_seed(4))
    params, state = init()
    steps = ref_optimize.train_steps(ref, target, 99, 3, resolution=16, spp=2, max_bounce=3,
                                     lr=1e-2)
    for i in range(3):
        params, state, loss = step(params, state, target, iteration_generator(99, i, "cpu"))
        assert float(loss) == pytest.approx(steps[i]["loss"], rel=1e-6)
    for leaf, name in zip(params, ("color", "rough", "sun_power", "ibl_power", "ibl")):
        assert torch.allclose(leaf, steps[2]["params"][name], atol=1e-6)
