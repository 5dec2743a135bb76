"""Closed-loop renders with the traffic file's ``overrides``, as ``cli render
--nee`` renders: ``render_scene(scene, seed, overrides)`` and the image on
the host.  Render ``i`` of a run with seed ``s`` takes the seed
``s * 2^20 + i``; the warm-up takes seeds past the window's
(``kinds/render``'s).

The one override the reference follows is ``nee`` (``reference/nee``;
without it ``reference/render``), and ``glass_mode`` ``tint``, the
default.  Any other is refused, ``mis``, ``fused`` and refract glass among
them: the reference has no MIS, no Snell glass and no choice of engine.

The work of a call stays ``counts.rays_per_render(res, spp, max_bounce,
sun)``, so ``render_mrays_per_s`` keeps its definition: NEE shadow rays
are not counted in it.  The roofline's work (:attr:`Mix.counts`) counts
them among the segments the reference traced.

The control is the reference in bfloat16 in the program's place; the
faults, planted in the reference put in the program's place, are
``half_batch`` (the mean over the first half of the samples only),
``altered`` (each image from the next render's random stream),
``no_nee`` (the reference without NEE: another estimator of the same
image) and ``first_light`` (every light sample takes light 0, the upstream
``sampleLight`` quirk)."""

from __future__ import annotations

import dataclasses

import torch

from port_bench.harness import compare, counts, mix
from port_bench.harness.window import Reservoir
from port_bench.kinds.render import SEED_STRIDE, WARM, WARMUP_CALLS, compared_pixels, render_seeds
from port_bench.reference import nee as ref_nee
from port_bench.reference import render as ref_render

FOLLOWED = ("nee",)


def checked_overrides(traffic: dict) -> dict:
    """The traffic file's ``overrides``; raises on one the reference does not
    follow."""
    overrides = dict(traffic.get("overrides", {}))
    if overrides.get("glass_mode", "tint") == "tint":
        overrides.pop("glass_mode", None)
    refused = sorted(k for k in overrides if k not in FOLLOWED)
    if refused:
        raise ValueError(f"render_overrides: the reference does not follow {refused}")
    return overrides


def reference_images(cell, scene, seeds, pixels, dtype=torch.float32, tally=None, *,
                     nee=None, first_light=False) -> list:
    """The reference's images of renders ``seeds`` at ``pixels``, in the lane
    order the program's engine gives the cell's scene; ``nee`` (the
    overrides' when None) picks ``reference/nee`` or ``reference/render``."""
    if nee is None:
        nee = bool(checked_overrides(cell.traffic).get("nee", False))
    morton = ref_render.fused_lane_order(scene, pixels.device)
    primary = ref_render.Primary(scene, dtype)
    if not nee:
        return [ref_render.render_pixels(scene, s, pixels, morton=morton, dtype=dtype,
                                         counts=tally, primary=primary) for s in seeds]
    return [ref_nee.render_pixels(scene, s, pixels, morton=morton, dtype=dtype, counts=tally,
                                  primary=primary, first_light=first_light) for s in seeds]


class Mix(mix.Mix):
    def __init__(self, cell, seed: int, device, directory: str):
        self.overrides = checked_overrides(cell.traffic)
        super().__init__(cell, seed, device, directory)
        from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene
        from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

        self.scene = Scene.load(self.obj, device=device)
        self.render_scene = render_scene
        rs = self.scene.config.render_settings()
        self.res, self.spp, self.max_bounce = rs.resolution, rs.spp, rs.max_bounce
        self.sun = float(self.scene.env_params().sun_power) != 0.0
        self.mark("load")
        self.kept = Reservoir(int(cell.settings["compare"]["renders"]), seed)
        for w in range(WARMUP_CALLS):
            self.render(self.seed * SEED_STRIDE + WARM + w)
            self.mark(f"warm{w}")

    @property
    def work_per_call(self) -> int:
        return counts.rays_per_render(self.res, self.spp, self.max_bounce, self.sun)

    def render(self, seed: int) -> torch.Tensor:
        return self.render_scene(self.scene, seed=seed, overrides=self.overrides).cpu()

    def call(self, i: int) -> torch.Tensor:
        return self.render(self.seed * SEED_STRIDE + i)

    def keep(self, i: int, image) -> None:
        self.kept.offer((self.seed * SEED_STRIDE + i, image))

    def release(self) -> None:
        from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance_jit

        self.scene = None
        render_radiance_jit.graph.clear()

    def compare(self) -> dict:
        """The numbers of the kept renders against the reference; fills
        :attr:`counts` with the reference's work per render, its NEE shadow
        segments among the segments (and apart, as ``nee``)."""
        pixels = compared_pixels(self.res * self.res, self.cell, self.seed, self.device)
        seeds = [s for s, _ in self.kept.items]
        tally = dict(segments=0, lanes=0, sun=0, nee=0)
        scene = self.reference_scene()
        refs = reference_images(self.cell, scene, seeds, pixels, tally=tally)
        n = self.res * self.res
        scale = n / (pixels.numel() * len(seeds))
        self.counts = dict(segments=n + tally["segments"] * scale, lanes=tally["lanes"] * scale,
                           sun=tally["sun"] * scale, nee=tally["nee"] * scale,
                           bytes=scene.input_bytes() + n * 3 * 4)
        progs = [img.reshape(-1, 3)[pixels.cpu()] for _, img in self.kept.items]
        return compare.render_numbers(progs, refs, float(self.cell.settings["compare"]["fork_abs"]))


def readings(cell, seed: int, device) -> dict:
    """The control's and the faults' numbers for one seed."""
    scene = mix.reference_scene(cell, seed, device)
    pixels = compared_pixels(scene.resolution ** 2, cell, seed, device)
    seeds = render_seeds(cell, seed)
    fork_abs = float(cell.settings["compare"]["fork_abs"])
    ref = reference_images(cell, scene, seeds, pixels)

    def numbers(images):
        return compare.render_numbers(images, ref, fork_abs)

    half = dataclasses.replace(scene, spp=scene.spp // 2)
    return {"control": numbers(reference_images(cell, scene, seeds, pixels, torch.bfloat16)),
            "half_batch": numbers(reference_images(cell, half, seeds, pixels)),
            "altered": numbers(reference_images(cell, scene, [s + 1 for s in seeds], pixels)),
            "no_nee": numbers(reference_images(cell, scene, seeds, pixels, nee=False)),
            "first_light": numbers(reference_images(cell, scene, seeds, pixels,
                                                    first_light=True))}
