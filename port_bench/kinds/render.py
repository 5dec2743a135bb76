"""Closed-loop renders of a loaded scene, as the CLI, the UI's re-render
and ``cli bench`` render: ``render_scene(scene, seed)`` and the image on the
host.  Render ``i`` of a run with seed ``s`` takes the seed ``s * 2^20 + i``;
the warm-up takes seeds past the window's.  The mix's data file may set
``use_bvh`` (``Scene.load(use_bvh=True)``: a tree-only pack).

The control is the reference in bfloat16 in the program's place; the
faults, planted in the reference put in the program's place, are
``half_batch`` (the mean over the first half of the samples only) and
``altered`` (each image from the next render's random stream)."""

from __future__ import annotations

import dataclasses

import torch

from port_bench.harness import compare, counts, mix
from port_bench.harness.window import Reservoir
from port_bench.reference import render as ref_render

SEED_STRIDE = 1 << 20
WARM = 1 << 19
WARMUP_CALLS = 2  # the first captures the graph, the second replays it


def compared_pixels(n: int, cell, seed: int, device) -> torch.Tensor:
    """The compared pixels of an ``n``-pixel image: all, or the cell's
    ``compare.pixels`` of them drawn from the seed."""
    want = int(cell.settings["compare"].get("pixels", 0))
    if want <= 0 or want >= n:
        return torch.arange(n, device=device)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return torch.sort(torch.randperm(n, generator=gen)[:want]).values.to(device)


def render_seeds(cell, seed: int) -> list:
    """The seeds of the renders the control compares: the window's first."""
    return [int(seed) * SEED_STRIDE + i for i in range(int(cell.settings["compare"]["renders"]))]


def reference_images(cell, scene, seeds, pixels, dtype=torch.float32, tally=None) -> list:
    """The reference's images of renders ``seeds`` at ``pixels``, in the
    lane order the program's engine gives the cell's scene."""
    morton = ref_render.fused_lane_order(scene, pixels.device) and not cell.traffic.get("use_bvh")
    primary = ref_render.Primary(scene, dtype)
    return [ref_render.render_pixels(scene, s, pixels, morton=morton, dtype=dtype, counts=tally,
                                     primary=primary) for s in seeds]


class Mix(mix.Mix):
    def __init__(self, cell, seed: int, device, directory: str):
        super().__init__(cell, seed, device, directory)
        from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_scene
        from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

        self.scene = Scene.load(self.obj, use_bvh=bool(cell.traffic.get("use_bvh")) or None,
                                device=device)
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
        return self.render_scene(self.scene, seed=seed).cpu()

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
        :attr:`counts` with the reference's work per render."""
        pixels = compared_pixels(self.res * self.res, self.cell, self.seed, self.device)
        seeds = [s for s, _ in self.kept.items]
        tally = dict(segments=0, lanes=0, sun=0)
        scene = self.reference_scene()
        refs = reference_images(self.cell, scene, seeds, pixels, tally=tally)
        n = self.res * self.res
        scale = n / (pixels.numel() * len(seeds))
        self.counts = dict(segments=n + tally["segments"] * scale, lanes=tally["lanes"] * scale,
                           sun=tally["sun"] * scale, bytes=scene.input_bytes() + n * 3 * 4)
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
            "altered": numbers(reference_images(cell, scene, [s + 1 for s in seeds], pixels))}
