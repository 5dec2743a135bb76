"""Closed-loop inverse-rendering steps, as ``cli optimize`` runs them:
``make_train_step``'s ``step`` (one captured graph on the card) called as
``run_optimization`` calls it, each step ending when its loss is on the
host.  Iteration ``i`` draws from ``iteration_generator(seed, i)``; the
target image is made from the seed.  Set-up takes the first steps (the
first runs eagerly and captures the graph, the later ones replay it) and
keeps what the comparison reads: their losses, the optimizer's first
moment after each of the first two steps (the gradients of step 0, the
eager one, and of step 1, the first replay) and the values' change after
the last; the window goes on from there with the same state.

The control is the reference in bfloat16 in the program's place; the
faults, planted in the reference put in the program's place, are
``half_batch`` (half of the samples), ``altered`` (the steps on the
stream of seed ``s + 1``) and ``unchanged`` (the state returned as it
came: its change reads 0, so ``change_gap`` reads 1 and needs no run)."""

from __future__ import annotations

import torch

from port_bench.harness import compare, mix
from port_bench.reference import optimize as ref_optimize
from port_bench.reference import render as ref_render

LEAVES = {"color": "color", "roughness": "rough", "sun_power": "sun_power",
          "ibl_power": "ibl_power", "ibl": "ibl"}  # the program's leaf -> the reference's
B1 = 0.9  # Adam's first-moment decay, as ``models/optimize.Adam`` and the reference take it


def make_target(seed: int, res: int, device) -> torch.Tensor:
    """The target image ``[res, res, 3]``, uniform in [0, 1), from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand((res, res, 3), generator=gen, device=device)


def step_settings(cell, resolution: int) -> dict:
    tr = cell.traffic
    return dict(resolution=min(resolution, int(tr["resolution_cap"])), spp=int(tr["spp"]),
                max_bounce=int(tr["max_bounce"]), lr=float(tr["lr"]))


class Mix(mix.Mix):
    def __init__(self, cell, seed: int, device, directory: str):
        super().__init__(cell, seed, device, directory)
        from ensem3a_openclraytracer_tpu_torch.models.optimize import (
            Adam,
            iteration_generator,
            make_train_step,
        )
        from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

        scene = Scene.load(self.obj, device=device)
        self.settings = step_settings(cell, scene.config.render_settings().resolution)
        res = self.settings["resolution"]
        env, materials = scene.env_params(), scene.material_params()
        self.init, self.step = make_train_step(
            scene.geometry, materials, env, scene.camera_params(), Adam(self.settings["lr"]),
            height=res, width=res, spp=self.settings["spp"],
            max_bounce=self.settings["max_bounce"], sun_enabled=float(env.sun_power) != 0.0)
        self.iteration_generator = iteration_generator
        self.target = make_target(self.seed, res, device)
        self.mark("load")
        self.params, self.opt_state = self.init()
        self.start = self._leaves(self.params)
        self.first = int(cell.traffic["first_steps"])
        self.losses, self.moments = [], []
        for i in range(self.first):
            self.losses.append(self._step(i))
            self.mark(f"step{i}")
            if i < 2:
                self.moments.append(self._leaves(self.opt_state.mu))
        self.change = {k: v - self.start[k] for k, v in self._leaves(self.params).items()}

    @staticmethod
    def _leaves(tup) -> dict:
        return {LEAVES[k]: v.detach().clone() for k, v in tup._asdict().items()}

    def _step(self, i: int) -> float:
        gen = self.iteration_generator(self.seed, i, self.device)
        self.params, self.opt_state, loss = self.step(self.params, self.opt_state, self.target, gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return float(loss)

    def call(self, i: int) -> float:
        return self._step(self.first + i)

    def release(self) -> None:
        self.step = self.init = self.params = self.opt_state = None

    def compare(self) -> dict:
        ref = ref_optimize.train_steps(self.reference_scene(), self.target, self.seed, self.first,
                                       **self.settings)
        return compare.step_numbers(self.losses, compare.grads_of_moments(self.moments, B1),
                                    self.change, ref, self.start)


def readings(cell, seed: int, device) -> dict:
    """The control's and the faults' numbers for one seed."""
    scene = mix.reference_scene(cell, seed, device)
    kw = step_settings(cell, scene.resolution)
    target = make_target(seed, kw["resolution"], device)
    steps = int(cell.traffic["first_steps"])
    start = ref_render.params_of(scene)

    def run(dtype=torch.float32, s=seed, **over):
        return ref_optimize.train_steps(scene, target, s, steps, dtype=dtype, **{**kw, **over})

    ref = run()

    def numbers(steps_of, change=None):
        last = steps_of[-1]["params"]
        change = {k: last[k] - start[k] for k in last} if change is None else change
        return compare.step_numbers([s["loss"] for s in steps_of],
                                    [s["grads"] for s in steps_of[:2]], change, ref, start)

    return {"control": numbers(run(torch.bfloat16)),
            "half_batch": numbers(run(spp=kw["spp"] // 2)),
            "altered": numbers(run(s=seed + 1)),
            "unchanged": numbers(ref, {k: torch.zeros_like(v) for k, v in start.items()})}
