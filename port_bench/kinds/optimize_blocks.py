"""Closed-loop inverse-rendering steps on a scene of several triangle
blocks: the ``optimize`` kind (``kinds/optimize``), compared with the
reference on the lanes the program's recorder takes.

On the card the port records a multi-block scene through its fused
recorder, which draws the Philox stream in the Morton order of the
primary hits (``reference/optimize_lanes``); ``reference/optimize`` takes
pixel lanes and would hold the program against another stream's
estimate.  Here the reference takes the lanes as
``reference/render.fused_lane_order`` says the program does, and its
first step's forward and last second moment give the roofline's work
(``harness/step_work``).

Besides the ``optimize`` kind's three numbers, ``texel_gap`` compares
the sky's texel gradients value by value: the norm of the program's
gradient less the reference's, over the reference's, the larger over the
first two steps.  A norm per leaf cannot see which texels a gradient
reaches; this can.

The program's material table holds every material of the ini; the
reference's, those up to the largest id a triangle takes
(``reference/scene.load``).  Rows past it (here the light's and the
glass's, which no triangle takes) reach no pixel: they are compared as
the reference's zero gradient and zero change.

The control is the reference in bfloat16 in the program's place; the
faults, planted in the reference put in the program's place, are the
``optimize`` kind's (``half_batch``, ``altered``, ``unchanged``) and
``pixel_lanes``: the steps on the other lane order (pixel lanes where the
program takes Morton lanes, as on the card)."""

from __future__ import annotations

from typing import Dict, List

import torch

from port_bench.harness import compare, mix, step_work
from port_bench.kinds import optimize
from port_bench.reference import optimize_lanes as ref_lanes
from port_bench.reference import render as ref_render

TEXELS = step_work.TEXELS
MATERIAL_LEAVES = ("color", "rough")  # the reference's leaves with a row per material


def texel_gap(grads: List[Dict[str, torch.Tensor]], reference: List[dict]) -> float:
    """The largest ``|g - g_ref| / |g_ref|`` of the texel gradients over
    the steps of ``grads`` (``compare.grads_of_moments``'s)."""
    gap = 0.0
    for prog, ref in zip(grads, reference):
        r = ref["grads"][TEXELS].float().cpu()
        diff = float((prog[TEXELS].float().cpu() - r).norm())
        gap = max(gap, diff / max(float(r.norm()), 1e-30))
    return gap


def padded(reference: List[dict], start: Dict[str, torch.Tensor], rows: int):
    """The reference's steps and starting values with its material leaves
    grown to the program's ``rows``: the rows it lacks start at the
    program's values (``start``), get no gradient and keep their values."""
    def pad(leaves, fill):
        return {k: (torch.cat([v, fill(k, v)]) if k in MATERIAL_LEAVES else v)
                for k, v in leaves.items()}

    zeros = lambda k, v: torch.zeros((rows - v.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                                     device=v.device)
    rest = lambda k, v: start[k][v.shape[0]:].to(v.device, v.dtype)
    return [dict(s, grads=pad(s["grads"], zeros), params=pad(s["params"], rest))
            for s in reference]


def numbers(losses, grads, change, reference, start) -> Dict[str, float]:
    """``compare.step_numbers`` and :func:`texel_gap`; the reference's
    material leaves padded to the program's (:func:`padded`)."""
    reference = padded(reference, start, start["color"].shape[0])
    return dict(compare.step_numbers(losses, grads, change, reference, start),
                texel_gap=texel_gap(grads, reference))


class Mix(optimize.Mix):
    def compare(self) -> dict:
        """The numbers of the first steps against the reference on the
        program's lanes; fills :attr:`counts` with one step's work."""
        scene = self.reference_scene()
        tally = dict(segments=0, lanes=0, sun=0)
        ref = ref_lanes.train_steps(scene, self.target, self.seed, self.first,
                                    morton=ref_render.fused_lane_order(scene, self.device),
                                    counts=tally, **self.settings)
        self.counts = step_work.step_counts(scene, tally, ref[-1]["nu"],
                                            self.settings["resolution"])
        return numbers(self.losses, compare.grads_of_moments(self.moments, optimize.B1),
                       self.change, ref, self.start)


def readings(cell, seed: int, device) -> dict:
    """The control's and the faults' numbers for one seed."""
    scene = mix.reference_scene(cell, seed, device)
    kw = optimize.step_settings(cell, scene.resolution)
    target = optimize.make_target(seed, kw["resolution"], device)
    steps = int(cell.traffic["first_steps"])
    start = ref_render.params_of(scene)
    morton = ref_render.fused_lane_order(scene, device)

    def run(dtype=torch.float32, s=seed, lanes=morton, **over):
        return ref_lanes.train_steps(scene, target, s, steps, morton=lanes, dtype=dtype,
                                     **{**kw, **over})

    ref = run()

    def read(steps_of, change=None):
        last = steps_of[-1]["params"]
        change = {k: last[k] - start[k] for k in last} if change is None else change
        return numbers([s["loss"] for s in steps_of], [s["grads"] for s in steps_of[:2]],
                       change, ref, start)

    return {"control": read(run(torch.bfloat16)),
            "half_batch": read(run(spp=kw["spp"] // 2)),
            "altered": read(run(s=seed + 1)),
            "unchanged": read(ref, {k: torch.zeros_like(v) for k, v in start.items()}),
            "pixel_lanes": read(run(lanes=not morton))}
