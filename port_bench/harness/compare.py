"""The numbers that decide ``correct``, each held against its limit.

Renders: the program's images at the compared pixels against the
reference's, as ``fork_share`` (the share of pixels whose largest channel
differs by more than ``fork_abs``: a path that took another triangle on a
rounding difference, or a pixel drawn from another random stream) and
``mean_abs`` (the mean absolute difference over pixels and channels).

Steps: per the first steps, ``loss_gap`` (the largest relative gap of a
step's loss), ``grad_gap`` (the gradients of the first two steps, as the
optimizer gets them: worked out from its first moment after each, so the
second is a graph replay's) and ``change_gap`` (the change of the values
over the steps); the last two by the worst leaf: the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf.  Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone and are
left out (``LEAF_FLOOR``).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

LEAF_FLOOR = 1e-3


def render_numbers(program: List[torch.Tensor], reference: List[torch.Tensor],
                   fork_abs: float) -> Dict[str, float]:
    """``fork_share`` and ``mean_abs`` over every compared pixel of every
    compared render (``[P, 3]`` images on the host)."""
    diff = torch.cat([(p.float().cpu() - r.float().cpu()).abs()
                      for p, r in zip(program, reference)])
    return {"fork_share": float((diff.amax(dim=-1) > fork_abs).float().mean()),
            "mean_abs": float(diff.mean())}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    median = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in keep)


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().cpu().norm()) for k, v in leaves.items()}


def grads_of_moments(moments: List[Dict[str, torch.Tensor]],
                     b1: float) -> List[Dict[str, torch.Tensor]]:
    """The gradients that Adam took in, from its first moment after each of
    the first steps: ``m_0 = (1 - b1) g_0``, ``m_i = b1 m_(i-1) + (1 - b1) g_i``."""
    grads, before = [], None
    for m in moments:
        grads.append({k: (v.float().cpu() - (0.0 if before is None else b1 * before[k]))
                      / (1 - b1) for k, v in m.items()})
        before = {k: v.float().cpu() for k, v in m.items()}
    return grads


def step_numbers(losses: List[float], grads: List[Dict[str, torch.Tensor]],
                 change: Dict[str, torch.Tensor], reference: List[dict],
                 start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The three numbers of the first ``len(losses)`` steps: the program's
    losses, its gradients of the first ``len(grads)`` steps and its values'
    change after the last, against the reference's steps
    (``reference/optimize``)."""
    grad_gap = 0.0
    for prog, ref in zip(grads, reference):
        ref_g = _norms(ref["grads"])
        keep = [k for k, v in ref_g.items() if v >= LEAF_FLOOR * statistics.median(ref_g.values())]
        grad_gap = max(grad_gap, _leaf_gap(_norms(prog), ref_g, keep))
    ref_g_any = {k: max(float(s["grads"][k].norm()) for s in reference) for k in start}
    floor_any = LEAF_FLOOR * statistics.median(ref_g_any.values())
    keep_c = [k for k, v in ref_g_any.items() if v >= floor_any]
    last = reference[len(losses) - 1]["params"]
    ref_c = _norms({k: last[k].float().cpu() - start[k].float().cpu() for k in start})
    loss_gap = max(abs(p - r["loss"]) / abs(r["loss"]) for p, r in zip(losses, reference))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": _leaf_gap(_norms(change), ref_c, keep_c)}
