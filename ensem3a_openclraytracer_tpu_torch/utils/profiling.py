"""Metrics and tracing: stage timers, rays/s accounting, profiler traces.

Counterpart of the JAX package's ``utils/profiling.py``: named wall-clock
stage timers that synchronize the card, Mrays/s from the estimator's ray
count (``bench.py``'s accounting), and :func:`torch_trace`, a
``torch.profiler`` context in place of ``jax.profiler``'s XLA trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


def rays_per_render(res: int, spp: int, max_bounce: int, sun_enabled: bool) -> int:
    """Ray segments of one render as the reference counts them: one cached
    primary, then up to ``max_bounce + 1`` bounce segments per sample, and
    one sun shadow segment per bounce with the sun on (Raytracing.cl:82,
    :124, :184)."""
    per_sample = (max_bounce + 1) * (2 if sun_enabled else 1)
    return res * res * (1 + spp * per_sample)


def _sync(sync) -> None:
    """Wait for the card when ``sync`` is a CUDA tensor or device."""
    if isinstance(sync, torch.Tensor):
        sync = sync.device
    if sync is not None and torch.device(sync).type == "cuda":
        torch.cuda.synchronize(sync)


@dataclass
class StageTimer:
    """Accumulating named wall-clock timers.

    >>> timer = StageTimer()
    >>> with timer.stage("render", sync=img_device):
    ...     img = render(...)
    >>> timer.summary()
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the block; ``sync`` (a CUDA tensor or device) makes the
        stage end when the card has finished its work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k],
                "mean_ms": round(1000.0 * v / self.counts[k], 3)}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU and, where the build
    supports it, CUDA activity) written to ``log_dir/trace.json`` as a
    Chrome trace; does nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class RenderMetrics:
    """One render's throughput record (the ``bench.py`` schema)."""

    wall_s: float
    res: int
    spp: int
    max_bounce: int
    sun_enabled: bool

    @property
    def mrays_per_s(self) -> float:
        return rays_per_render(self.res, self.spp, self.max_bounce,
                               self.sun_enabled) / self.wall_s / 1e6

    def json_line(self, metric: str = "forward_mrays_per_s",
                  vs_baseline: Optional[float] = None) -> str:
        return json.dumps({
            "metric": metric,
            "value": round(self.mrays_per_s, 3),
            "unit": "Mrays/s",
            "vs_baseline": round(vs_baseline, 3) if vs_baseline else 1.0,
        })
