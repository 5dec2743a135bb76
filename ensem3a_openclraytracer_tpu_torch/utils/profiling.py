"""Metrics and tracing: spans, counter records, stage timers, rays per
render, profiler traces.

Counterpart of the JAX package's ``utils/profiling.py``: named wall-clock
stage timers that synchronize the card, the estimator's ray count
(``bench.py``'s accounting), and :func:`torch_trace`, a ``torch.profiler``
context in place of ``jax.profiler``'s XLA trace.

Tracing inside the program is switched on by a running profiler and by
nothing else:

* :func:`span` names a block of host code.  With no profiler recording it
  is one shared no-op context (no allocation, no torch op); under a
  profiler it is ``torch.profiler.record_function``, an event on the
  profiler's clock, which the device's records share.  Spans of one call
  nest, and nesting is the parent link.  No span goes inside a function
  that is captured as a CUDA graph: it would run only at the capture.
  ``scene/scene.Scene.load`` opens ``scene.load.parse`` around the OBJ
  parse, a span of set-up that a profiler started before the load sees.
* :func:`record_counters` keeps a device clone of a counter buffer that a
  kernel wrote (no host sync); :func:`counter_totals` sums the clones kept
  under a name on the host (one sync, at read time), :func:`clear_counters`
  drops them.  ``models/pathtracer.render_radiance_jit`` keeps 2b's
  (``csrc/fused_queue.cu``) counters under ``"fused_queue"`` after each
  multi-block render made while a profiler records.
* :func:`count` records counts the host already knows (sizes, bytes) as
  a CPU record, with no device work: ``ops/gathers.scatter_rows`` under
  ``"scatter"``, ``utils/graphs.Graphed`` under ``"graphs"``.  Code that a
  CUDA graph captures runs its Python only at the capture, so
  ``Graphed`` collects the capture's counts with :func:`tallied` and
  records them again at each replay.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

recording = torch._C._autograd._profiler_enabled  # whether a profiler records: ~0.15 us

NO_SPAN = contextlib.nullcontext()  # what span() gives with no profiler recording


def span(name: str):
    """A context that names the block ``name`` on the profiler's clock
    while a profiler records, else the shared no-op :data:`NO_SPAN`."""
    if not recording():
        return NO_SPAN
    return torch.profiler.record_function(name)


_COUNTERS: Dict[str, List[tuple]] = {}  # name -> [(device clone, its fields)]


def record_counters(name: str, counts: torch.Tensor, fields: Sequence[str]) -> None:
    """Keep a clone of the counter buffer ``counts`` (one dimension, a
    slot per name in ``fields``) under ``name``, on its device, with no
    host sync."""
    fields = tuple(fields)
    if counts.shape != (len(fields),):
        raise ValueError(f"{name}: {len(fields)} fields for counts of shape {tuple(counts.shape)}")
    _COUNTERS.setdefault(name, []).append((counts.detach().clone(), fields))


def counter_totals(name: str) -> Optional[Dict[str, int]]:
    """The sum of the records under ``name``, field by field (one host
    sync), or None when there is none."""
    kept = _COUNTERS.get(name)
    if not kept:
        return None
    values = iter(torch.cat([t.to(kept[0][0].device) for t, _ in kept]).tolist())
    totals: Dict[str, int] = {}
    for f in (f for _, fields in kept for f in fields):
        totals[f] = totals.get(f, 0) + int(next(values))
    return totals


def clear_counters() -> None:
    """Drop every counter record."""
    _COUNTERS.clear()


_TALLY: Optional[Dict[str, Dict[str, int]]] = None  # set inside tallied()


def count(name: str, **values: int) -> None:
    """Host-known counts under ``name``, one field per keyword: added to
    the innermost :func:`tallied` block's tally where one is open, else
    kept as a record while a profiler records, else dropped."""
    if _TALLY is not None:
        kept = _TALLY.setdefault(name, {})
        for k, v in values.items():
            kept[k] = kept.get(k, 0) + int(v)
    elif recording():
        record_counters(name, torch.tensor([int(v) for v in values.values()], dtype=torch.int64),
                        tuple(values))


@contextlib.contextmanager
def tallied():
    """Collect the block's :func:`count` calls into the yielded dict
    (name -> field -> sum) in place of recording them."""
    global _TALLY
    outer, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = outer


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
        """Time the block, a :func:`span` named ``name``; ``sync`` (a CUDA
        tensor or device) makes the stage end when the card has finished
        its work."""
        with span(name):
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
