"""The profiler window and what is read from it.

:func:`profile` is a frozen copy of
``ensem3a_openclraytracer_tpu_torch/ops/launches.py`` :55-76 (``trace``):
``torch.profiler`` with 0.05 s of idle host time between each end of its
window and the traced block, since a profiler keeps a device record only
where its time, converted to the host's clock, falls inside the window,
and a block that starts as the window opens loses its first kernels now
and then.  Each traced call is marked with ``record_function(CALL)``; the
traced window runs from the first call's start to the last call's end.

:func:`read` turns the profiler's events into spans: device kernels,
copies and memsets (the device's busy time is their union), and the host's
operations, which name the device's idle gaps.
"""

from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

MARGIN_S = 0.05
CALL = "port_bench.call"
_NAME = re.compile(r"^(?:void\s+)?(?:\w+::)*(\w+)(?:<[^()]*>)?\(")


@contextlib.contextmanager
def profile(margin_s: float = MARGIN_S):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin_s)


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` spans as sorted disjoint spans."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def kernel_function(device_name: str) -> str:
    """A kernel's function name from its device name as a profiler gives it
    (``"void (anonymous namespace)::pairs_kernel<8>(...)"`` -> ``pairs_kernel``)."""
    m = _NAME.match(device_name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else device_name


@dataclass
class Span:
    name: str
    start: float  # seconds
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class TraceRead:
    """What one traced run of calls gave."""

    calls: List[Span]  # the host spans of the traced calls
    device: List[Span]  # kernels, copies and memsets
    host: List[Span]  # the host's operations
    kernels: List[Span] = field(default_factory=list)  # kernels alone

    @property
    def window(self) -> Tuple[float, float]:
        return self.calls[0].start, self.calls[-1].end

    @property
    def window_s(self) -> float:
        a, b = self.window
        return b - a

    def busy_spans(self) -> List[Tuple[float, float]]:
        a, b = self.window
        return union((max(s.start, a), min(s.end, b)) for s in self.device
                     if s.end > a and s.start < b)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_spans())

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernels_in_window(self) -> List[Span]:
        a, b = self.window
        return [k for k in self.kernels if k.start >= a and k.end <= b]

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle spans of the device inside the window."""
        a, b = self.window
        out, t = [], a
        for s, e in self.busy_spans():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if b > t:
            out.append((t, b))
        return out

    def host_doing(self, t: float) -> str:
        """The innermost host operation running at time ``t``."""
        best: Optional[Span] = None
        for h in self.host:
            if h.start <= t <= h.end and (best is None or h.start >= best.start):
                best = h
        return best.name if best is not None else "host"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time in the window, by name,
        and the longest idle gaps, by what the host was doing."""
        by_name: Dict[str, float] = {}
        a, b = self.window
        for s in self.device:
            if s.start >= a and s.end <= b:
                by_name[s.name] = by_name.get(s.name, 0.0) + s.seconds
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[self.host_doing((g0 + g1) / 2), g1 - g0] for g0, g1 in gaps]}


def read(prof) -> TraceRead:
    """The spans of a finished :func:`profile`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    calls, device, host, kernels = [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        span = Span(ev.name(), start, start + ev.duration_ns() * 1e-9)
        if ev.device_type() == cuda:
            if ev.is_user_annotation():
                continue
            device.append(span)
            if not span.name.startswith(("Memcpy", "Memset")):
                kernels.append(span)
        elif span.name == CALL:
            calls.append(span)
        else:
            host.append(span)
    calls.sort(key=lambda s: s.start)
    return TraceRead(calls=calls, device=device, host=host, kernels=kernels)
