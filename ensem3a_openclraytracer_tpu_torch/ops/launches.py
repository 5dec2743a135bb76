"""The launch counters of the port's kernels, in one registry.

Each kernel wrapper keeps a ``LAUNCHES`` dict, made here at import by
:func:`counter`, and adds one to its entry where it launches its kernel
on the card, and nowhere else.  The registry also holds the device names
of the kernels each entry counts, so a profiler trace can be counted the
same way (:func:`count_kernels`): a launch replayed from a CUDA graph
runs no wrapper, and is seen only there.  :func:`trace` is the profiler
window such a count is taken in.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

COUNTERS: List[Dict[str, int]] = []  # every wrapper module's LAUNCHES
KERNELS: Dict[str, Tuple[str, ...]] = {}  # counter name -> the device kernels it counts


def counter(kernels: Dict[str, Tuple[str, ...]]) -> Dict[str, int]:
    """A new ``LAUNCHES`` dict with one entry per counter name of
    ``kernels`` (counter name -> the ``__global__`` function names whose
    launches it counts), set to 0 and joined to the registry."""
    counts = dict.fromkeys(kernels, 0)
    COUNTERS.append(counts)
    KERNELS.update(kernels)
    return counts


def read() -> Dict[str, int]:
    """Every registered count, by counter name."""
    return {k: v for counts in COUNTERS for k, v in counts.items()}


def reset() -> None:
    """Every registered count set to 0."""
    for counts in COUNTERS:
        for k in counts:
            counts[k] = 0


def restore(saved: Dict[str, int]) -> None:
    """Every registered count set to its value in ``saved`` (from
    :func:`read`)."""
    for counts in COUNTERS:
        for k in counts:
            counts[k] = saved.get(k, 0)


TRACE_MARGIN_S = 0.05  # idle host time between each end of a trace's window and the block


@contextlib.contextmanager
def trace(margin_s: float = TRACE_MARGIN_S):
    """``torch.profiler`` (CPU and CUDA activity) around the block, which
    yields the profiler.  The block's device work is ended by a synchronize,
    and ``margin_s`` of idle time lies between each end of the profiler's
    window and the block: the profiler keeps a device record
    only where its time, converted to the host's clock, falls inside the
    window, and that conversion can be off by milliseconds, so a block that
    starts as the window opens loses its first kernels now and then
    (``experiments/trace_window.py`` counts how often)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin_s)


_NAME = re.compile(r"^(?:void\s+)?(?:\w+::)*(\w+)(?:<[^()]*>)?\(")  # a template's arguments too


def counter_of(device_name: str) -> Optional[str]:
    """The counter that counts a kernel, from its device name as a profiler
    gives it (``"void (anonymous namespace)::pairs_kernel<8>(...)"``); None
    for a kernel of no wrapper."""
    m = _NAME.match(device_name.replace("(anonymous namespace)::", ""))
    if m is None:
        return None
    return next((c for c, names in KERNELS.items() if m.group(1) in names), None)


def count_kernels(device_names: Iterable[str]) -> Dict[str, int]:
    """Launches by counter name among the device kernels ``device_names``
    (one name per kernel run, as a profiler lists them), 0 for each
    registered counter that none of them ran."""
    counts = dict.fromkeys(KERNELS, 0)
    for name in device_names:
        c = counter_of(name)
        if c is not None:
            counts[c] += 1
    return counts
