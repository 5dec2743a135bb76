"""The closed-loop window and its arithmetic.

One client waits for each call's answer before it makes the next, as a
user waits for an image or a step.  A call is timed from its start to its
answer on the host.  The window runs from the first call's start to the
end of the first call that ends after ``seconds``; a rate is the work of
every call over that whole span, a percentile is over every call."""

from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class Window:
    latencies: List[float] = field(default_factory=list)  # seconds per call
    start: float = 0.0
    end: float = 0.0

    @property
    def calls(self) -> int:
        return len(self.latencies)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def rate(self, work_per_call: float) -> float:
        """Work per second over the whole window."""
        return work_per_call * self.calls / self.seconds

    def percentile(self, q: int) -> float:
        """The ``q``-th percentile (1..99) of the calls' latencies, seconds."""
        if self.calls == 1:
            return self.latencies[0]
        return statistics.quantiles(self.latencies, n=100, method="inclusive")[q - 1]

    def per_call(self) -> float:
        """Window seconds per call."""
        return self.seconds / self.calls


class Reservoir:
    """A uniform sample of ``k`` of the answers, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def closed_loop(call: Callable[[int], object], seconds: float,
                keep: Optional[Callable[[int, object], None]] = None,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``call(i)`` for i = 0, 1, ... until ``seconds`` have passed;
    ``keep(i, answer)`` sees every answer outside the timed span."""
    w = Window(start=clock())
    i = 0
    while True:
        t0 = clock()
        answer = call(i)
        t1 = clock()
        w.latencies.append(t1 - t0)
        w.end = t1
        if keep is not None:
            keep(i, answer)
        i += 1
        if t1 - w.start >= seconds:
            return w
