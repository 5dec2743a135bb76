"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each entry point that users call as one compiled XLA
program (``render_radiance_jit``, the progressive chunk function, the
train step, ``make_sharded_renderer``).  The port's counterparts are
eager PyTorch: one host dispatch per tensor operation, which leaves the
card idle most of the time on the scan estimator and the replay
(PERF.md).  On the card a CUDA graph plays the part of the compiled
program: every kernel of one call, the hand-written ones included, is
captured once and replayed with one host call.

:class:`Graphed` wraps a function of tensors (arguments may be tensors,
``NamedTuple``s, tuples, lists and dicts of them, and Python values):

* **The cache key** is every Python value among the arguments (the JAX
  counterparts' ``static_argnames``: ``height``, ``width``, ``spp``,
  ``max_bounce``, ``sun_enabled``, ``nee``, ...; ``None`` for an absent
  optional input) and the shape, dtype and device of every tensor.  A new
  key captures a new graph; at most ``MAX_GRAPHS`` are kept, the least
  recently used going first.
* **Arguments named in** ``in_place`` (the geometry pack: features,
  packed rows, tree rows, per-triangle tables) are read where they lie; a
  name ``"arg.field"`` names one field of a ``NamedTuple`` argument (the
  IBL: ``"env.ibl"``).  The key also holds each of their tensors' address
  and strides, and a graph is dropped, with its memory pool, when one of
  them is freed.
* **Every other tensor** (materials, the rest of the environment, camera,
  lights, the Philox key words, a target image, trainable parameters and
  Adam state) is copied into the graph's own input buffer before each
  replay.
* **The first call with a key** runs the function once on a side stream
  (the warm-up: the kernels' libraries load, launch plans and memory
  budgets are asked of the card, all outside the capture) and returns
  clones of that run's outputs; then it captures the graph into a private
  memory pool under ``torch.cuda.set_sync_debug_mode("error")``, so a
  host sync in the captured code raises.  Later calls replay the graph and
  return clones of its outputs, which the next replay overwrites.
* **Launch counters** (``ops/launches``): a kernel wrapper counts where it
  launches, so the warm-up counts its launches and a replay, which runs
  no wrapper, counts none.  A capture records launches without running
  them: the counters are put back after it, and what it recorded is
  ``last_capture["launches"]``.  A profiler trace of a replay shows its
  kernels (``ops/launches.count_kernels``).
* **Counter records** (``utils/profiling.count``, while a profiler
  records): each call records under ``"graphs"`` the bytes it copies into
  the graph's buffers and clones out of its outputs.  The counts that the
  captured code makes (``"scatter"``) are tallied at the capture
  (``last_capture["counts"]``) and recorded again at each replay, which
  runs none of that code.
* **CPU tensors** run the function eagerly: graphs exist only on the
  card.  On the card a capture that fails raises; nothing falls back to
  the eager call.

The capture backend is an argument (:class:`CudaGraphs` by default), so
the rules above can be tested on the CPU with a stand-in.

Spans (``utils/profiling.span``, while a profiler records): each call is
``graphs.call``; inside it ``graphs.key`` (flatten and key), then on a
cached key ``graphs.copy_in``, ``graphs.replay`` and ``graphs.clone_out``,
on a new key ``graphs.warm_up`` and ``graphs.capture`` (capture and
instantiation), and on a device the backend does not take ``graphs.eager``.
They are outside the captured function, so a graph, its key and its nodes
are the same with a profiler on or off.
"""

from __future__ import annotations

import inspect
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Iterable, List, NamedTuple, Optional, Tuple

import torch

from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.utils.profiling import count, recording, span, tallied

MAX_GRAPHS = 8  # graphs kept per Graphed: each holds a memory pool on the card

_TENSOR = "tensor"


def flatten(x: Any) -> Tuple[List[torch.Tensor], Any]:
    """``(tensors, spec)``: the tensor leaves of ``x`` in order, and a
    hashable spec of its structure holding every other value."""
    leaves: List[torch.Tensor] = []
    return leaves, _flatten(x, leaves)


def _flatten(x: Any, leaves: List[torch.Tensor]) -> Any:
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if x is None or isinstance(x, (bool, int, float, str)):
        return ("value", type(x), x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("namedtuple", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(x), tuple(_flatten(v, leaves) for v in x.values()))
    raise TypeError(f"a graphed function takes tensors, their tuples, lists, dicts and "
                    f"NamedTuples, and Python values; not {type(x).__name__}")


def unflatten(spec: Any, tensors: Iterable[torch.Tensor]) -> Any:
    """The value that :func:`flatten` took apart, with ``tensors`` as its
    tensor leaves."""
    return _unflatten(spec, iter(tensors))


def _unflatten(spec: Any, it) -> Any:
    if spec == _TENSOR:
        return next(it)
    tag = spec[0]
    if tag == "value":
        return spec[2]
    if tag == "namedtuple":
        return spec[1](*(_unflatten(s, it) for s in spec[2]))
    if tag == "dict":
        return dict(zip(spec[1], [_unflatten(s, it) for s in spec[2]]))
    return tag(_unflatten(s, it) for s in spec[1])


class CudaGraphs:
    """The capture backend on the card: ``torch.cuda.CUDAGraph``."""

    @staticmethod
    def takes(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def warm_up(run: Callable[[], Any], device: torch.device) -> Any:
        with torch.cuda.device(device):
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = run()
            cur.wait_stream(side)
            for t in flatten(out)[0]:
                t.record_stream(cur)  # read on this stream by the caller's clone
            return out

    @staticmethod
    def capture(run: Callable[[], Any], device: torch.device) -> Tuple[Any, Any, dict]:
        """``(graph, outputs, info)``: ``info`` holds the seconds of the
        capture and of the instantiation, and the bytes the graph's pool
        reserved."""
        with torch.cuda.device(device):
            graph = torch.cuda.CUDAGraph()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # as torch.cuda.graph does: the growth is then the pool's
            reserved = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = run()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                t1 = time.perf_counter()
            t2 = time.perf_counter()  # leaving the block instantiated the graph
            return graph, out, dict(capture_s=t1 - t0, instantiate_s=t2 - t1,
                                    pool_bytes=torch.cuda.memory_reserved() - reserved)

    @staticmethod
    def replay(graph, device: torch.device) -> None:
        with torch.cuda.device(device):
            graph.replay()


class _Entry(NamedTuple):
    graph: Any
    inputs: List[torch.Tensor]  # the graph's input buffers, in call order
    out_spec: Any
    outputs: List[torch.Tensor]  # the graph's outputs, overwritten by each replay
    info: dict
    in_place: list  # weak references to the tensors read in place: the entry goes with them


class Graphed:
    """``fn`` captured as a CUDA graph per cache key and replayed (module
    docstring).  ``in_place`` names the arguments, or ``"arg.field"`` the
    ``NamedTuple`` fields, read where they lie.  ``captures`` counts the
    graphs captured; ``last_capture`` describes the latest: warm-up,
    capture and instantiation seconds, the pool's bytes, the launches
    the graph recorded, by counter, and the counts its code made
    (``counts``: name -> field -> sum)."""

    def __init__(self, fn: Callable, *, in_place: Iterable[str] = (), backend=None):
        self.fn = fn
        self.in_place = frozenset(in_place)
        self.backend = backend if backend is not None else CudaGraphs()
        self._sig = inspect.signature(fn)
        self._graphs: "OrderedDict[Any, _Entry]" = OrderedDict()
        self.captures = 0
        self.last_capture: Optional[dict] = None

    def clear(self) -> None:
        """Drop every graph and its memory pool."""
        self._graphs.clear()

    def __call__(self, *args, **kwargs):
        with span("graphs.call"):
            with span("graphs.key"):
                found = self._lookup(args, kwargs)
            if found is None:
                with span("graphs.eager"):
                    return self.fn(*args, **kwargs)
            key, bound, parts, dev, entry = found
            if entry is None:
                return self._capture(key, bound, parts, dev)
            self._graphs.move_to_end(key)
            with span("graphs.copy_in"):
                copied = [t for _, leaves, _, mask in parts for t, p in zip(leaves, mask) if not p]
                for buf, t in zip(entry.inputs, copied):
                    buf.copy_(t)
            with span("graphs.replay"):
                self._replay(entry, dev)
            with span("graphs.clone_out"):
                outs = [t.clone() for t in entry.outputs]
            if recording():
                _count_bytes(copied, outs)
            return unflatten(entry.out_spec, outs)

    def _replay(self, entry: _Entry, dev) -> None:
        if not recording():
            self.backend.replay(entry.graph, dev)
            return
        with tallied():  # a stand-in backend's replay runs Python: the capture's tally counts it
            self.backend.replay(entry.graph, dev)
        for name, values in entry.info["counts"].items():
            count(name, **values)

    def _lookup(self, args, kwargs):
        """``(key, bound arguments, their parts, device, entry)`` of a call
        that the backend takes (``entry`` None for a new key); None for a
        call with no tensor or on a device it does not take."""
        bound = self._sig.bind(*args, **kwargs)
        parts = [(name, *flatten(value), self._in_place_mask(name, value))
                 for name, value in bound.arguments.items()]
        tensors = [t for _, leaves, _, _ in parts for t in leaves]
        devices = {t.device for t in tensors}
        if len(devices) > 1:
            raise ValueError(f"a graphed call takes tensors on one device, not {devices}")
        if not devices or not self.backend.takes(next(iter(devices))):
            return None
        dev = devices.pop()
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise ValueError("a graphed call returns no autograd graph: give it no tensor that "
                             "requires grad (differentiate the eager function)")
        key = tuple((name, spec, tuple(_signature(t, p) for t, p in zip(leaves, mask)))
                    for name, leaves, spec, mask in parts)
        return key, bound, parts, dev, self._graphs.get(key)

    def _in_place_mask(self, name: str, value: Any) -> List[bool]:
        """For each tensor leaf of argument ``name``, whether it is read in
        place."""
        n = len(flatten(value)[0])
        if name in self.in_place:
            return [True] * n
        fields = getattr(value, "_fields", ())
        if not any(f"{name}.{f}" in self.in_place for f in fields):
            return [False] * n
        return [f"{name}.{f}" in self.in_place
                for f, v in zip(fields, value) for _ in flatten(v)[0]]

    def _capture(self, key, bound, parts, dev):
        inputs, held = [], []
        for name, leaves, spec, mask in parts:
            bufs = [t if p else t.detach().clone() for t, p in zip(leaves, mask)]
            inputs += [b for b, p in zip(bufs, mask) if not p]
            held += [t for t, p in zip(leaves, mask) if p]
            bound.arguments[name] = unflatten(spec, bufs)
        run = lambda: self.fn(*bound.args, **bound.kwargs)
        t0 = time.perf_counter()
        with span("graphs.warm_up"):
            out = self.backend.warm_up(run, dev)
            out_tensors, out_spec = flatten(out)
            result = unflatten(out_spec, [t.clone() for t in out_tensors])
        warm_s = time.perf_counter() - t0
        before = launches.read()
        try:
            with span("graphs.capture"), tallied() as counts:
                graph, static_out, info = self.backend.capture(run, dev)
            after = launches.read()
        finally:
            launches.restore(before)  # the capture ran no kernel
        outputs, spec = flatten(static_out)
        if spec != out_spec:
            raise RuntimeError("the captured run returned another structure than the warm-up")
        recorded = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        info = dict(info, warm_up_s=warm_s, launches=recorded, counts=counts)
        drop = lambda _ref, graphs=self._graphs: graphs.pop(key, None)
        self._graphs[key] = _Entry(graph, inputs, spec, outputs, info,
                                   [weakref.ref(t, drop) for t in held])
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        self.captures += 1
        self.last_capture = info
        if recording():
            _count_bytes(inputs, flatten(result)[0])
        return result


def _count_bytes(copied_in: List[torch.Tensor], cloned_out: List[torch.Tensor]) -> None:
    count("graphs", calls=1, copy_in_bytes=sum(t.nbytes for t in copied_in),
          clone_out_bytes=sum(t.nbytes for t in cloned_out))


def _signature(t: torch.Tensor, in_place: bool) -> tuple:
    sig = (tuple(t.shape), t.dtype, t.device)
    return sig + (t.data_ptr(), t.stride()) if in_place else sig
