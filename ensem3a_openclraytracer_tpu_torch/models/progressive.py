"""Progressive, resumable rendering with on-disk checkpoints.

Counterpart of the JAX package's ``models/progressive.py``.  A render is a
fold over chunks of ``chunk_spp`` samples; its state ``(accum, spp_done,
base_seed)`` is saved as an ``.npz`` with the JAX package's keys, so a
checkpoint written by either package resumes in the other.  Chunk ``i``
renders with :func:`~ensem3a_openclraytracer_tpu_torch.models.optimize.iteration_generator`
``(base_seed, i)``, a pure function of the two, so a resumed or retried
chunk draws the samples it drew before.

Each chunk is one call of a ``parallel/render.make_sharded_renderer``
function with the default engine, gathered on every rank of ``mesh``;
without a mesh it runs on a 1x1 mesh, which renders ``render_radiance``'s
chunk bit for bit.  On a one-rank mesh on the card that function is a
captured CUDA graph, as the JAX package jits its chunk function: the
first chunk captures it, and every later chunk replays it with its own
key words.  Checkpoints, retries and the float64 sum stay eager.  Its
radiance times ``chunk_spp`` is added, in float64 and on the device, to a
copy of ``accum``; the copy comes back to the host only at checkpoints
and at the end (the fold).  The sum is the same left fold whatever the
checkpoint interval, so a render stopped and resumed is bit-equal to one
that ran through.  ``state.spp_done`` counts folded samples only; the
samples still on the device are ``spp_pending``.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch.models.optimize import iteration_generator
from ensem3a_openclraytracer_tpu_torch.parallel.mesh import Mesh, single_device_mesh
from ensem3a_openclraytracer_tpu_torch.parallel.render import gather_image, make_sharded_renderer


@dataclass
class ProgressiveState:
    """Running sample sum; ``image`` is the current radiance mean."""

    accum: np.ndarray  # [H, W, 3] float64: sum over chunks of mean radiance * chunk spp
    spp_done: int
    base_seed: int

    @property
    def image(self) -> np.ndarray:
        if self.spp_done == 0:
            return np.zeros_like(self.accum, dtype=np.float32)
        return (self.accum / self.spp_done).astype(np.float32)

    def save(self, path: str) -> None:
        """Write the state atomically (a temporary file in the same
        directory, then ``os.replace``)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                # uncompressed: zlib on a 512^2 float64 sum took most of a
                # second per checkpoint on the card's host (PERF.md, PR 8)
                np.savez(f, accum=np.asarray(self.accum, np.float64),
                         spp_done=np.int64(self.spp_done), base_seed=np.int64(self.base_seed))
            os.replace(tmp, path)  # a crash never leaves a half-written checkpoint
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @staticmethod
    def load(path: str) -> "ProgressiveState":
        with np.load(path) as z:
            return ProgressiveState(accum=np.asarray(z["accum"], np.float64),
                                    spp_done=int(z["spp_done"]), base_seed=int(z["base_seed"]))


class ProgressiveRenderer:
    """Renders in chunks of ``chunk_spp`` samples; checkpointable between
    chunks.  The scene tensors' device is the render's device."""

    # a chunk that raises RuntimeError is tried this many more times with
    # the same generator seed (identical samples) before the error
    # propagates; on the card each attempt synchronizes inside the try, so
    # an asynchronous CUDA error is caught by the chunk that caused it
    max_chunk_retries = 2

    def __init__(self, geom, materials, env, camera, *, height: int, width: int,
                 max_bounce: int, chunk_spp: int = 16, sun_enabled: bool = True,
                 base_seed: int = 0, state: Optional[ProgressiveState] = None, lights=None,
                 nee: bool = False, glass_mode: str = "tint", mis: bool = False,
                 mesh: Optional[Mesh] = None):
        self.geom, self.materials, self.env, self.camera = geom, materials, env, camera
        self.chunk_spp = chunk_spp
        self.mesh = mesh if mesh is not None else single_device_mesh()
        self.device = geom.v0.device
        self.state = state or ProgressiveState(accum=np.zeros((height, width, 3), np.float64),
                                               spp_done=0, base_seed=base_seed)
        self.spp_pending = 0  # rendered samples not yet folded into state.accum
        self._acc = None  # on the device: state.accum plus the pending chunks
        self._render = make_sharded_renderer(
            self.mesh, height=height, width=width, spp=chunk_spp, max_bounce=max_bounce,
            sun_enabled=sun_enabled, lights=lights, nee=nee, glass_mode=glass_mode, mis=mis)

    def _chunk_fn(self, gen: torch.Generator) -> torch.Tensor:
        """One chunk's mean radiance ``[H, W, 3]``."""
        rows = self._render(self.geom, self.materials, self.env, self.camera, gen)
        return gather_image(self.mesh, rows)

    def _chunk_with_retry(self, index: int) -> torch.Tensor:
        for attempt in range(self.max_chunk_retries + 1):
            try:
                chunk = self._chunk_fn(iteration_generator(self.state.base_seed, index,
                                                           self.device))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                return chunk
            except RuntimeError as e:
                if attempt == self.max_chunk_retries:
                    raise
                print(f"chunk {index} failed ({type(e).__name__}), retrying "
                      f"({attempt + 1}/{self.max_chunk_retries})", flush=True)

    def _add_chunk(self) -> None:
        index = (self.state.spp_done + self.spp_pending) // self.chunk_spp
        chunk = self._chunk_with_retry(index)
        if self._acc is None:
            self._acc = torch.as_tensor(self.state.accum, dtype=torch.float64, device=self.device)
        # out of place: on the CPU the tensor may share memory with state.accum
        self._acc = self._acc + chunk.to(torch.float64) * self.chunk_spp
        self.spp_pending += self.chunk_spp

    def fold(self) -> None:
        """Move the pending samples into ``state`` (one device-to-host copy)."""
        if self.spp_pending:
            self.state.accum = self._acc.cpu().numpy()
            self.state.spp_done += self.spp_pending
            self.spp_pending = 0
            self._acc = None

    def step(self) -> np.ndarray:
        """Render one chunk, fold it and return the current image."""
        self._add_chunk()
        self.fold()
        return self.state.image

    def render(self, total_spp: int, checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 1,
               progress: Optional[Callable[[int, int], None]] = None) -> np.ndarray:
        """Render whole chunks until at least ``total_spp`` samples (resumed
        ones included) are done, folding and saving to ``checkpoint_path``
        every ``checkpoint_every`` chunks and at the end; returns the image
        ``[H, W, 3]`` float32."""
        chunks, saved = 0, False
        while self.state.spp_done + self.spp_pending < total_spp:
            self._add_chunk()
            chunks += 1
            saved = False
            if checkpoint_path and chunks % checkpoint_every == 0:
                self.fold()
                self.state.save(checkpoint_path)
                saved = True
            if progress is not None:
                progress(self.state.spp_done + self.spp_pending, total_spp)
        self.fold()
        if checkpoint_path and not saved:
            self.state.save(checkpoint_path)
        return self.state.image

    @staticmethod
    def resume(checkpoint_path: str, geom, materials, env, camera,
               **kw) -> "ProgressiveRenderer":
        state = ProgressiveState.load(checkpoint_path)
        return ProgressiveRenderer(geom, materials, env, camera, state=state,
                                   base_seed=state.base_seed, **kw)
