"""The ``(dp, sp)`` process mesh for sharded rendering.

Counterpart of the JAX package's ``parallel/mesh.py``, with one process
(rank) per device in place of one JAX device per mesh slot:

* ``dp``: pixel parallelism.  Each rank owns a contiguous block of image
  rows; the scene is replicated, so the forward pass exchanges nothing
  but the final image.
* ``sp``: sample parallelism.  The ranks of one ``dp`` row estimate
  disjoint sample sets of the same pixels and average them over the
  ``sp`` group.

Rank ``r`` of the first ``dp * sp`` ranks sits at ``(r // sp, r % sp)``,
as JAX's ``devices.reshape(dp, sp)`` places device ``r``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A ``dp x sp`` mesh and this rank's place in it.

    ``sp_group`` holds the ranks that share this rank's rows, ``dp_group``
    the ranks that share its sample set and ``group`` every rank of the
    mesh.  A mesh without process groups (:func:`single_device_mesh`) runs
    the sharded code paths in one process with no collective."""

    dp: int
    sp: int
    dp_idx: int
    sp_idx: int
    dp_group: Any = None
    sp_group: Any = None
    group: Any = None

    @property
    def size(self) -> int:
        return self.dp * self.sp


def single_device_mesh() -> Mesh:
    """A 1x1 mesh that needs no process group."""
    return Mesh(dp=1, sp=1, dp_idx=0, sp_idx=0)


def make_mesh(sp: int = 1, world: Optional[int] = None) -> Optional[Mesh]:
    """The ``(world // sp, sp)`` mesh over ranks ``0 .. world - 1`` of the
    default process group (``world`` defaults to all of them).

    Every rank of the default group must call it (``new_group`` is
    collective); a rank outside the mesh gets ``None``.  Without an
    initialized process group the world is this one process, and a 1x1
    mesh is :func:`single_device_mesh`."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    world = size if world is None else world
    if not 1 <= world <= size:
        raise ValueError(f"a mesh of {world} ranks in a world of {size}")
    if sp < 1 or world % sp != 0:
        raise ValueError(f"sp={sp} must divide the mesh's rank count {world}")
    if not dist.is_initialized():
        return single_device_mesh()
    dp, rank = world // sp, dist.get_rank()
    # the same groups, created in the same order, on every rank
    sp_groups = [dist.new_group(list(range(d * sp, (d + 1) * sp))) for d in range(dp)]
    dp_groups = [dist.new_group(list(range(s, world, sp))) for s in range(sp)]
    group = dist.new_group(list(range(world)))
    if rank >= world:
        return None
    d, s = divmod(rank, sp)
    return Mesh(dp=dp, sp=sp, dp_idx=d, sp_idx=s, dp_group=dp_groups[s],
                sp_group=sp_groups[d], group=group)
