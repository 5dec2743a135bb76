"""Process-group set-up and the global mesh.

Counterpart of the JAX package's ``parallel/distributed.py``:
:func:`initialize` joins ``torch.distributed`` (one process per device,
launched by ``torchrun`` or by the caller), :func:`global_mesh` builds the
``(dp, sp)`` mesh over every rank, and :func:`process_info` is the
per-process observability record.  In one process without ``torchrun``'s
environment nothing is joined and the mesh is 1x1.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.parallel.mesh import make_mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, device: DeviceLike = None) -> None:
    """``init_process_group`` with ``nccl`` for CUDA and ``gloo`` for the
    CPU.  With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) and
    does nothing when that is absent or a group is already initialized.
    On CUDA each process takes card ``LOCAL_RANK`` (default: ``rank``)."""
    if dist.is_initialized():
        return
    explicit = init_method is not None or world_size is not None or rank is not None
    if not explicit and not all(k in os.environ for k in _TORCHRUN_ENV):
        return
    dev = resolve_device(device)
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://", world_size=world_size,
                            rank=rank, **kw)


def global_mesh(sp: int = 1):
    """The ``(dp, sp)`` mesh over every rank of the default group."""
    return make_mesh(sp=sp)


def process_info() -> dict:
    """This process's rank, the process count, its visible devices and the
    number of devices in the job (one per rank)."""
    on = dist.is_initialized()
    local = ([str(torch.device("cuda", i)) for i in range(torch.cuda.device_count())]
             or [str(torch.device("cpu"))])
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "local_devices": local,
        "global_device_count": dist.get_world_size() if on else 1,
    }
