"""Multi-device scale-out over ``torch.distributed``: the ``(dp, sp)``
mesh, sharded rendering and the gradient sum across ranks."""
