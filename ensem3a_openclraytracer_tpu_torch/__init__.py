"""PyTorch/CUDA port of the differentiable path tracer.

A second package beside ``ensem3a_openclraytracer_tpu`` (the JAX
reference).  It imports ``torch`` and numpy only - never ``jax`` and
nothing of the JAX package - and its module paths mirror the reference's
so each counterpart is easy to find.  Plain tensor code is PyTorch; the
closest-hit query runs in a hand-written CUDA kernel
(``csrc/closest_hit.cu``) on the card and in its plain PyTorch version on
the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA without a card raises.
"""

from ensem3a_openclraytracer_tpu_torch.version import __version__

__all__ = ["__version__"]
