"""The check that a run loaded neither JAX nor the JAX package.

Top-level module names are compared whole: the port's package name,
``ensem3a_openclraytracer_tpu_torch``, begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "ensem3a_openclraytracer_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: ``sys.modules``)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
