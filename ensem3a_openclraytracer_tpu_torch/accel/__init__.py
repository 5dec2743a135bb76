"""Acceleration structures: LBVH build (Morton/Karras) and validation."""

from ensem3a_openclraytracer_tpu_torch.accel.lbvh import (
    build_lbvh,
    from_reference_abi,
    to_reference_abi,
)
from ensem3a_openclraytracer_tpu_torch.accel.validate import validate_bvh

__all__ = ["build_lbvh", "to_reference_abi", "from_reference_abi", "validate_bvh"]
