"""The work a render must do whatever implements it, and the card's peaks.

``rays_per_render`` is a frozen copy of
``ensem3a_openclraytracer_tpu_torch/utils/profiling.py`` :21-28.  The
operation constants are ``chip_smoke.py`` :200-215's: 45 FP32 operations a
(ray, triangle) test and 148 a lane and bounce of shading, 27 more a sun
shadow ray.  The peaks are NVIDIA's data sheet for the H100 SXM at 700 W:
67 TFLOP/s in FP32 outside the tensor cores, 3.35 TB/s of HBM3."""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_TEST = 45
FLOPS_PER_SHADE = 148
FLOPS_PER_SUN = 27


def rays_per_render(res: int, spp: int, max_bounce: int, sun_enabled: bool) -> int:
    """Ray segments of one render as the upstream renderer counts them: one
    cached primary, then up to ``max_bounce + 1`` bounce segments per
    sample, and one sun shadow segment per bounce with the sun on
    (Raytracing.cl:82, :124, :184)."""
    per_sample = (max_bounce + 1) * (2 if sun_enabled else 1)
    return res * res * (1 + spp * per_sample)


def least_seconds(segments: float, lanes: float, sun: float, nbytes: float) -> float:
    """The least time the work could take on the card: one ray-triangle
    test for every segment traced, the shading of every lane and bounce
    and of every sun ray, and every input and output byte once."""
    flops = FLOPS_PER_TEST * segments + FLOPS_PER_SHADE * lanes + FLOPS_PER_SUN * sun
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)
