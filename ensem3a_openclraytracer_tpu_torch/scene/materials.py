"""Material, environment and camera parameters as tensors.

The differentiable parameter surface of the renderer: material color /
roughness-or-emissive-power / ior, sun and IBL powers, sun angles and the
IBL texels (material ABI ``[type, R, G, B, roughness, ior]``; type codes
in ops/bsdf.py).  Counterpart of the JAX package's pytrees of the same
names; every constructor takes an explicit ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


class MaterialParams(NamedTuple):
    """SoA material table.  ``mtype`` is integer-coded (0 emissive,
    1 diffuse, 2 glossy, 3 glass) and non-differentiable; the rest may
    require grad."""

    mtype: torch.Tensor  # [M] int32
    color: torch.Tensor  # [M, 3] float32
    roughness: torch.Tensor  # [M] float32 (emissive power for type 0)
    ior: torch.Tensor  # [M] float32 (used by glass_mode="refract")

    @staticmethod
    def from_table(table: np.ndarray, device: DeviceLike = None) -> "MaterialParams":
        """From the reference's ``[M, 6]`` float ABI."""
        dev = resolve_device(device)
        table = np.asarray(table, np.float32).reshape(-1, 6)
        return MaterialParams(
            mtype=torch.as_tensor(table[:, 0].astype(np.int32), device=dev),
            color=_f32(table[:, 1:4], dev),
            roughness=_f32(table[:, 4], dev),
            ior=_f32(table[:, 5], dev),
        )

    def to_table(self) -> np.ndarray:
        """Back to the ``[M, 6]`` ABI (for config write-back)."""
        out = np.zeros((self.mtype.shape[0], 6), np.float32)
        out[:, 0] = self.mtype.detach().cpu().numpy().astype(np.float32)
        out[:, 1:4] = self.color.detach().cpu().numpy()
        out[:, 4] = self.roughness.detach().cpu().numpy()
        out[:, 5] = self.ior.detach().cpu().numpy()
        return out


class EnvParams(NamedTuple):
    """Environment lighting (reference envData ABI ``[sun_rx, sun_ry,
    sun_rz, sun_Power, IBL_Power]`` plus the IBL image)."""

    sun_angles_deg: torch.Tensor  # [3] float32
    sun_power: torch.Tensor  # [] float32
    ibl_power: torch.Tensor  # [] float32
    ibl: torch.Tensor  # [H, W, 3] float32

    @staticmethod
    def create(sun_angles_deg=(0.0, 0.0, 0.0), sun_power=1.0, ibl_power=1.0,
               ibl=None, device: DeviceLike = None) -> "EnvParams":
        """``ibl``: an ``[H, W, 3]`` image (array or tensor; the default
        sky when None)."""
        dev = resolve_device(device)
        if ibl is None:
            ibl = default_sky(8, 16)
        # a float32 tensor on the device is kept as it is
        ibl = (ibl.to(device=dev, dtype=torch.float32) if isinstance(ibl, torch.Tensor)
               else _f32(ibl, dev))
        return EnvParams(
            sun_angles_deg=_f32(sun_angles_deg, dev),
            sun_power=_f32(sun_power, dev),
            ibl_power=_f32(ibl_power, dev),
            ibl=ibl,
        )


class CameraParams(NamedTuple):
    """Pinhole camera (reference cam ABI fields 0-5 and 9)."""

    position: torch.Tensor  # [3] float32
    rotation_deg: torch.Tensor  # [3] float32
    fov_deg: torch.Tensor  # [] float32 (the ini's misnamed cam_DOF)

    @staticmethod
    def create(position=(0.0, 0.0, 0.0), rotation_deg=(0.0, 0.0, 0.0),
               fov_deg=45.0, device: DeviceLike = None) -> "CameraParams":
        dev = resolve_device(device)
        return CameraParams(
            position=_f32(position, dev),
            rotation_deg=_f32(rotation_deg, dev),
            fov_deg=_f32(fov_deg, dev),
        )


def default_sky(height: int = 64, width: int = 128) -> np.ndarray:
    """Procedural gradient sky used when the configured IBL image is
    missing."""
    v = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    horizon = np.array([0.8, 0.85, 0.95], np.float32)
    zenith = np.array([0.2, 0.35, 0.7], np.float32)
    img = horizon * (1.0 - v) + zenith * v
    return np.broadcast_to(img, (height, width, 3)).copy()
