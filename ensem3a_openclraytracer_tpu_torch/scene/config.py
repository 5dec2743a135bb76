"""Per-scene ini-style configuration, file-compatible with the reference.

Same ``key=value`` format, key names, and default template as the
reference's ``configReader`` (FileManager.py:350-425), so existing
``<scene>.ini`` files (e.g. the reference's ``Cornell box.ini``) load
verbatim.  Values are cached in memory and written back in one pass, and
typed accessors expose render / camera / environment / material
parameters as structured data.  A copy of the JAX package's module (the
port imports nothing from it).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

DEFAULT_TEMPLATE = {
    "resolution": "256",
    "spp": "10",
    "maxBounce": "4",
    "cam_x": "0",
    "cam_y": "0",
    "cam_z": "0",
    "cam_rx": "0",
    "cam_ry": "0",
    "cam_rz": "0",
    "cam_DOF": "45",  # actually field-of-view in degrees (main.py:61)
    "IBLfile": "IBL/Arches_E_PineTree_8k.jpg",
    "IBL_Power": "1.0",
    "sun_Power": "1.0",
    "sun_rx": "0",
    "sun_ry": "0",
    "sun_rz": "0",
}

MATERIAL_FIELDS = ("Type", "Color_R", "Color_G", "Color_B", "roughness", "ior")
MATERIAL_DEFAULTS = ("1", "1", "1", "1", "0", "0")


@dataclass(frozen=True)
class RenderSettings:
    """Static render parameters (shape-determining; jit static args)."""

    resolution: int = 256
    spp: int = 10
    max_bounce: int = 4


@dataclass(frozen=True)
class CameraSettings:
    position: tuple = (0.0, 0.0, 0.0)
    rotation_deg: tuple = (0.0, 0.0, 0.0)
    fov_deg: float = 45.0


@dataclass(frozen=True)
class EnvironmentSettings:
    sun_angles_deg: tuple = (0.0, 0.0, 0.0)
    sun_power: float = 1.0
    ibl_power: float = 1.0
    ibl_file: str = ""


class ConfigReader:
    """ini-compatible config store with the reference's API surface
    (``getParameter`` / ``setParameter`` / ``loadParameters``) plus typed
    accessors.  Creates the default file when missing, mirroring
    FileManager.py:355-383."""

    def __init__(self, config_path: str, material_count: int = 0):
        self.config_path = config_path
        self._params: dict[str, str] = {}
        if os.path.exists(config_path):
            self._read()
        else:
            self._params["sceneFile"] = config_path.replace(".ini", ".obj")
            self._params.update(DEFAULT_TEMPLATE)
            # reference writes materialCount+1 records (FileManager.py:377)
            for i in range(material_count + 1):
                for field, dv in zip(MATERIAL_FIELDS, MATERIAL_DEFAULTS):
                    self._params[f"M_{i}_{field}"] = dv
            self._write()

    # -- file io ------------------------------------------------------------

    def _read(self) -> None:
        self._params = {}
        with open(self.config_path, "r", encoding="utf-8") as f:
            for line in f:
                if "=" not in line:
                    continue
                key, _, value = line.partition("=")
                self._params[key.strip()] = value.rstrip("\n")

    def _write(self) -> None:
        with open(self.config_path, "w", encoding="utf-8") as f:
            for key, value in self._params.items():
                f.write(f"{key}={value}\n")

    # -- reference-parity API -------------------------------------------------

    def getParameter(self, param: str) -> str:
        return self._params.get(param, "")

    def setParameter(self, param: str, value) -> None:
        self._params[param] = str(value)
        self._write()

    def loadParameters(self) -> dict[str, str]:
        return dict(self._params)

    # -- batched / pythonic API ----------------------------------------------

    def set_many(self, updates: dict) -> None:
        for k, v in updates.items():
            self._params[k] = str(v)
        self._write()

    def get(self, param: str, default: str = "") -> str:
        return self._params.get(param, default)

    def get_float(self, param: str, default: float = 0.0) -> float:
        v = self._params.get(param, "")
        try:
            return float(v)
        except ValueError:
            return default

    def get_int(self, param: str, default: int = 0) -> int:
        return int(self.get_float(param, default))

    # -- typed accessors -------------------------------------------------------

    def render_settings(self) -> RenderSettings:
        return RenderSettings(
            resolution=self.get_int("resolution", 256),
            spp=self.get_int("spp", 10),
            max_bounce=self.get_int("maxBounce", 4),
        )

    def camera_settings(self) -> CameraSettings:
        return CameraSettings(
            position=(
                self.get_float("cam_x"),
                self.get_float("cam_y"),
                self.get_float("cam_z"),
            ),
            rotation_deg=(
                self.get_float("cam_rx"),
                self.get_float("cam_ry"),
                self.get_float("cam_rz"),
            ),
            fov_deg=self.get_float("cam_DOF", 45.0),
        )

    def environment_settings(self) -> EnvironmentSettings:
        return EnvironmentSettings(
            sun_angles_deg=(
                self.get_float("sun_rx"),
                self.get_float("sun_ry"),
                self.get_float("sun_rz"),
            ),
            sun_power=self.get_float("sun_Power", 1.0),
            ibl_power=self.get_float("IBL_Power", 1.0),
            ibl_file=self.get("IBLfile", ""),
        )

    def material_table(self, num_materials: int) -> np.ndarray:
        """Materials as the reference's float32 ``[M, 6]`` ABI
        ``[type, R, G, B, roughness, ior]`` from ``M_<i>_*`` keys; missing
        records fall back to the defaults (diffuse white)."""
        out = np.zeros((num_materials, 6), np.float32)
        for i in range(num_materials):
            for j, (field, dv) in enumerate(zip(MATERIAL_FIELDS, MATERIAL_DEFAULTS)):
                out[i, j] = self.get_float(f"M_{i}_{field}", float(dv))
        return out

    def set_material(self, index: int, *, mtype=None, color=None, roughness=None, ior=None):
        """Write one material record back to the config (UI capability:
        edit materials and re-render, SURVEY.md section 2.5 item 11)."""
        updates = {}
        if mtype is not None:
            updates[f"M_{index}_Type"] = int(mtype)
        if color is not None:
            updates[f"M_{index}_Color_R"] = float(color[0])
            updates[f"M_{index}_Color_G"] = float(color[1])
            updates[f"M_{index}_Color_B"] = float(color[2])
        if roughness is not None:
            updates[f"M_{index}_roughness"] = float(roughness)
        if ior is not None:
            updates[f"M_{index}_ior"] = float(ior)
        self.set_many(updates)
