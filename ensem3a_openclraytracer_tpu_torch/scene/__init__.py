"""Scene pipeline: OBJ import, ini config, materials, packing."""

from ensem3a_openclraytracer_tpu_torch.scene.config import (
    CameraSettings,
    ConfigReader,
    EnvironmentSettings,
    RenderSettings,
)
from ensem3a_openclraytracer_tpu_torch.scene.materials import (
    CameraParams,
    EnvParams,
    MaterialParams,
)
from ensem3a_openclraytracer_tpu_torch.scene.objloader import ObjMesh, load_obj
from ensem3a_openclraytracer_tpu_torch.scene.scene import (
    GeometryPack,
    Scene,
    load_ibl_image,
    pack_geometry,
)

__all__ = [
    "CameraParams",
    "CameraSettings",
    "ConfigReader",
    "EnvParams",
    "EnvironmentSettings",
    "GeometryPack",
    "MaterialParams",
    "ObjMesh",
    "RenderSettings",
    "Scene",
    "load_ibl_image",
    "load_obj",
    "pack_geometry",
]
