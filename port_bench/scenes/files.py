"""The files a user hands to ``Scene.load``: an ``.obj``, the ``.ini``
beside it and, where the configuration has one, a lat-long sky image.

The OBJ holds each triangle's three vertices (``repr`` of their float32
values, so they read back exactly) and its faces in runs of one ``usemtl``
per material id, in id order, so the loader gives the same ids
(``ensem3a_openclraytracer_tpu_torch/testing.py`` :149-189 writes the
same layout).  The sky is made from the run's seed on the device, a smooth
random field over a horizon-to-zenith gradient, and written as a JPEG, as
the upstream project's 8k map is one.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

MATERIAL_FIELDS = ("Type", "Color_R", "Color_G", "Color_B", "roughness", "ior")


def generator(name: str):
    """The module ``port_bench/scenes/<name>.py``."""
    return importlib.import_module(f"port_bench.scenes.{name}")


def make_sky(seed: int, height: int, width: int, device) -> np.ndarray:
    """A ``[height, width, 3]`` uint8 sky from ``seed``: a gradient from a
    pale horizon to a blue zenith, a coarse random field over it upsampled
    bilinearly, made on ``device`` in a few calls."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    coarse = torch.rand((1, 3, 9, 17), generator=gen, device=device) * 0.5 - 0.25
    field = torch.nn.functional.interpolate(coarse, size=(height, width), mode="bilinear",
                                            align_corners=True)[0]
    v = torch.linspace(0.0, 1.0, height, device=device)[None, :, None]
    horizon = torch.tensor([0.8, 0.85, 0.95], device=device)[:, None, None]
    zenith = torch.tensor([0.2, 0.35, 0.7], device=device)[:, None, None]
    img = torch.clamp(horizon * (1.0 - v) + zenith * v + field, 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8).permute(1, 2, 0).contiguous().cpu().numpy()


def write_scene(config: dict, seed: int, directory: str, device) -> str:
    """Write the configuration's scene into ``directory``; returns the
    ``.obj`` path."""
    tris = generator(config["generator"]).triangles(config.get("params", {}), seed)
    obj = os.path.join(directory, f"{config['name']}.obj")
    lines = []
    for a, b, c, _ in tris:
        for v in (a, b, c):
            lines.append("v %r %r %r" % tuple(float(np.float32(x)) for x in v))
    mats = np.asarray([t[3] for t in tris])
    table = config["materials"]
    for m in range(len(table)):
        lines.append(f"usemtl m{m}")
        lines += [f"f {3 * t + 1} {3 * t + 2} {3 * t + 3}" for t in np.nonzero(mats == m)[0]]
    with open(obj, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    ini = {"sceneFile": obj, **config["ini"]}
    sky = config.get("sky")
    if sky:
        from PIL import Image

        path = os.path.join(directory, "sky.jpg")
        Image.fromarray(make_sky(seed, sky["height"], sky["width"], device)).save(
            path, quality=int(sky["quality"]))
        ini["IBLfile"] = path
    for m, row in enumerate(table):
        for field, val in zip(MATERIAL_FIELDS, row):
            ini[f"M_{m}_{field}"] = int(val) if field == "Type" else float(val)
    with open(obj[: -len(".obj")] + ".ini", "w", encoding="utf-8") as f:
        f.write("".join(f"{k}={v}\n" for k, v in ini.items()))
    return obj
