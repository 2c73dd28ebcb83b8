"""Differentiable parameters, as ``pbrpathtracer_tpu.diff.params``: a
(Scene, Camera) pair turned into a flat dict of tensors and back.

Discrete decisions inside the renderer (lobe choice, Russian roulette,
light pick, opacity tests, Fresnel accept) are comparisons and carry no
gradient; the continuous shading chain carries pathwise gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.scene import Camera, Scene

# Material fields that take part in optimization.
MATERIAL_FIELDS = (
    "diffuse", "specular", "emissive", "emissive_intensity",
    "roughness", "reflectiveness", "translucency", "ior",
)
CAMERA_FIELDS = ("aperture", "focal_dist")


def get_params(scene: Scene, camera: Camera, materials: bool = True,
               textures: bool = False, camera_lens: bool = False) -> dict:
    """The selected leaves as a flat dict {"mat.diffuse": tensor, ...}."""
    params = {}
    if materials:
        for f in MATERIAL_FIELDS:
            params[f"mat.{f}"] = getattr(scene.materials, f)
    if textures:
        params["tex.data"] = scene.textures.data
    if camera_lens:
        for f in CAMERA_FIELDS:
            params[f"cam.{f}"] = getattr(camera, f)
    return params


def set_params(scene: Scene, camera: Camera, params: dict):
    """(scene, camera) with the tensors of ``params`` put in place."""
    mat = {k.split(".", 1)[1]: v for k, v in params.items()
           if k.startswith("mat.")}
    if mat:
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **mat))
    if "tex.data" in params:
        scene = dataclasses.replace(scene, textures=dataclasses.replace(
            scene.textures, data=params["tex.data"]))
    cam = {k.split(".", 1)[1]: v for k, v in params.items()
           if k.startswith("cam.")}
    if cam:
        camera = dataclasses.replace(camera, **cam)
    return scene, camera


# (min, max) of each parameter's physical range; None = unbounded.
_RANGES = {
    "mat.diffuse": (0.0, 1.0), "mat.specular": (0.0, 1.0),
    "mat.emissive": (0.0, 1.0), "mat.roughness": (0.0, 1.0),
    "mat.reflectiveness": (0.0, 1.0), "mat.translucency": (0.0, 1.0),
    "mat.emissive_intensity": (0.0, None), "mat.ior": (1.0, 3.0),
    "tex.data": (0.0, 1.0), "cam.aperture": (0.0, None),
    "cam.focal_dist": (1e-3, None),
}


def clip_params(params: dict) -> dict:
    """Project parameters back into their physical ranges after an
    optimizer step (the GUI editor's slider ranges)."""
    return {k: torch.clamp(v, *_RANGES[k]) if k in _RANGES else v
            for k, v in params.items()}
