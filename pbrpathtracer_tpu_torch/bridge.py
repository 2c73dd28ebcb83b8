"""Carry a scene, camera or parameter dict of the JAX package over to the
port.

``from_reference`` reads every leaf through ``np.asarray``, so it works on
JAX arrays without importing JAX. The tests use it to feed both packages the
same scene, including scenes the port has no builder for (textured scenes,
loaded meshes). A JAX scene's BVH (``accel``) comes over leaf for leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .accel.build import FlatBVH
from .scene.scene import Camera, Geometry, Materials, Scene, Textures


def _leaves(cls, obj, static=()):
    return cls(**{f.name: getattr(obj, f.name) if f.name in static
                  else torch.from_numpy(np.array(getattr(obj, f.name)))
                  for f in dataclasses.fields(cls)})


def from_reference(scene, camera=None):
    """Convert a JAX-package ``Scene`` (and optionally its ``Camera``) to the
    port's, leaf for leaf and bit for bit. Returns ``(scene, camera)``; the
    camera is None when none was given."""
    accel = getattr(scene, "accel", None)
    port_scene = Scene(
        geom=_leaves(Geometry, scene.geom),
        materials=_leaves(Materials, scene.materials),
        textures=_leaves(Textures, scene.textures),
        lights=torch.from_numpy(np.array(scene.lights)),
        has_opacity_tex=bool(scene.has_opacity_tex),
        has_any_texture=bool(scene.has_any_texture),
        has_translucent=bool(scene.has_translucent),
        accel=None if accel is None else _leaves(FlatBVH, accel,
                                                 static=("leaf_size",)),
    )
    port_camera = None if camera is None else _leaves(Camera, camera)
    return port_scene, port_camera


def params_from_reference(params: dict) -> dict:
    """Convert a JAX-package params dict (``diff.params.get_params``) to the
    port's, key for key and bit for bit."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
