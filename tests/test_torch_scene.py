"""The PyTorch port's scene layer against the JAX package: the procedural
builders agree leaf for leaf (exact, dtype included), ``from_reference``
carries a JAX scene and camera over bit for bit, texture stacks pack alike,
the port's RenderConfig keeps
the JAX defaults that carry meaning, and importing the port loads no JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu.scene.scene import empty_textures as j_empty
from pbrpathtracer_tpu.scene.scene import pack_textures as j_pack
from pbrpathtracer_tpu_torch import RenderConfig
from pbrpathtracer_tpu_torch.bridge import from_reference
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import (Camera, empty_textures,
                                                 pack_textures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_leaves_equal(jobj, pobj):
    for f in dataclasses.fields(pobj):
        j = np.asarray(getattr(jobj, f.name))
        p = getattr(pobj, f.name).numpy()
        assert p.dtype == j.dtype, (f.name, p.dtype, j.dtype)
        np.testing.assert_array_equal(p, j, err_msg=f.name)


def _assert_scenes_equal(js, ps):
    _assert_leaves_equal(js.geom, ps.geom)
    _assert_leaves_equal(js.materials, ps.materials)
    _assert_leaves_equal(js.textures, ps.textures)
    np.testing.assert_array_equal(ps.lights.numpy(), np.asarray(js.lights))
    assert ps.lights.dtype == torch.int32
    assert (ps.has_opacity_tex, ps.has_any_texture, ps.has_translucent) == (
        js.has_opacity_tex, js.has_any_texture, js.has_translucent)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_spheres_scene",
                                  "translucent_scene", "mirror_box_scene"])
def test_builders_match_jax_leaf_for_leaf(name):
    _assert_scenes_equal(getattr(jb, name)(), getattr(pb, name)())


def test_from_reference_round_trip_is_exact():
    js = jb.cornell_spheres_scene()
    # give it a texture stack and texture indices, so every leaf is non-trivial
    rs = np.random.RandomState(0)
    data = rs.uniform(size=(2, 4, 3, 4)).astype(np.float32)
    tex_index = np.asarray(js.materials.tex_index).copy()
    tex_index[0, 0] = 1
    js = js.replace(
        textures=js.textures.replace(data=data,
                                     size=np.array([[3, 4], [2, 2]], np.int32)),
        materials=js.materials.replace(tex_index=tex_index))
    jcam = JCamera.make(pos=(0.1, 0.2, 0.3), dir=(0.02, -0.03, 1), fovy=61,
                        focal_dist=2.5, aperture=0.05)
    ps, pcam = from_reference(js, jcam)
    _assert_scenes_equal(js, ps)
    _assert_leaves_equal(jcam, pcam)
    assert from_reference(js)[1] is None


def test_camera_make_matches_jax():
    kw = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0.1),
              fovy=61, focal_dist=2.2, aperture=0.04)
    j, p = JCamera.make(**kw), Camera.make(**kw)
    for f in dataclasses.fields(p):
        np.testing.assert_allclose(getattr(p, f.name).numpy(),
                                   np.asarray(getattr(j, f.name)),
                                   rtol=0, atol=1e-7, err_msg=f.name)


def test_scene_to_moves_every_tensor_and_keeps_flags():
    ps = pb.translucent_scene()
    moved = ps.to("cpu")
    assert moved.device == torch.device("cpu")
    assert moved.has_translucent and not moved.has_any_texture
    _assert_scenes_equal(jb.translucent_scene(), moved)


@pytest.mark.parametrize("depth,max_segments", [(1, None), (4, None), (3, 17)])
def test_config_segments_match_jax(depth, max_segments):
    kw = dict(max_depth=depth, max_segments=max_segments)
    assert (RenderConfig(**kw).resolved_max_segments()
            == JConfig(**kw).resolved_max_segments())


@pytest.mark.parametrize("kw", [dict(brdf="ggx"),
                                dict(hit_vjp="winner")])
def test_config_raises_for_unported_options(kw):
    with pytest.raises(NotImplementedError):
        RenderConfig(**kw)


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: none of them
    may load jax, jaxlib, flax or optax, at any depth."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pbrpathtracer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = {'jax', 'jaxlib', 'flax', 'optax'} & "
        "{m.split('.')[0] for m in sys.modules}\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_pack_textures_matches_jax():
    rs = np.random.RandomState(0)
    images = [rs.uniform(size=(h, w, 4)).astype(np.float32)
              for h, w in ((4, 3), (2, 5), (1, 1))]
    _assert_leaves_equal(j_pack(images), pack_textures(images))
    _assert_leaves_equal(j_empty(), pack_textures([]))
    _assert_leaves_equal(j_empty(), empty_textures())
