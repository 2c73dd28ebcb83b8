"""The large-scene path of the port against the JAX package, on the CPU, at
BASELINE config 3's scene: mesh_scene(50_000), textured, with its BVH.

* the port's ``mesh_scene(50_000)`` equals the JAX package's leaf for leaf,
  BVH included (the card runs the port's builder, without JAX);
* a 16x16, depth 3, 1 spp render through the port's large-scene route (K4's
  plain version) against the JAX CPU render (its BVH walk), by
  tests/test_torch_render.py's criterion: at most 0.5% of pixels differ by
  more than 1e-3 in a channel, mean difference < 1e-4 on the rest.
  Measured: 0 outliers, mean difference 3.2e-8;
* ``grad_render(textures=True)`` at 16x16 against the JAX texture gradient:
  relative L2 error <= 1e-3 (tests/test_torch_diff.py's bound) and the same
  loss to 1e-6. Measured: 1.8e-7, and the losses equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.api import grad_render as j_grad_render
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.ops import integrator as jint
from pbrpathtracer_tpu.scene import big_scenes as jbs
from pbrpathtracer_tpu_torch import RenderConfig, grad_render, render
from pbrpathtracer_tpu_torch.scene import big_scenes as pbs
from pbrpathtracer_tpu_torch.utils import observability as obs

CFG = dict(width=16, height=16, max_depth=3, spp=1, seed=0)


@pytest.fixture(scope="module")
def scenes():
    return jbs.mesh_scene(50_000), pbs.mesh_scene(50_000, device="cpu")


def test_mesh_scene_matches_jax_leaf_for_leaf(scenes):
    js, ps = scenes
    assert ps.num_triangles == js.num_triangles > 49_000
    for part in ("geom", "materials", "textures"):
        for f in dataclasses.fields(getattr(ps, part)):
            j = np.asarray(getattr(getattr(js, part), f.name))
            p = getattr(getattr(ps, part), f.name).numpy()
            assert p.dtype == j.dtype, (part, f.name)
            np.testing.assert_array_equal(p, j, err_msg=f"{part}.{f.name}")
    np.testing.assert_array_equal(ps.lights.numpy(), np.asarray(js.lights))
    assert (ps.has_opacity_tex, ps.has_any_texture, ps.has_translucent) == (
        js.has_opacity_tex, js.has_any_texture, js.has_translucent)
    assert ps.accel.leaf_size == js.accel.leaf_size
    for f in ("bounds_min", "bounds_max", "first", "count", "escape", "perm"):
        np.testing.assert_array_equal(getattr(ps.accel, f).numpy(),
                                      np.asarray(getattr(js.accel, f)),
                                      err_msg=f)
    cam, jcam = pbs.mesh_scene_camera(), jbs.mesh_scene_camera()
    for f in dataclasses.fields(cam):
        np.testing.assert_allclose(getattr(cam, f.name).numpy(),
                                   np.asarray(getattr(jcam, f.name)),
                                   rtol=0, atol=1e-7)


def test_render_matches_jax(scenes):
    js, ps = scenes
    ref = np.asarray(jax.jit(lambda: jint.render(
        js, jbs.mesh_scene_camera(), JConfig(**CFG)))())
    img, moved = obs.counted(lambda: render(
        ps, pbs.mesh_scene_camera(), RenderConfig(**CFG)).numpy())
    assert moved.get("intersect_dense_plain", 0) == 0
    assert moved["intersect_list_plain"] > 0
    assert np.isfinite(img).all() and img.max() > 0.05
    d = np.abs(img - ref).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.005
    assert d[d <= 1e-3].mean() < 1e-4


def test_texture_gradients_match_jax(scenes):
    js, ps = scenes
    jl, jg = j_grad_render(js, jbs.mesh_scene_camera(), JConfig(**CFG),
                           jnp.zeros((16, 16, 3), jnp.float32),
                           materials=False, textures=True)
    pl, pg = grad_render(ps, pbs.mesh_scene_camera(), RenderConfig(**CFG),
                         torch.zeros((16, 16, 3)), materials=False,
                         textures=True)
    ref, got = np.asarray(jg["tex.data"]), pg["tex.data"].numpy()
    assert np.abs(ref).max() > 0
    assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)
    assert abs(float(pl) - float(jl)) <= 1e-6 * abs(float(jl))
