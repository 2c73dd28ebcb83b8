"""Wavefront compaction and pixel order in the port (ops/compaction.py,
ops/integrator.block_pixel_order), as tests/test_compaction.py pins them in
the JAX package:

* ``coherence_key`` and ``block_pixel_order`` equal the JAX package's,
  exactly;
* "sort", "gather" and "block" renders equal the "off"/"scan" render bit
  for bit (the eager port runs every lane's arithmetic alike wherever the
  lane sits; measured: identical on every case below);
* gradients with "sort" equal those with "off" at rtol 1e-6 (the backward
  sums texel and material cotangents in another lane order);
* "auto" resolves to "off" and "scan" on the CPU, as the JAX package's does
  off the TPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.ops import compaction as jc
from pbrpathtracer_tpu.ops import integrator as jint
from pbrpathtracer_tpu.ops.shade import WavefrontState as JState
from pbrpathtracer_tpu.scene.big_scenes import mesh_scene as j_mesh_scene
from pbrpathtracer_tpu_torch import (Camera, RenderConfig, builders,
                                     grad_render, render)
from pbrpathtracer_tpu_torch.bridge import from_reference
from pbrpathtracer_tpu_torch.ops import compaction as pc
from pbrpathtracer_tpu_torch.ops import integrator as pint
from pbrpathtracer_tpu_torch.ops.shade import WavefrontState
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)

CAM = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                  up=(0, 1, 0), fovy=61)
ORDERS = [("sort", "scan"), ("gather", "scan"), ("off", "block"),
          ("sort", "block"), ("gather", "block")]


def _random_state(rs, n):
    ro = rs.uniform([-9, -2, -2], [9, 5, 18], (n, 3))
    d = rs.normal(size=(n, 3))
    d[rs.uniform(size=n) < 0.05, 1] = 0.0   # on an octant boundary
    rd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(
        ro=ro.astype(np.float32), rd=rd.astype(np.float32),
        throughput=rs.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        radiance=rs.uniform(0.0, 0.5, (n, 3)).astype(np.float32),
        alive=rs.uniform(size=n) < 0.7, inside=rs.uniform(size=n) < 0.1,
        itr=rs.randint(0, 3, n).astype(np.int32),
        depth=rs.randint(0, 4, n).astype(np.int32),
        pixel=rs.permutation(n).astype(np.int32))


def test_coherence_key_matches_jax():
    js = j_mesh_scene(6000, textured=False, accel="none")
    ps, _ = from_reference(js)
    st = _random_state(np.random.RandomState(0), 4096)
    ref = jc.coherence_key(JState(**{k: jnp.asarray(v)
                                     for k, v in st.items()}), js)
    key = pc.coherence_key(WavefrontState(**{k: torch.tensor(v)
                                             for k, v in st.items()}), ps)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), np.asarray(ref))


@pytest.mark.parametrize("w,h", [(16, 16), (100, 37), (512, 512)])
def test_block_pixel_order_matches_jax(w, h):
    order = pint.block_pixel_order(w, h)
    np.testing.assert_array_equal(order, jint.block_pixel_order(w, h))
    assert sorted(order.tolist()) == list(range(w * h))


@pytest.mark.parametrize("mode", ["sort", "gather"])
def test_compaction_moves_every_column_and_scatter_undoes_it(mode):
    st = _random_state(np.random.RandomState(1), 1000)
    state = WavefrontState(**{k: torch.tensor(v) for k, v in st.items()})
    slot = torch.arange(1000, dtype=torch.int32)
    fn = pc.compact_sort if mode == "sort" else pc.compact_gather
    moved, mslot = fn(state, slot)
    n_live = int(state.alive.sum())
    assert bool(moved.alive[:n_live].all()) and not moved.alive[n_live:].any()
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(moved, f.name)
        assert a.dtype == b.dtype and torch.equal(b, a[mslot.long()])
        assert torch.equal(pc.scatter_to_slots(b, mslot), a)


def _renders_equal(scene, camera, **kw):
    ref = render(scene, camera, RenderConfig(**kw))
    for mode, order in ORDERS:
        img = render(scene, camera, RenderConfig(
            compact_wavefront=mode, pixel_order=order, **kw))
        assert torch.equal(img, ref), (mode, order)


def test_reordered_renders_are_bit_identical_cornell():
    _renders_equal(builders.cornell_box(), CAM, width=24, height=24,
                   max_depth=4, seed=7)


def test_reordered_renders_are_bit_identical_translucent_deep():
    _renders_equal(builders.translucent_scene(), CAM, width=16, height=16,
                   max_depth=6, seed=3)


def test_reordered_renders_are_bit_identical_large_scene():
    """Over bvh_threshold triangles: the coherence key, and K4's route."""
    scene = mesh_scene(6000)
    assert scene.num_triangles > RenderConfig().bvh_threshold
    _renders_equal(scene, mesh_scene_camera(), width=16, height=16,
                   max_depth=3, seed=1)


@pytest.mark.parametrize("remat", ["off", "hits", "all"])
@pytest.mark.parametrize("order", ["scan", "block"])
def test_sort_gradients_match_off(order, remat):
    """Under every remat_segments mode (the lane order is undone after the
    checkpointed segments)."""
    target = torch.zeros((16, 16, 3))
    kw = dict(width=16, height=16, max_depth=3, seed=2, remat_segments=remat)
    scene = builders.cornell_box()
    _, ref = grad_render(scene, CAM, RenderConfig(**kw), target)
    _, got = grad_render(scene, CAM, RenderConfig(
        compact_wavefront="sort", pixel_order=order, **kw), target)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=1e-9)


def test_sort_texture_gradients_match_off_large_scene():
    scene, cam = mesh_scene(6000), mesh_scene_camera()
    target = torch.zeros((12, 12, 3))
    kw = dict(width=12, height=12, max_depth=2, seed=4)
    _, ref = grad_render(scene, cam, RenderConfig(**kw), target,
                         materials=False, textures=True)
    _, got = grad_render(scene, cam, RenderConfig(compact_wavefront="sort",
                                                  **kw), target,
                         materials=False, textures=True)
    assert ref["tex.data"].abs().max() > 0
    torch.testing.assert_close(got["tex.data"], ref["tex.data"], rtol=1e-6,
                               atol=1e-9)


def test_auto_resolves_as_jax_off_the_tpu():
    for scene in (builders.cornell_box(), mesh_scene(6000)):
        cfg, jcfg = RenderConfig(), JConfig()
        assert cfg.compact_wavefront == jcfg.compact_wavefront == "auto"
        assert cfg.bvh_threshold == jcfg.bvh_threshold
        assert cfg.resolved_compact() == "off" == \
            jcfg.resolved_compact(64, scene)
        assert cfg.resolved_pixel_order() == "scan" == \
            jcfg.resolved_pixel_order(scene)
    assert RenderConfig(compact_wavefront="gather").resolved_compact() == \
        "gather"
    with pytest.raises(ValueError):
        RenderConfig(pixel_order="hilbert")
