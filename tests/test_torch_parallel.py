"""The port's sharded layer (``parallel/mesh.py``, ``parallel/render.py``)
against the JAX package's, in one process on the CPU.

The port's side runs on the one-process mesh (no group) and on an in-process
gloo group of world size 1 (a real group, so every collective is made);
the JAX side on the virtual 8-device CPU mesh of tests/conftest.py. Inputs
(target, pixel ids) are made once with numpy from a seed and handed to both.

* ``pad_to_devices``, ``local_shard`` and ``local_pixel_slice`` equal the
  JAX functions for world sizes 1, 2, 3, 8 and a pixel count that 3 and 8 do
  not divide;
* ``render_sharded`` equals the port's ``render`` bit for bit and the JAX
  ``render_sharded`` at atol 1e-5 (tests/test_parallel.py's tolerance), in
  scan and block order, from sample 0 and from sample 3;
* four shards through ``render_sample``, concatenated, equal the whole
  wavefront bit for bit: what makes every world size give the same image;
* one fused step under SGD with lr 1 (so that ``p0 - p1`` is the gradient
  wherever the clip did not act): loss at atol 1e-6 and every parameter's
  change at rtol 1e-4, atol 1e-7 against the JAX step with
  ``optax.sgd(1.0)`` on the 1- and 8-device meshes;
* the overlapped step (spp 3) against the port's fused step (loss rtol 1e-6,
  parameters atol 1e-6, as tests/test_parallel.py) and the JAX overlapped
  step;
* ``all_reduce_flat``'s counts (``all_reduces``, ``all_reduce_bytes``):
  1 per fused step, spp + 1 per overlapped step, 0 per forward render; its
  bytes for a textured step are 4 x (parameter elements + 1).
"""

import functools
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.diff.params import get_params as j_get_params
from pbrpathtracer_tpu.dist import multihost as jmh
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.parallel import mesh as jmesh
from pbrpathtracer_tpu.parallel import render as jrender
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu_torch import RenderConfig, get_params, render
from pbrpathtracer_tpu_torch.dist import multihost as mh
from pbrpathtracer_tpu_torch.ops.integrator import (render_accumulate,
                                                    render_sample)
from pbrpathtracer_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_flat, broadcast_params, local_shard, make_mesh,
    pad_to_devices)
from pbrpathtracer_tpu_torch.parallel.render import (
    make_train_step, make_train_step_overlapped, render_sharded)
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)
from pbrpathtracer_tpu_torch.scene.scene import Camera
from pbrpathtracer_tpu_torch.utils import observability as obs

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
JCAM = JCamera.make(**POSE)
CAM = Camera.make(**POSE)
CPU = torch.device("cpu")


@pytest.fixture
def gloo1(tmp_path):
    """An in-process gloo group of world size 1 on a file store; always
    destroyed."""
    rank, world = mh.initialize(init_method=f"file://{tmp_path}/store",
                                num_processes=1, process_id=0, device="cpu",
                                timeout_s=60)
    assert (rank, world) == (0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(params=["one_rank", "gloo1"])
def mesh(request):
    if request.param == "gloo1":
        request.getfixturevalue("gloo1")
    m = make_mesh(device="cpu")
    assert (m.group is None) == (request.param == "one_rank")
    assert (m.rank, m.world_size, m.device) == (0, 1, CPU)
    return m


def _jmesh(n):
    return jmesh.make_mesh(jax.devices("cpu")[:n])


def _fake_mesh(rank, world):
    """A rank's view of a mesh of ``world`` ranks, for the shard arithmetic
    (no group: it cannot communicate)."""
    return Mesh(None, rank, world, CPU)


# ---- shard arithmetic -------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_pad_shard_slice_match_jax(world, monkeypatch):
    cfg = RenderConfig(width=10, height=7)
    n_pix = cfg.num_pixels
    n_pad = pad_to_devices(n_pix, world)
    assert n_pad == jmesh.pad_to_devices(n_pix, world)
    x = np.random.RandomState(world).uniform(size=(n_pad, 3)).astype(
        np.float32)
    jm = _jmesh(world)
    shards = jax.device_put(jnp.asarray(x),
                            jmesh.ray_sharding(jm)).addressable_shards
    by_rank = {s.index[0].start or 0: np.asarray(s.data) for s in shards}
    jfake = types.SimpleNamespace(devices=np.empty(world))
    for rank, start in enumerate(sorted(by_rank)):
        m = _fake_mesh(rank, world)
        np.testing.assert_array_equal(local_shard(torch.tensor(x), m).numpy(),
                                      by_rank[start])
        # the JAX function, as process ``rank`` of ``world`` would see it
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        assert mh.local_pixel_slice(cfg, m) == jmh.local_pixel_slice(
            JConfig(width=10, height=7), jfake)
    with pytest.raises(ValueError):
        local_shard(torch.zeros(n_pad + 1), _fake_mesh(0, 2))


def test_a_mesh_without_a_group_cannot_communicate():
    with pytest.raises(ValueError):
        all_reduce_flat([torch.zeros(3)], _fake_mesh(0, 2))
    scene = pb.cornell_box(device="cpu")
    with pytest.raises(ValueError):      # 49 pixels over 2 ranks
        make_train_step(scene, CAM, RenderConfig(width=7, height=7),
                        torch.optim.SGD, _fake_mesh(0, 2))
    with pytest.raises(ValueError):
        make_train_step_overlapped(scene, CAM, RenderConfig(width=8, height=8),
                                   torch.optim.SGD, _fake_mesh(0, 1))


# ---- forward render ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_sharded(order, sample_start):
    cfg = JConfig(width=16, height=16, max_depth=2, spp=2, seed=4,
                  pixel_order=order)
    return np.asarray(jrender.render_sharded(
        jb.cornell_box(), JCAM, cfg, mesh=_jmesh(8),
        sample_start=sample_start))


@pytest.mark.parametrize("sample_start", [0, 3])
@pytest.mark.parametrize("order", ["scan", "block"])
def test_render_sharded_equals_render_and_jax(mesh, order, sample_start):
    scene = pb.cornell_box(device="cpu")
    cfg = RenderConfig(width=16, height=16, max_depth=2, spp=2, seed=4,
                       pixel_order=order)
    img, moved = obs.counted(lambda: render_sharded(
        scene, CAM, cfg, mesh=mesh, sample_start=sample_start))
    assert "all_reduces" not in moved
    assert not img.is_inference() and img.shape == (16, 16, 3)
    ref = render_accumulate(scene, CAM, cfg, torch.zeros((256, 3)),
                            sample_start, cfg.spp) / float(cfg.spp)
    assert torch.equal(img, ref.reshape(16, 16, 3))
    if sample_start == 0:
        assert torch.equal(img, render(scene, CAM, cfg))
    jimg = _jax_sharded(order, sample_start)
    assert np.allclose(img.numpy(), jimg, atol=1e-5), \
        np.abs(img.numpy() - jimg).max()


def test_shards_concatenate_to_the_whole_wavefront():
    scene = pb.translucent_scene(device="cpu")
    cfg = RenderConfig(width=16, height=16, max_depth=3, seed=9)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
    whole = render_sample(scene, CAM, cfg, 2, pixel_idx=pix)
    parts = [render_sample(scene, CAM, cfg, 2,
                           pixel_idx=local_shard(pix, _fake_mesh(r, 4)))
             for r in range(4)]
    assert torch.equal(torch.cat(parts), whole)


# ---- training steps ---------------------------------------------------------

def _inputs(cfg, seed=0):
    """Target and pixel ids, made once with numpy for both packages."""
    rs = np.random.RandomState(seed)
    return (np.arange(cfg.num_pixels, dtype=np.int32),
            rs.uniform(0.1, 0.6, (cfg.num_pixels, 3)).astype(np.float32))


def _jax_step(make, n_dev, cfg_kw, jopt, seed=0):
    js = jb.cornell_box()
    jcfg = JConfig(**cfg_kw)
    pix, target = _inputs(jcfg)
    jm = _jmesh(n_dev)
    params = j_get_params(js, JCAM, materials=True)
    step = make(js, JCAM, jcfg, jopt, jm)
    shard, rep = jmesh.ray_sharding(jm), jmesh.replicated(jm)
    p1, _, loss = step(jax.device_put(params, rep),
                       jax.device_put(jopt.init(params), rep), js, JCAM,
                       jax.device_put(jnp.asarray(pix), shard),
                       jax.device_put(jnp.asarray(target), shard),
                       jnp.uint32(seed))
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in p1.items()}, float(loss))


def _port_step(make, mesh, cfg_kw, opt, seed=0, scene=None, **which):
    scene = pb.cornell_box(device="cpu") if scene is None else scene
    cfg = RenderConfig(**cfg_kw)
    pix, target = _inputs(cfg)
    params = broadcast_params(get_params(scene, CAM, **which), mesh)
    p0 = {k: v.clone() for k, v in params.items()}
    step = make(scene, CAM, cfg, opt, mesh)
    loss = step(params, torch.tensor(pix), torch.tensor(target), seed)
    return p0, params, loss, step


STEP_CFG = dict(width=8, height=8, max_depth=2, spp=1, seed=4)


@functools.lru_cache(maxsize=None)
def _jax_fused(n_dev):
    return _jax_step(jrender.make_train_step, n_dev, STEP_CFG, optax.sgd(1.0))


@pytest.mark.parametrize("n_dev", [1, 8])
def test_fused_step_matches_jax(mesh, n_dev):
    jp0, jp1, jloss = _jax_fused(n_dev)
    p0, p1, loss, _ = _port_step(
        make_train_step, mesh, STEP_CFG,
        functools.partial(torch.optim.SGD, lr=1.0))
    assert abs(float(loss) - jloss) < 1e-6
    assert sorted(p1) == sorted(jp1)
    moved = 0.0
    for k in p1:
        np.testing.assert_array_equal(p0[k].numpy(), jp0[k])
        g = (p0[k] - p1[k].detach()).numpy()
        np.testing.assert_allclose(g, jp0[k] - jp1[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
        moved += float(np.abs(g).sum())
    assert moved > 0


def test_adam_steps_drive_emission_down_on_a_black_target(mesh):
    """tests/test_parallel.py::test_sharded_train_step_runs_and_reduces."""
    scene = pb.cornell_box(device="cpu")
    cfg = RenderConfig(width=16, height=16, max_depth=2, spp=1, seed=4)
    params = broadcast_params(get_params(scene, CAM), mesh)
    start = float(params["mat.emissive_intensity"].sum())
    assert params["mat.diffuse"] is not scene.materials.diffuse
    step = make_train_step(scene, CAM, cfg,
                           functools.partial(torch.optim.Adam, lr=1e-2), mesh)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
    target = torch.zeros((cfg.num_pixels, 3))
    losses = [float(step(params, pix, target, s)) for s in (0, 1)]
    assert all(np.isfinite(losses))
    assert float(params["mat.emissive_intensity"].detach().sum()) < start
    assert isinstance(step.optimizer, torch.optim.Adam)
    assert int(step.optimizer.state[params["mat.diffuse"]]["step"]) == 2
    # the scene the step was made with is not touched
    assert float(scene.materials.emissive_intensity.sum()) == start
    with pytest.raises(ValueError):     # another dict: not the optimizer's
        step({k: v.clone() for k, v in params.items()}, pix, target, 2)


OVER_CFG = dict(width=16, height=16, max_depth=2, spp=3, seed=4)


def test_overlapped_step_matches_fused_and_jax(mesh):
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    _, pf, loss_f, _ = _port_step(make_train_step, mesh, OVER_CFG, sgd)
    _, po, loss_o, _ = _port_step(make_train_step_overlapped, mesh, OVER_CFG,
                                  sgd)
    assert np.isclose(float(loss_f), float(loss_o), rtol=1e-6)
    for k in pf:
        torch.testing.assert_close(pf[k], po[k], rtol=0, atol=1e-6)
    if mesh.group is None:      # (the JAX step once: it compiles for a while)
        _, jp1, jloss = _jax_step(jrender.make_train_step_overlapped, 4,
                                  OVER_CFG, optax.sgd(1e-2))
        assert abs(float(loss_o) - jloss) < 1e-6
        for k in po:
            np.testing.assert_allclose(po[k].detach().numpy(), jp1[k],
                                       rtol=0, atol=1e-6, err_msg=k)


def test_all_reduce_counts_and_bytes(mesh):
    def counted(fn):
        out, moved = obs.counted(fn)
        return out, moved.get("all_reduces", 0), moved.get(
            "all_reduce_bytes", 0)
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    (_, p, _, _), calls, n_bytes = counted(lambda: _port_step(
        make_train_step, mesh, STEP_CFG, sgd))
    n_elems = sum(v.numel() for v in p.values())
    assert (calls, n_bytes) == (1, 4 * (n_elems + 1))
    _, calls, n_bytes = counted(lambda: _port_step(
        make_train_step_overlapped, mesh, OVER_CFG, sgd))
    assert (calls, n_bytes) == (OVER_CFG["spp"] + 1,
                                4 * (OVER_CFG["spp"] * n_elems + 1))
    # a textured step: the texture stack rides in the same one buffer
    scene = mesh_scene(1200, textured=True, tex_size=64, device="cpu")
    cfg = RenderConfig(width=8, height=8, max_depth=2, spp=1, seed=1)
    pix, target = _inputs(cfg)
    params = broadcast_params(
        get_params(scene, mesh_scene_camera(), textures=True), mesh)
    step = make_train_step(scene, mesh_scene_camera(), cfg, sgd, mesh)
    before = params["tex.data"].clone()
    _, calls, n_bytes = counted(lambda: step(
        params, torch.tensor(pix), torch.tensor(target), 0))
    n_elems = sum(v.numel() for v in params.values())
    assert n_elems > scene.textures.data.numel() > 64 * 64 * 4
    assert (calls, n_bytes) == (1, 4 * n_elems + 4)
    assert not torch.equal(params["tex.data"], before)


def test_broadcast_params_gives_fresh_equal_tensors(mesh):
    scene = pb.cornell_box(device="cpu")
    src = get_params(scene, CAM, camera_lens=True)
    out = broadcast_params(src, mesh)
    assert sorted(out) == sorted(src)
    for k in src:
        assert out[k] is not src[k] and torch.equal(out[k], src[k])
        assert out[k].dtype == torch.float32 and out[k].shape == src[k].shape


def test_host0_logging_on_a_real_group(gloo1, caplog):
    assert dist.is_initialized() and obs.is_host0()
    with caplog.at_level(logging.INFO, logger=obs.logger.name):
        obs.log_event("sharded", ranks=dist.get_world_size())
    assert any('"event": "sharded"' in r.getMessage()
               for r in caplog.records)
