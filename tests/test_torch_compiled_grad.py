"""The captured fwd+bwd (``engine.compiled.GRADS``) on the CPU.

The CUDA graph itself needs the card (tests/test_torch_gpu.py and
``chip_smoke.py`` phase 33 hold it bit-equal to the eager fwd+bwd). Here:

* the schedule it captures, run eagerly: every sample runs a fixed number
  of segments and reads nothing back (``diff.loss.fwd_bwd`` with
  ``counts``). At the live counts and at two past them it equals the
  skipping loop bit for bit, in the loss and every gradient (a segment over
  lanes that are all dead is the identity); a count below the need sets
  that sample's tail flag. Cornell under each ``remat_segments`` and
  ``hit_vjp`` mode, and the translucent scene behind a lens, whose live
  counts differ across seeds;
* that schedule against JAX ``api._jit_grad`` on the CPU, on the same
  numpy-seeded target, at tests/test_torch_diff.py's tolerance (loss rtol
  1e-5; per gradient a relative L2 error of at most 1e-3, and exactly zero
  where JAX is exactly zero): materials, textures and lens;
* the eager program is ``l2_image_loss``'s backward bit for bit;
* the cache's rules: a CPU scene is refused, and so is any call while
  ``record_launches`` is open; the key follows the non-parameter leaves,
  the parameters' names, shapes and dtypes, the target's shape and the
  determinism mode, not the seed or the parameters' values; a collected
  scene node drops the key, a replaced parameter does not; the least
  recently used key goes first; on the CPU ``fit``, ``grad_render`` and the
  bench's fwd+bwd step never reach the cache.
"""

import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu import api as japi
from pbrpathtracer_tpu.diff.params import get_params as j_get_params
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu.scene.scene import Textures, finalize_scene
from pbrpathtracer_tpu.utils.constants import TEX_DIFFUSE, TEX_ROUGHNESS
from pbrpathtracer_tpu_torch import (RenderConfig, api, bench, bridge, fit,
                                     get_params, l2_image_loss)
from pbrpathtracer_tpu_torch.diff.loss import eager_loss_and_grad, fwd_bwd
from pbrpathtracer_tpu_torch.engine import compiled
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera
from pbrpathtracer_tpu_torch.utils.roofline import record_launches

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
LENS = dict(focal_dist=2.2, aperture=0.04)
W, H = 12, 10
from_reference = functools.partial(bridge.from_reference, device="cpu")


def _leaves(params):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def _target(seed=0, h=H, w=W):
    rs = np.random.RandomState(seed)
    return torch.tensor(rs.uniform(0.0, 0.5, (h, w, 3)).astype(np.float32))


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# ---- the captured schedule, run eagerly ------------------------------------

SCHEDULES = {
    "cornell": ("cornell_box", {}, dict(max_depth=3), False),
    "cornell hits": ("cornell_box", {}, dict(max_depth=3,
                                             remat_segments="hits"), False),
    "cornell all + winner": ("cornell_box", {},
                             dict(max_depth=3, remat_segments="all",
                                  hit_vjp="winner"), False),
    "cornell autodiff + sort": ("cornell_box", {},
                                dict(max_depth=2, hit_vjp="autodiff",
                                     compact_wavefront="sort"), False),
    # live counts differ across seeds and samples, below the cap
    "translucent lens": ("translucent_scene", LENS,
                         dict(max_depth=3, max_segments=16), True),
}


@pytest.mark.parametrize("extra", [0, 2])
@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("case", list(SCHEDULES))
def test_fixed_counts_equal_the_skipping_loop(case, seed, extra):
    name, lens, kw, cam_params = SCHEDULES[case]
    scene = getattr(pb, name)(device="cpu")
    cam = Camera.make(**POSE, **lens)
    cfg = RenderConfig(width=W, height=H, spp=2, seed=seed, **kw)
    params = get_params(scene, cam, camera_lens=cam_params)
    target = _target(seed)
    loss, grads, runs, _ = fwd_bwd(_leaves(params), scene, cam, cfg, target)
    n = cfg.resolved_max_segments()
    assert all(0 < r < n for r in runs), runs   # every sample's tail is dead
    counts = [r + extra for r in runs]
    assert max(counts) <= n
    f_loss, f_grads, f_runs, tails = fwd_bwd(_leaves(params), scene, cam,
                                             cfg, target, counts=counts)
    assert f_runs == counts
    assert [None if t is None else bool(t) for t in tails] == [
        None if c == n else False for c in counts]
    assert _same_bits(loss, f_loss)
    assert list(grads) == list(f_grads) == list(params)
    for k in grads:
        assert _same_bits(grads[k], f_grads[k]), k
        assert bool(torch.isfinite(f_grads[k]).all()), k


def test_translucent_live_counts_differ():
    """The translucent case above exercises per-sample counts: they differ
    across samples and seeds."""
    name, lens, kw, _ = SCHEDULES["translucent lens"]
    scene = getattr(pb, name)(device="cpu")
    cam = Camera.make(**POSE, **lens)
    seen = set()
    for seed in (0, 2):
        cfg = RenderConfig(width=W, height=H, spp=2, seed=seed, **kw)
        _, _, runs, _ = fwd_bwd(_leaves(get_params(scene, cam)), scene, cam,
                                cfg, _target(seed))
        seen.update(runs)
    assert len(seen) >= 3, seen


@pytest.mark.parametrize("case", ["cornell", "translucent lens"])
def test_a_count_below_the_need_sets_the_tail_flag(case):
    name, lens, kw, cam_params = SCHEDULES[case]
    scene = getattr(pb, name)(device="cpu")
    cam = Camera.make(**POSE, **lens)
    cfg = RenderConfig(width=W, height=H, spp=2, seed=0, **kw)
    params = get_params(scene, cam, camera_lens=cam_params)
    _, _, runs, _ = fwd_bwd(_leaves(params), scene, cam, cfg, _target())
    short = [runs[0] - 1, runs[1]]
    _, _, _, tails = fwd_bwd(_leaves(params), scene, cam, cfg, _target(),
                             counts=short)
    assert bool(tails[0]) and not bool(tails[1])


# ---- against the JAX package's compiled gradient ---------------------------

def _textured_cornell():
    """Cornell with a random diffuse texture on the back wall and a
    roughness texture on the floor."""
    scene = jb.cornell_box()
    rs = np.random.RandomState(0)
    data = rs.uniform(0.2, 0.9, (2, 8, 8, 4)).astype(np.float32)
    tex_index = np.asarray(scene.materials.tex_index).copy()
    tex_index[0, TEX_DIFFUSE] = 0
    tex_index[0, TEX_ROUGHNESS] = 1
    materials = scene.materials.replace(tex_index=jnp.asarray(tex_index))
    return finalize_scene(scene.geom, materials, Textures(
        data=jnp.asarray(data), size=jnp.asarray([[8, 8], [8, 8]],
                                                 dtype=jnp.int32)))


JAX_CASES = {
    "materials": (jb.cornell_box, {}, dict(materials=True)),
    "textures": (_textured_cornell, {}, dict(materials=False,
                                             textures=True)),
    "lens": (jb.cornell_box, LENS, dict(materials=False, camera_lens=True)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_captured_schedule_matches_jax_jit_grad(case):
    build, lens, select = JAX_CASES[case]
    js, jcam = build(), JCamera.make(**POSE, **lens)
    kw = dict(width=16, height=16, max_depth=2, spp=2, seed=3)
    target = np.random.RandomState(7).uniform(
        0.0, 0.5, (16, 16, 3)).astype(np.float32)
    jparams = j_get_params(js, jcam, **select)
    jloss, jgrads = japi._jit_grad(jparams, js, jcam, JConfig(**kw),
                                   jnp.asarray(target), None)
    ps, pcam = from_reference(js, jcam)
    cfg = RenderConfig(**kw)
    leaves = bridge.params_from_reference(jparams, device="cpu")
    _, _, runs, _ = fwd_bwd(_leaves(leaves), ps, pcam, cfg,
                            torch.tensor(target))
    loss, grads, _, _ = fwd_bwd(_leaves(leaves), ps, pcam, cfg,
                                torch.tensor(target), counts=runs)
    assert sorted(grads) == sorted(jgrads)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k, g in grads.items():
        ref = np.asarray(jgrads[k])
        if not ref.any():
            assert not g.numpy().any(), k
            continue
        err = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert err <= 1e-3, f"{k}: relative L2 error {err:.3g}"


def test_eager_program_is_the_l2_loss_backward():
    scene, cam = pb.cornell_box(device="cpu"), Camera.make(**POSE)
    cfg = RenderConfig(width=W, height=H, max_depth=2, spp=2, seed=5)
    params = get_params(scene, cam)
    loss, grads = eager_loss_and_grad(params, scene, cam, cfg, _target())
    leaves = _leaves(params)
    ref = l2_image_loss(leaves, scene, cam, cfg, _target())
    ref.backward()
    assert _same_bits(loss, ref.detach())
    for k, v in leaves.items():
        assert _same_bits(grads[k], v.grad), k
    assert all(not v.requires_grad for v in params.values())


# ---- the cache's rules -----------------------------------------------------

def _setup():
    scene, cam = pb.cornell_box(device="cpu"), Camera.make(**POSE)
    cfg = RenderConfig(width=8, height=8, max_depth=2, seed=1)
    return scene, cam, cfg, get_params(scene, cam), torch.zeros((8, 8, 3))


def test_a_cpu_scene_is_refused():
    scene, cam, cfg, params, target = _setup()
    with pytest.raises(ValueError):
        compiled.GRADS.loss_and_grad(params, scene, cam, cfg, target)
    assert len(compiled.GRADS) == 0


def test_record_launches_open_is_refused():
    scene, cam, cfg, params, target = _setup()
    with record_launches(), pytest.raises(RuntimeError):
        compiled.GRADS.loss_and_grad(params, scene, cam, cfg, target)
    with record_launches(), pytest.raises(RuntimeError):
        compiled.SAMPLES.sample(scene, cam, cfg, 0)


def _replaced(scene, cam, what):
    """(scene, camera, params selection) with one part replaced."""
    m, g = scene.materials, scene.geom
    return {
        "geometry leaf": (dataclasses.replace(scene, geom=dataclasses.replace(
            g, v0=g.v0 + 0.0)), cam, {}),
        "non-parameter material leaf": (dataclasses.replace(
            scene, materials=dataclasses.replace(
                m, tex_index=m.tex_index.clone())), cam, {}),
        "lights": (dataclasses.replace(scene, lights=scene.lights.clone()),
                   cam, {}),
        "camera leaf": (scene, dataclasses.replace(cam, pos=cam.pos.clone()),
                        {}),
        "parameter names": (scene, cam, dict(camera_lens=True)),
    }[what]


@pytest.mark.parametrize("what", ["geometry leaf",
                                  "non-parameter material leaf", "lights",
                                  "camera leaf", "parameter names"])
def test_grad_key_follows_the_leaves_and_parameter_names(what):
    scene, cam, cfg, params, target = _setup()
    key = compiled.grad_key(params, scene, cam, cfg, target)
    s, c, select = _replaced(scene, cam, what)
    assert compiled.grad_key(get_params(s, c, **select), s, c, cfg,
                             target) != key


def test_grad_key_ignores_seed_and_parameter_values():
    scene, cam, cfg, params, target = _setup()
    key = compiled.grad_key(params, scene, cam, cfg, target)
    assert hash(key) == hash(compiled.grad_key(params, scene, cam, cfg,
                                               target))
    assert compiled.grad_key(params, scene, cam, cfg.replace(seed=9),
                             target + 1.0) == key
    # new parameter values, in the dict or in the scene, are the same key
    moved = {k: v + 0.5 for k, v in params.items()}
    assert compiled.grad_key(moved, scene, cam, cfg, target) == key
    m = scene.materials
    other = dataclasses.replace(scene, materials=dataclasses.replace(
        m, diffuse=m.diffuse.clone() * 0.5))
    assert compiled.grad_key(get_params(other, cam), other, cam, cfg,
                             target) == key
    # the shapes and the schedule are not
    for kw in (dict(spp=2), dict(max_depth=3), dict(remat_segments="hits"),
               dict(hit_vjp="winner")):
        assert compiled.grad_key(params, scene, cam, cfg.replace(**kw),
                                 target) != key
    assert compiled.grad_key(params, scene, cam, cfg,
                             torch.zeros((8, 8, 4))) != key
    assert compiled.grad_key({**params, "mat.diffuse": params[
        "mat.diffuse"][:2]}, scene, cam, cfg, target) != key
    torch.use_deterministic_algorithms(True)
    try:
        assert compiled.grad_key(params, scene, cam, cfg, target) != key
    finally:
        torch.use_deterministic_algorithms(False)


def _noted(cache, params, scene, cam, cfg, target):
    """Note a key as a first call does (no graph: the CPU has none)."""
    key = compiled.grad_key(params, scene, cam, cfg, target)
    cache._note(key, params, scene, cam)
    return key


@pytest.mark.parametrize("drop", ["scene", "geometry", "non-parameter leaf",
                                  "camera tensor"])
def test_a_grad_key_goes_with_a_collected_node(drop):
    cache = compiled.GradCache()
    scene, cam, cfg, params, target = _setup()
    key = _noted(cache, params, scene, cam, cfg, target)
    del params
    assert key in cache._entries and len(cache) == 0
    if drop == "scene":
        gone = weakref.ref(scene.geom)
        del scene
    elif drop == "geometry":
        gone = weakref.ref(scene.geom)
        scene = dataclasses.replace(scene, geom=dataclasses.replace(
            scene.geom))
    elif drop == "non-parameter leaf":
        m = scene.materials
        gone = weakref.ref(m.mat_type)
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            m, mat_type=m.mat_type.clone()))
        del m
    else:
        gone = weakref.ref(cam.pos)
        cam = dataclasses.replace(cam, pos=cam.pos.clone())
    gc.collect()
    assert gone() is None
    assert key not in cache._entries and key not in cache._watches


def test_a_grad_key_outlives_a_replaced_parameter():
    """The graph reads its own copy of every parameter: a parameter that
    the caller replaces and drops takes no key with it, and the new scene
    finds the same key."""
    cache = compiled.GradCache()
    scene, cam, cfg, params, target = _setup()
    key = _noted(cache, params, scene, cam, cfg, target)
    del params
    m = scene.materials
    gone = weakref.ref(m.diffuse)
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        m, diffuse=m.diffuse.clone()))
    del m
    gc.collect()
    assert gone() is None
    assert key in cache._entries
    assert compiled.grad_key(get_params(scene, cam), scene, cam, cfg,
                             target) == key


def test_the_grad_cache_forgets_the_least_recently_used_key():
    cache = compiled.GradCache()
    scene, cam, _, params, _ = _setup()
    keys = [_noted(cache, params, scene, cam,
                   RenderConfig(width=8, height=8 + i),
                   torch.zeros((8 + i, 8, 3)))
            for i in range(compiled.CACHE_SIZE + 1)]
    assert list(cache._entries) == keys[1:]
    assert keys[0] not in cache._watches
    cache.clear()
    assert not cache._entries and not cache._watches


def test_cpu_gradient_entries_never_capture(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU gradient reached the compiled path")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(compiled.GradCache, "loss_and_grad", refuse)
    monkeypatch.setattr(compiled.SampleCache, "sample", refuse)
    scene, cam, cfg, params, target = _setup()
    loss, grads = api.grad_render(scene, cam, cfg, target)
    ref_loss, ref = eager_loss_and_grad(params, scene, cam, cfg, target)
    assert _same_bits(loss, ref_loss)
    assert all(_same_bits(grads[k], ref[k]) for k in ref)
    res = fit(scene, cam, cfg, target, steps=2, lr=1e-2)
    assert len(res.losses) == 2
    step = bench.fwdbwd_step(scene, cam, cfg, params, target)
    assert _same_bits(step(1)[0], eager_loss_and_grad(
        params, scene, cam, cfg, target, seed=1)[0])
    assert len(compiled.GRADS) == 0 and not compiled.GRADS._entries
