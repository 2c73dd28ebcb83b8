"""The ``hit_vjp`` modes "winner" and "autodiff" of the port, on the CPU.

* ``with_custom_vjp`` on numpy-seeded rays against the JAX package's
  ``with_custom_vjp(intersect_classic)`` through ``jax.vjp``: d_ro and d_rd
  at rtol 1e-5 (atol 1e-6), exactly zero on misses and dead lanes;
* ``grad_render(materials=True, camera_lens=True)`` on Cornell and on the
  translucent scene, both behind a lens, under the three modes: the loss is
  the same number, "winner" and "autodiff" give "recompute"'s gradients
  (rtol 1e-4, atol 1e-7), each Cornell gradient the JAX gradient of the same
  mode (JAX side with ``use_pallas=False``) at tests/test_torch_diff.py's
  tolerance (relative L2 error <= 1e-3 per key, exact zeros where JAX has
  them), and Cornell's ``cam.focal_dist`` central finite differences of the
  port at that file's FD tolerance. On the translucent scene the port and
  the JAX CPU render differ on a few knife-edge pixels
  (tests/test_torch_render.py), and a lens that moves sends rays across the
  glass box's edges, which the pathwise estimator leaves out and a finite
  difference counts ("recompute" is as far from FD there as the other two):
  its gradients are held mode against mode.
* every ``remat_segments`` value gives the same gradients under every mode;
* a scene with an opacity texture (the re-trace's ``torch.where`` chain
  carries the gradient of t, u, v);
* "autodiff" goes through ``intersect_classic`` and never a kernel's
  wrapper, and raises on a scene of more than 2048 triangles;
* a forward-only render is bit-equal in all three modes and runs the same
  queries.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.diff.loss import l2_image_loss as j_l2
from pbrpathtracer_tpu.diff.params import get_params as j_get_params
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.ops.intersect import intersect_classic as j_classic
from pbrpathtracer_tpu.ops.intersect_vjp import with_custom_vjp as j_with_vjp
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu_torch import (RenderConfig, get_params, grad_render,
                                     l2_image_loss, render)
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.diff.loss import finite_difference_grad
from pbrpathtracer_tpu_torch.ops.hit import default_intersector
from pbrpathtracer_tpu_torch.ops.intersect_vjp import with_custom_vjp
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)
from pbrpathtracer_tpu_torch.scene.scene import (Camera, finalize_scene,
                                                 pack_textures)
from pbrpathtracer_tpu_torch.utils import observability as obs
from pbrpathtracer_tpu_torch.utils.constants import TEX_OPACITY

from_reference = functools.partial(bridge.from_reference, device="cpu")

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
LENS = dict(focal_dist=2.2, aperture=0.04)
MODES = ("recompute", "winner", "autodiff")


# ---- the custom backward alone ----------------------------------------------

@pytest.mark.parametrize("name", ["cornell_box", "translucent_scene"])
def test_with_custom_vjp_matches_jax(name):
    js = getattr(jb, name)()
    ps, _ = from_reference(js)
    rs = np.random.RandomState(3)
    n = 3000
    ro = rs.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 3.9], (n, 3)).astype(
        np.float32)
    d = rs.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_lower = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0, 1, n),
                       0.0).astype(np.float32)
    alive = rs.uniform(size=n) < 0.8
    cots = rs.normal(size=(3, n)).astype(np.float32)

    jfn = j_with_vjp(lambda s, o, d_, tl, alive=None: j_classic(
        s.geom, o, d_, tl, alive=alive))

    def jquery(o, d_):
        return jfn(js, o, d_, jnp.asarray(t_lower), jnp.asarray(alive))
    jhit, jidx = (np.asarray(x) for x in jquery(jnp.asarray(ro),
                                                jnp.asarray(rd))[:2])
    jout, jvjp = jax.vjp(lambda o, d_: jquery(o, d_)[2:], jnp.asarray(ro),
                         jnp.asarray(rd))
    j_dro, j_drd = jvjp(tuple(jnp.asarray(c) for c in cots))

    tro = torch.tensor(ro, requires_grad=True)
    trd = torch.tensor(rd, requires_grad=True)
    fn = with_custom_vjp(default_intersector)
    (hit, idx, t, u, v), moved = obs.counted(lambda: fn(
        ps, tro, trd, torch.tensor(t_lower), alive=torch.tensor(alive)))
    assert moved == {"intersect_dense_plain": 1}
    assert not hit.requires_grad and not idx.requires_grad
    # Where two surfaces share a plane (the glass box stands on the floor)
    # an ulp decides the winner, and XLA's and torch's CPU kernels may differ
    # by one: lanes are compared where both picked the same triangle, and
    # that must be all but the oracle-parity budget of 0.5%.
    same = (hit.numpy() == jhit) & (idx.numpy() == jidx)
    assert same.mean() >= 0.995, f"{(~same).sum()} winners differ"
    for mine, ref in zip((t, u, v), jout):
        np.testing.assert_allclose(mine.detach().numpy()[same],
                                   np.asarray(ref)[same], rtol=1e-5,
                                   atol=1e-6)
    loss = sum((x * torch.tensor(c)).sum() for x, c in zip((t, u, v), cots))
    d_ro, d_rd = torch.autograd.grad(loss, [tro, trd])
    np.testing.assert_allclose(d_ro.numpy()[same], np.asarray(j_dro)[same],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_rd.numpy()[same], np.asarray(j_drd)[same],
                               rtol=1e-5, atol=1e-6)
    off = ~hit.numpy()
    assert off[~alive].all() and 0.02 < off.mean() < 0.9
    assert not d_ro.numpy()[off].any() and not d_rd.numpy()[off].any()
    assert np.abs(d_ro.numpy()[~off]).max() > 0


# ---- whole gradients ----------------------------------------------------------

def _setup(name, depth, size=16, spp=2, seed=3, **cfg_kw):
    scene = getattr(pb, name)(device="cpu")
    cam = Camera.make(**POSE, **LENS)
    cfg = RenderConfig(width=size, height=size, max_depth=depth, spp=spp,
                       seed=seed, **cfg_kw)
    target = render(scene, cam, cfg) * 0.8
    return scene, cam, cfg, target


@functools.lru_cache(maxsize=None)
def _port_grads(name, depth, mode):
    scene, cam, cfg, target = _setup(name, depth)
    return grad_render(scene, cam, cfg.replace(hit_vjp=mode), target,
                       materials=True, camera_lens=True)


def _assert_same_grads(grads, ref, rtol=1e-4, atol=1e-7):
    assert sorted(grads) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(grads[k].numpy(), ref[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


SCENES = [("cornell_box", 2), ("translucent_scene", 3)]


@pytest.mark.parametrize("mode", ["winner", "autodiff"])
@pytest.mark.parametrize("name,depth", SCENES)
def test_modes_give_the_recompute_gradients(name, depth, mode):
    ref_loss, ref = _port_grads(name, depth, "recompute")
    loss, grads = _port_grads(name, depth, mode)
    assert float(loss) == float(ref_loss)
    _assert_same_grads(grads, ref)
    assert abs(float(ref["cam.focal_dist"])) > 0
    assert abs(float(ref["cam.aperture"])) > 0


@pytest.mark.parametrize("mode", MODES)
def test_cornell_grads_match_jax_in_the_same_mode(mode):
    name, depth = SCENES[0]
    scene, cam, cfg, target = _setup(name, depth)
    js, jcam = jb.cornell_box(), JCamera.make(**POSE, **LENS)
    jcfg = JConfig(width=16, height=16, max_depth=depth, spp=2, seed=3,
                   hit_vjp=mode, use_pallas=False)
    jparams = j_get_params(js, jcam, materials=True, camera_lens=True)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_l2(p, js, jcam, jcfg, jnp.asarray(target.numpy()))))(
            jparams)
    loss, grads = _port_grads(name, depth, mode)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        ref = np.asarray(jgrads[k])
        if not ref.any():
            assert not g.numpy().any(), k
            continue
        err = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert err <= 1e-3, f"{k}: relative L2 error {err:.3g}"


@pytest.mark.parametrize("mode", MODES)
def test_focal_dist_grad_matches_fd(mode):
    name, depth = SCENES[0]
    scene, cam, cfg, target = _setup(name, depth)
    cfg = cfg.replace(hit_vjp=mode)
    params = get_params(scene, cam, materials=False, camera_lens=True)
    ad = float(_port_grads(name, depth, mode)[1]["cam.focal_dist"])
    fd = float(finite_difference_grad(
        lambda p: l2_image_loss(p, scene, cam, cfg, target), params,
        "cam.focal_dist", eps=2e-3))
    assert abs(ad - fd) <= 5e-3 * max(abs(ad), abs(fd)) + 1e-5, (
        f"cam.focal_dist under {mode}: AD={ad:.6g} FD={fd:.6g}")


@pytest.mark.parametrize("remat", ["off", "hits", "all"])
@pytest.mark.parametrize("mode", MODES)
def test_remat_modes_give_the_same_gradients(mode, remat):
    scene, cam, cfg, target = _setup("translucent_scene", 3, size=8, spp=1,
                                     seed=2)
    run = functools.partial(grad_render, scene, cam, target=target,
                            materials=True, camera_lens=True)
    ref_loss, ref = run(cfg=cfg.replace(hit_vjp="recompute",
                                        remat_segments="off"))
    loss, grads = run(cfg=cfg.replace(hit_vjp=mode, remat_segments=remat))
    assert float(loss) == float(ref_loss)
    _assert_same_grads(grads, ref)
    same_mode = run(cfg=cfg.replace(hit_vjp=mode, remat_segments="off"))[1]
    _assert_same_grads(grads, same_mode, rtol=0, atol=0)


def _opacity_cornell():
    """Cornell with a random opacity map on the tall box (material 4), as
    tests/test_torch_textures.py's "opacity" case."""
    base = pb.cornell_box(device="cpu")
    tex_index = base.materials.tex_index.clone()
    tex_index[4, TEX_OPACITY] = 0
    omap = np.zeros((4, 4, 4), np.float32)
    omap[..., 0] = np.random.RandomState(0).uniform(0.2, 0.9, (4, 4))
    scene = finalize_scene(
        base.geom, dataclasses.replace(base.materials, tex_index=tex_index),
        pack_textures([omap]))
    assert scene.has_opacity_tex
    return scene


@pytest.mark.parametrize("mode", ["winner", "autodiff"])
def test_opacity_retrace_carries_the_gradient(mode):
    scene = _opacity_cornell()
    cam = Camera.make(**POSE, **LENS)
    cfg = RenderConfig(width=16, height=16, max_depth=2, spp=2, seed=8)
    target = render(scene, cam, cfg) * 0.8
    run = functools.partial(grad_render, scene, cam, target=target,
                            materials=True, camera_lens=True)
    ref_loss, ref = run(cfg=cfg)
    loss, grads = run(cfg=cfg.replace(hit_vjp=mode))
    assert float(loss) == float(ref_loss)
    _assert_same_grads(grads, ref)
    assert abs(float(ref["cam.focal_dist"])) > 0
    # some lanes were re-traced past a rejected hit
    plain = render(dataclasses.replace(scene, has_opacity_tex=False), cam, cfg)
    assert not torch.equal(plain, render(scene, cam, cfg))


# ---- routes -----------------------------------------------------------------

def test_autodiff_differentiates_the_classic_intersector():
    """Under a graph "autodiff" takes ``autodiff_intersector`` (counted as
    ``autodiff_queries``) and no kernel's wrapper, not even the plain
    version's, whose count stays; shadow queries and rays without a graph
    take the default route as always, and no other mode takes it at all."""
    scene, cam, cfg, target = _setup("cornell_box", 2, size=8, spp=1)

    def queries(mode, call=grad_render):
        def run():
            if call is render:
                return render(scene, cam, cfg.replace(hit_vjp=mode))
            return grad_render(scene, cam, cfg.replace(hit_vjp=mode), target,
                               materials=False, camera_lens=True)
        _, moved = obs.counted(run)
        return (moved.get("autodiff_queries", 0),
                moved.get("intersect_dense_plain", 0))
    n_auto, n_default = queries("autodiff")
    assert n_auto > 0 and n_default > 0      # primary/bounce, then shadow
    for mode in ("winner", "recompute"):
        assert queries(mode) == (0, n_auto + n_default)
    # forward only: the default route
    assert queries("autodiff", render)[0] == 0


def test_autodiff_raises_on_a_bvh_route_scene():
    scene = mesh_scene(3000, device="cpu")
    assert scene.num_triangles > 2048
    cam = mesh_scene_camera()
    cfg = RenderConfig(width=4, height=4, max_depth=2, hit_vjp="autodiff")
    with pytest.raises(NotImplementedError, match="no reverse rule"):
        grad_render(scene, cam, cfg, torch.zeros((4, 4, 3)))
    # forward only, and the other modes, go on working there
    assert torch.isfinite(render(scene, cam, cfg)).all()
    loss, grads = grad_render(scene, cam, cfg.replace(hit_vjp="winner"),
                              torch.zeros((4, 4, 3)))
    ref_loss, ref = grad_render(scene, cam, cfg.replace(hit_vjp="recompute"),
                                torch.zeros((4, 4, 3)))
    assert float(loss) == float(ref_loss)
    _assert_same_grads(grads, ref)


@pytest.mark.parametrize("name", ["cornell_box", "translucent_scene"])
def test_forward_render_is_bit_equal_in_every_mode(name):
    scene = getattr(pb, name)(device="cpu")
    cam = Camera.make(**POSE, **LENS)
    cfg = RenderConfig(width=12, height=12, max_depth=3, spp=2, seed=5)
    imgs, launches = [], []
    for mode in MODES:
        img, moved = obs.counted(
            lambda: render(scene, cam, cfg.replace(hit_vjp=mode)))
        imgs.append(img)
        launches.append(moved["intersect_dense_plain"])
    assert torch.equal(imgs[0], imgs[1]) and torch.equal(imgs[0], imgs[2])
    assert launches[0] > 0 and launches == [launches[0]] * 3
