"""Gradients of the port against the JAX package and against central finite
differences, on the CPU.

* one ``shade_segment`` with the recompute straight-through: gradients of a
  fixed random projection of (radiance, ro, rd, throughput) w.r.t. the input
  rays and the material leaves match ``jax.grad`` through the JAX
  ``shade_segment`` at rtol 1e-4, atol 1e-6;
* ``l2_image_loss`` gradients on the Cornell set-up of tests/test_diff.py
  (16x16, depth 2, spp 2, seed 3): relative L2 error <= 1e-3 per
  ``MATERIAL_FIELDS`` key, and exactly zero where JAX is exactly zero;
* the finite-difference cases of tests/test_diff.py, run on the port itself
  with the same probes and tolerances. The estimator's contract is the JAX
  package's: pathwise gradients with detached discrete decisions, so FD is
  probed only on parameters that feed no decision (the max diffuse channel
  drives Russian roulette; translucency feeds only a draw).
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
from pbrpathtracer_tpu.ops import integrator as jint
from pbrpathtracer_tpu.ops.hit import closest_hit as j_closest_hit
from pbrpathtracer_tpu.ops.intersect import intersect_classic as j_classic
from pbrpathtracer_tpu.ops.shade import (WavefrontState as JState,
                                         shade_segment as j_shade)
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu_torch import (RenderConfig, get_params, grad_render,
                                     l2_image_loss, render)
from pbrpathtracer_tpu_torch.bridge import params_from_reference
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.diff.loss import finite_difference_grad
from pbrpathtracer_tpu_torch.diff.params import MATERIAL_FIELDS
from pbrpathtracer_tpu_torch.ops import rng
from pbrpathtracer_tpu_torch.ops.camera import generate_rays
from pbrpathtracer_tpu_torch.ops.hit import closest_hit
from pbrpathtracer_tpu_torch.ops.shade import WavefrontState, shade_segment
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera
from pbrpathtracer_tpu_torch.utils.constants import TRANSLUCENT

# The port's scenes live on the card by default; these tests run on the CPU.
from_reference = functools.partial(bridge.from_reference, device="cpu")

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
JCAM = JCamera.make(**POSE)
CAM = Camera.make(**POSE)


# ---- one shading segment ---------------------------------------------------

def _random_state(rs, n, width):
    """The random state of tests/test_torch_render.py."""
    ro = rs.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 3.9], (n, 3))
    d = rs.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(
        ro=ro.astype(np.float32), rd=rd.astype(np.float32),
        throughput=rs.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        radiance=rs.uniform(0.0, 0.5, (n, 3)).astype(np.float32),
        alive=rs.uniform(size=n) < 0.85, inside=rs.uniform(size=n) < 0.1,
        itr=rs.randint(0, 3, n).astype(np.int32),
        depth=rs.randint(0, 4, n).astype(np.int32),
        pixel=rs.randint(0, width * width, n).astype(np.int32))


OUT_FIELDS = ("radiance", "ro", "rd", "throughput")


@pytest.mark.parametrize("name", ["cornell_box", "translucent_scene"])
def test_segment_grads_match_jax(name):
    js = getattr(jb, name)()
    ps, _ = from_reference(js)
    rs = np.random.RandomState(0)
    st = _random_state(rs, 2048, 64)
    proj = {f: rs.normal(size=(2048, 3)).astype(np.float32)
            for f in OUT_FIELDS}
    jcfg, pcfg = JConfig(max_depth=3), RenderConfig(max_depth=3)
    seg, sample_idx, seed = 1, 3, 5
    hit_np = [np.asarray(x) for x in j_classic(
        js.geom, jnp.asarray(st["ro"]), jnp.asarray(st["rd"]),
        alive=jnp.asarray(st["alive"]))]
    jmats = j_get_params(js, JCAM, materials=True)

    def j_loss(ro, rd, mats):
        sg = jax.lax.stop_gradient
        scene = js.replace(materials=js.materials.replace(
            **{k.split(".", 1)[1]: v for k, v in mats.items()}))
        state = JState(**{**{k: jnp.asarray(v) for k, v in st.items()},
                          "ro": ro, "rd": rd})

        def shadow(p, l, a=None):
            return j_closest_hit(
                scene, jcfg, p, l, jnp.uint32(seed), state.pixel,
                jnp.uint32(sample_idx), jnp.uint32(2), slot_base=16,
                intersect_fn=lambda s, o, d, tl, alive=None: jax.tree.map(
                    sg, j_classic(s.geom, sg(o), sg(d), tl, alive=alive)),
                alive=a)
        out = j_shade(scene, jcfg, state, *(jnp.asarray(x) for x in hit_np),
                      jnp.uint32(seg), jnp.uint32(sample_idx),
                      jnp.uint32(seed), shadow)
        return sum(jnp.sum(getattr(out, f) * proj[f]) for f in OUT_FIELDS)

    ref = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        jnp.asarray(st["ro"]), jnp.asarray(st["rd"]), jmats)

    ro = torch.tensor(st["ro"], requires_grad=True)
    rd = torch.tensor(st["rd"], requires_grad=True)
    mats = {k: v.requires_grad_(True)
            for k, v in params_from_reference(jmats, device="cpu").items()}
    scene = dataclasses.replace(ps, materials=dataclasses.replace(
        ps.materials, **{k.split(".", 1)[1]: v for k, v in mats.items()}))
    state = WavefrontState(**{**{k: torch.tensor(v) for k, v in st.items()},
                              "ro": ro, "rd": rd})

    def shadow(p, l, a=None):
        return closest_hit(scene, pcfg, p, l, seed, state.pixel, sample_idx,
                           2, slot_base=16, alive=a)
    out = shade_segment(scene, pcfg, state,
                        *(torch.tensor(x) for x in hit_np), seg, sample_idx,
                        seed, shadow)
    loss = sum((getattr(out, f) * torch.tensor(proj[f])).sum()
               for f in OUT_FIELDS)
    grads = torch.autograd.grad(loss, [ro, rd, *mats.values()])

    for name_, g, r in zip(["ro", "rd", *mats], grads,
                           [ref[0], ref[1], *(ref[2][k] for k in mats)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-6, err_msg=name_)
    assert np.abs(np.asarray(ref[0])).max() > 0   # the graft carries ro


# ---- whole renders against JAX ---------------------------------------------

def _jax_setup(w=16, h=16, depth=2, spp=2, seed=3):
    """tests/test_diff.py's _setup: the target is the JAX render x 0.8."""
    js = jb.cornell_box()
    cfg = dict(width=w, height=h, max_depth=depth, spp=spp, seed=seed)
    target = np.asarray(jax.jit(
        lambda: jint.render(js, JCAM, JConfig(**cfg)))()) * 0.8
    return js, cfg, target


def test_render_grads_match_jax():
    js, cfg, target = _jax_setup()
    jparams = j_get_params(js, JCAM, materials=True)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_l2(p, js, JCAM, JConfig(**cfg), jnp.asarray(target))))(
            jparams)
    ps, pcam = from_reference(js, JCAM)
    loss, grads = grad_render(ps, pcam, RenderConfig(**cfg),
                              torch.tensor(target))
    assert sorted(grads) == sorted(f"mat.{f}" for f in MATERIAL_FIELDS)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k, g in grads.items():
        ref = np.asarray(jgrads[k])
        if not ref.any():
            assert not g.numpy().any(), k
            continue
        err = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert err <= 1e-3, f"{k}: relative L2 error {err:.3g}"


@pytest.mark.parametrize("remat", ["hits", "all", "off"])
def test_remat_modes_give_the_same_gradients(remat):
    ps, cam = pb.cornell_box(device="cpu"), CAM
    cfg = RenderConfig(width=8, height=8, max_depth=2, spp=1, seed=2)
    target = torch.zeros((8, 8, 3))
    loss, grads = grad_render(ps, cam, cfg.replace(remat_segments=remat),
                              target)
    ref_loss, ref = grad_render(ps, cam, cfg.replace(remat_segments="off"),
                                target)
    assert float(loss) == float(ref_loss)
    for k in ref:
        torch.testing.assert_close(grads[k], ref[k], rtol=0, atol=0)


def test_forward_only_render_records_no_graph():
    """No leaf requires grad: the render is a plain tensor without a graph,
    usable as a loss target; with a leaf that requires grad, it has one."""
    ps = pb.cornell_box(device="cpu")
    cfg = RenderConfig(width=6, height=6, max_depth=2, seed=1)
    img = render(ps, CAM, cfg)
    assert not img.is_inference() and img.grad_fn is None
    params = {k: v.clone().requires_grad_(True)
              for k, v in get_params(ps, CAM).items()}
    loss = l2_image_loss(params, ps, CAM, cfg, img * 0.5)
    loss.backward()
    assert params["mat.diffuse"].grad.abs().sum() > 0


# ---- finite differences on the port (tests/test_diff.py cases) -------------

def _port_setup(scene, w=16, h=16, depth=2, spp=2, seed=3):
    cfg = RenderConfig(width=w, height=h, max_depth=depth, spp=spp, seed=seed)
    target = render(scene, CAM, cfg) * 0.8
    params = get_params(scene, CAM, materials=True)

    def lossf(p):
        return l2_image_loss(p, scene, CAM, cfg, target)
    return params, lossf, grad_render(scene, CAM, cfg, target)[1]


def _check_fd(lossf, grads, params, key, indices, eps=2e-3, rtol=5e-3,
              atol=1e-5):
    ad = grads[key].numpy().reshape(-1)
    fd = finite_difference_grad(lossf, params, key, eps=eps,
                                indices=indices).reshape(-1)
    for i in indices:
        err = abs(ad[i] - fd[i])
        assert err <= rtol * max(abs(fd[i]), abs(ad[i])) + atol, (
            f"{key}[{i}]: AD={ad[i]:.6g} FD={fd[i]:.6g}")


def test_grads_finite_everywhere():
    _, _, grads = _port_setup(pb.cornell_box(device="cpu"))
    for k, v in grads.items():
        assert torch.isfinite(v).all(), f"non-finite grad in {k}"


def test_diffuse_grad_matches_fd_nonmax_channels():
    # material 1 = red wall diffuse (0.75, 0.25, 0.25): channels g, b are
    # non-max, so no Russian-roulette coupling. Flat indices 4, 5.
    params, lossf, grads = _port_setup(pb.cornell_box(device="cpu"))
    _check_fd(lossf, grads, params, "mat.diffuse", [4, 5])


def test_emissive_and_intensity_grads_match_fd():
    # the light is material 3: emissive flat indices 9, 10, 11
    params, lossf, grads = _port_setup(pb.cornell_box(device="cpu"))
    _check_fd(lossf, grads, params, "mat.emissive", [9, 10, 11], eps=5e-3)
    _check_fd(lossf, grads, params, "mat.emissive_intensity", [3], eps=5e-3)


def _glass(scene):
    return int(np.nonzero(scene.materials.mat_type.numpy()
                          == TRANSLUCENT)[0][0])


def test_translucent_specular_grad_matches_fd():
    """The glass specular colour scales the reflect-branch throughput and
    feeds no decision."""
    scene = pb.translucent_scene(device="cpu")
    params, lossf, grads = _port_setup(scene, depth=3)
    glass = _glass(scene)
    _check_fd(lossf, grads, params, "mat.specular",
              [glass * 3 + c for c in range(3)], eps=2e-3, rtol=2e-2)


def test_translucency_grad_is_zero():
    """Translucency feeds only the refract-vs-diffuse draw: its pathwise
    gradient is exactly zero by the detached-decision contract."""
    scene = pb.translucent_scene(device="cpu")
    _, _, grads = _port_setup(scene, w=8, h=8, depth=3)
    assert not grads["mat.translucency"].any()


def test_specular_grad_zero_without_specular_paths():
    # all-diffuse Cornell (reflectiveness 0): the specular gradient is 0
    _, _, grads = _port_setup(pb.cornell_box(device="cpu"))
    assert not grads["mat.specular"].any()


def test_camera_lens_grads_exist():
    ps = pb.cornell_box(device="cpu")
    cam = Camera.make(**POSE, focal_dist=2.0, aperture=0.03)
    cfg = RenderConfig(width=12, height=12, max_depth=2, spp=2, seed=5)
    _, g = grad_render(ps, cam, cfg, torch.zeros((12, 12, 3)),
                       materials=False, camera_lens=True)
    assert sorted(g) == ["cam.aperture", "cam.focal_dist"]
    assert torch.isfinite(g["cam.aperture"])
    assert torch.isfinite(g["cam.focal_dist"])
    assert abs(float(g["cam.focal_dist"])) > 0


def test_translucent_ior_grad_matches_fd_stable_lanes():
    """IOR drives the refraction direction and Snell's k continuously, and
    also feeds the Fresnel/TIR draws. The continuous chain is checked at
    segment level on lanes whose outgoing direction does not flip under
    +-2 eps and whose k is away from the TIR boundary, against a
    Richardson-extrapolated central FD (tests/test_diff.py's case)."""
    scene = pb.translucent_scene(device="cpu")
    cfg = RenderConfig(width=24, height=24, max_depth=3, spp=1, seed=3)
    N = cfg.width * cfg.height
    pix = torch.arange(N, dtype=torch.int32)
    ro, rd = generate_rays(CAM, cfg.width, cfg.height, cfg.seed, 0, pix)
    state = WavefrontState.initial(ro, rd, pix)
    hitres = closest_hit(scene, cfg, ro, rd, cfg.seed, pix, 0,
                         rng.bounce_stream(0))

    def stub_shadow(p, l, sh_alive=None):
        z = torch.zeros(N)
        return (torch.zeros(N, dtype=torch.bool),
                torch.zeros(N, dtype=torch.int32), z, z, z)

    probe = torch.tensor(
        np.random.RandomState(11).normal(size=(N, 3)).astype(np.float32))
    glass = _glass(scene)

    def out_rd(ior_val):
        ior = scene.materials.ior.clone()
        ior = torch.cat([ior[:glass], ior_val.reshape(1), ior[glass + 1:]])
        sc = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, ior=ior))
        return shade_segment(sc, cfg, state, *hitres, 0, 0, cfg.seed,
                             stub_shadow).rd

    eps = 0.015
    base = float(scene.materials.ior[glass])
    with torch.no_grad():
        rd_lo = out_rd(torch.tensor(base - 2 * eps)).numpy()
        rd_hi = out_rd(torch.tensor(base + 2 * eps)).numpy()
    stable = np.linalg.norm(rd_hi - rd_lo, axis=-1) < 0.3
    hit, idx = hitres[0].numpy(), hitres[1].numpy()
    n0 = scene.geom.normal.numpy()[idx]
    rdn = rd.numpy()
    n_ff = np.where((n0 * rdn).sum(-1, keepdims=True) > 0, -n0, n0)
    cth = np.abs((rdn * n_ff).sum(-1))
    eta = 1.0 / base   # first segment: every lane starts outside
    k = 1.0 - eta * eta * (1.0 - cth * cth)
    glass_hit = hit & (scene.geom.mat_id.numpy()[idx] == glass)
    stable &= ~glass_hit | (np.abs(k) > 0.05)
    assert stable.mean() > 0.85
    assert (glass_hit & stable).sum() > 30
    mask = torch.tensor(stable.astype(np.float32))

    ior = torch.tensor(base, requires_grad=True)
    (out_rd(ior) * probe * mask[:, None]).sum().backward()
    ad = float(ior.grad)

    def fd_at(e):
        with torch.no_grad():
            d = (out_rd(torch.tensor(base + e)).numpy().astype(np.float64)
                 - out_rd(torch.tensor(base - e)).numpy().astype(np.float64))
        return float((d * probe.numpy().astype(np.float64)
                      * mask.numpy().astype(np.float64)[:, None]).sum()
                     / (2 * e))

    fd = (4.0 * fd_at(eps) - fd_at(2 * eps)) / 3.0
    assert abs(ad) > 1e-4
    assert abs(ad - fd) <= 0.1 * max(abs(ad), abs(fd)) + 3e-4, (
        f"ior: AD={ad:.6g} FD={fd:.6g}")
