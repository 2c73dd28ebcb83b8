"""The port's forward render path against the JAX package, on the CPU.

* one ``shade_segment`` from identical state and hit inputs: floats allclose
  at 1e-5, discrete fields identical on >= 99.5% of lanes;
* ``render`` against the JAX ``render`` and the CPU oracle on the cases and
  thresholds of tests/test_oracle_parity.py (a pixel is an outlier when a
  channel differs by > 1e-3; at most 0.5% outliers, 3% on the translucent
  scene; mean difference < 1e-4 on the rest): knife-edge float ties may flip
  a decision, and the JAX CPU render intersects through its matmul form;
* ``tonemap_u8``, progressive accumulation, and the rung1_cornell golden by
  ``benchmarks.goldens.compare``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from benchmarks import goldens as G
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.ops import integrator as jint
from pbrpathtracer_tpu.ops.hit import closest_hit as j_closest_hit
from pbrpathtracer_tpu.ops.intersect import intersect_classic as j_classic
from pbrpathtracer_tpu.ops.shade import (WavefrontState as JState,
                                         shade_segment as j_shade)
from pbrpathtracer_tpu.oracle.cpu_oracle import Oracle
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu_torch import RenderConfig, render, tonemap_u8
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.ops import integrator as pint
from pbrpathtracer_tpu_torch.ops.hit import closest_hit
from pbrpathtracer_tpu_torch.ops.shade import WavefrontState, shade_segment
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera

# The port's scenes live on the card by default; these tests run on the CPU.
from_reference = functools.partial(bridge.from_reference, device="cpu")

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
JCAM = JCamera.make(**POSE)


def _jax_render(js, jcam, **cfg):
    return np.asarray(jax.jit(lambda: jint.render(js, jcam,
                                                  JConfig(**cfg)))())


def _assert_close_images(img, ref, outlier_frac, tol, what):
    d = np.abs(img - ref).max(axis=-1)
    outliers = (d > tol).mean()
    assert outliers <= outlier_frac, \
        f"{what}: {outliers:.3%} pixels differ > {tol}"
    assert d[d <= tol].mean() < 1e-4, what


def _compare(js, jcam, outlier_frac=0.005, tol=1e-3, jax_outlier_frac=None,
             **cfg):
    """Port render against the JAX render and against the CPU oracle.

    The thresholds are those the JAX package meets against the oracle. The
    port and the JAX render each flip their own knife-edge pixels, so where
    the scene has many (refraction), the port-vs-JAX budget
    ``jax_outlier_frac`` is the sum of the two budgets against the oracle.
    """
    ps, pcam = from_reference(js, jcam)
    img = render(ps, pcam, RenderConfig(**cfg)).numpy()
    _assert_close_images(img, _jax_render(js, jcam, **cfg),
                         jax_outlier_frac or outlier_frac, tol, "vs JAX")
    _assert_close_images(img, Oracle(js, jcam, JConfig(**cfg)).render(),
                         outlier_frac, tol, "vs oracle")
    return img


# ---- one shading segment ---------------------------------------------------

def _random_state(rs, n, width):
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


@pytest.mark.parametrize("name", ["cornell_box", "cornell_spheres_scene",
                                  "translucent_scene"])
def test_shade_segment_matches_jax(name):
    js = getattr(jb, name)()
    ps, _ = from_reference(js)
    st = _random_state(np.random.RandomState(0), 2048, 64)
    jcfg, pcfg = JConfig(max_depth=3), RenderConfig(max_depth=3)
    seg, sample_idx, seed = 1, 3, 5
    hit = j_classic(js.geom, jnp.asarray(st["ro"]), jnp.asarray(st["rd"]),
                    alive=jnp.asarray(st["alive"]))
    hit_np = [np.asarray(x) for x in hit]

    def j_step():
        state = JState(**{k: jnp.asarray(v) for k, v in st.items()})

        def shadow(p, l, a=None):
            return j_closest_hit(
                js, jcfg, p, l, jnp.uint32(seed), state.pixel,
                jnp.uint32(sample_idx), jnp.uint32(2), slot_base=16,
                intersect_fn=lambda s, o, d, tl, alive=None: j_classic(
                    s.geom, o, d, tl, alive=alive), alive=a)
        return j_shade(js, jcfg, state, *(jnp.asarray(x) for x in hit_np),
                       jnp.uint32(seg), jnp.uint32(sample_idx),
                       jnp.uint32(seed), shadow)

    ref = jax.jit(j_step)()
    state = WavefrontState(**{k: torch.tensor(v) for k, v in st.items()})

    def shadow(p, l, a=None):
        return closest_hit(ps, pcfg, p, l, seed, state.pixel, sample_idx, 2,
                           slot_base=16, alive=a)
    out = shade_segment(ps, pcfg, state, *(torch.tensor(x) for x in hit_np),
                        seg, sample_idx, seed, shadow)

    same = np.ones(2048, bool)
    for f in ("alive", "inside", "itr", "depth"):
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        assert b.dtype == a.dtype, f
        same &= a == b
    assert same.mean() >= 0.995, f"discrete fields agree on {same.mean():.2%}"
    for f in ("ro", "rd", "throughput", "radiance"):
        np.testing.assert_allclose(getattr(out, f).numpy()[same],
                                   np.asarray(getattr(ref, f))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert out.alive.any() and (~out.alive).any()


# ---- whole renders (tests/test_oracle_parity.py cases) ---------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_cornell_depths(depth):
    _compare(jb.cornell_box(), JCAM, width=12, height=12, max_depth=depth,
             spp=2, seed=7)


@pytest.mark.parametrize("seed", [0, 123])
def test_cornell_seeds(seed):
    _compare(jb.cornell_box(), JCAM, width=8, height=8, max_depth=2, spp=2,
             seed=seed)


def test_dof_camera():
    cam = JCamera.make(**POSE, focal_dist=2.5, aperture=0.05)
    _compare(jb.cornell_box(), cam, width=8, height=8, max_depth=2, spp=2,
             seed=3)


def test_translucent():
    """Measured at this config: port vs oracle 3% outliers (3 of 100
    pixels), JAX vs oracle 2%, port vs JAX 5%."""
    _compare(jb.translucent_scene(), JCAM, outlier_frac=0.03,
             jax_outlier_frac=0.06, width=10, height=10, max_depth=3, spp=2,
             seed=11)


def test_spheres_from_port_builder():
    """The port's own builder and Camera.make, not the bridge."""
    cfg = dict(width=12, height=12, max_depth=3, spp=2, seed=1)
    img = render(pb.cornell_spheres_scene(device="cpu"), Camera.make(**POSE),
                 RenderConfig(**cfg)).numpy()
    ref = _jax_render(jb.cornell_spheres_scene(), JCAM, **cfg)
    d = np.abs(img - ref).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.005 and d[d <= 1e-3].mean() < 1e-4


# ---- accumulation, tonemap, golden -----------------------------------------

def test_tonemap_u8_matches_jax():
    rs = np.random.RandomState(0)
    accum = rs.uniform(-1.0, 9.0, (500, 3)).astype(np.float32)
    for samples in (1, 3, 8):
        ref = np.asarray(jint.tonemap_u8(jnp.asarray(accum), samples))
        out = tonemap_u8(torch.tensor(accum), samples)
        assert out.dtype == torch.uint8
        np.testing.assert_array_equal(out.numpy(), ref)


def test_progressive_accumulation_is_seed_exact():
    ps = pb.cornell_box(device="cpu")
    cam = Camera.make(**POSE)
    cfg = RenderConfig(width=8, height=8, max_depth=2, seed=4)
    zero = torch.zeros((64, 3))
    once = pint.render_accumulate(ps, cam, cfg, zero, 0, 3)
    split = pint.render_accumulate(
        ps, cam, cfg, pint.render_accumulate(ps, cam, cfg, zero, 0, 1), 1, 2)
    torch.testing.assert_close(split, once, rtol=0, atol=0)


def test_dead_segment_skip_changes_nothing():
    ps = pb.translucent_scene(device="cpu")
    cam = Camera.make(**POSE)
    cfg = RenderConfig(width=8, height=8, max_depth=2, spp=2, seed=9)
    a = render(ps, cam, cfg)
    b = render(ps, cam, cfg.replace(skip_dead_segments=False))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gradients_raise():
    """Gradients are ported for every ``hit_vjp`` mode (see
    tests/test_torch_diff.py and tests/test_torch_hit_vjp.py); a mode that
    does not exist raises."""
    for mode in ("recompute", "winner", "autodiff"):
        assert RenderConfig(width=4, height=4, hit_vjp=mode).hit_vjp == mode
    with pytest.raises(ValueError):
        RenderConfig(width=4, height=4, hit_vjp="none")
    with pytest.raises(ValueError):
        RenderConfig(remat_segments="some")


def test_rung1_cornell_golden():
    cfg = RenderConfig(width=128, height=128, max_depth=3, spp=16)
    ps, cam = pb.cornell_box(device="cpu"), Camera.make(**POSE)
    with torch.inference_mode():
        s = torch.zeros((cfg.num_pixels, 3))
        s2 = torch.zeros_like(s)
        for k in range(cfg.spp):
            img = pint.render_sample(ps, cam, cfg, k)
            s += img
            s2 += img * img
        mean = s / cfg.spp
        var = torch.clamp(s2 / cfg.spp - mean * mean, min=0.0)
    shape = (cfg.height, cfg.width, 3)
    rep = G.compare(mean.reshape(shape).numpy(), var.reshape(shape).numpy(),
                    np.load(os.path.join(G.GOLDEN_DIR, "rung1_cornell.npz")))
    assert rep["ok"], rep
