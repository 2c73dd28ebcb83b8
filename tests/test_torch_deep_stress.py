"""The port on the JAX package's deep-stress and segment-cap scenes, on the
CPU: tests/test_deep_stress.py and tests/test_mirror_box.py.

* The curtained Cornell (two stacked opacity layers with opacity, normal,
  diffuse and roughness textures at once), built by the JAX test and carried
  over by ``bridge.from_reference``: the port's render against the JAX
  render (max |d| <= 1e-4 on every pixel; 2.3e-6 measured) and against the
  CPU oracle under the JAX test's own rule (a pixel is an outlier when a
  channel differs by > 1e-3; at most 2% outliers, mean difference < 1e-4 on
  the rest), at depth 5 and at the ``opacity_attempts=2`` force-accept
  boundary, where the cap must bind. ``chip_smoke.curtained_cornell``, the
  same scene built by the port for the card, equals it leaf for leaf.
* ``suggest_max_segments`` equal to the JAX one on the mirror box at three
  specular levels and three depths and on Cornell; the suggested cap bounds
  the truncation bias of the port's own render; ``with_auto_segments``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from chip_smoke import curtained_cornell as port_curtained_cornell
from pbrpathtracer_tpu.engine.config import (RenderConfig as JConfig,
                                             suggest_max_segments as j_suggest)
from pbrpathtracer_tpu.ops import integrator as jint
from pbrpathtracer_tpu.oracle.cpu_oracle import Oracle
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu_torch import RenderConfig, bridge, render
from pbrpathtracer_tpu_torch.engine.config import suggest_max_segments
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera
from test_deep_stress import CAM as JCAM, curtained_cornell

from_reference = functools.partial(bridge.from_reference, device="cpu")
POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def curtained():
    js = curtained_cornell()
    ps, pcam = from_reference(js, JCAM)
    return js, ps, pcam


def _leaves(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def test_port_builder_equals_the_jax_scene(curtained):
    _, ps, _ = curtained
    own = port_curtained_cornell(device="cpu")
    assert own.has_opacity_tex and own.has_any_texture
    assert (own.has_translucent, own.accel) == (ps.has_translucent, None)
    for part in ("geom", "materials", "textures"):
        a, b = _leaves(getattr(own, part)), _leaves(getattr(ps, part))
        for k in a:
            assert torch.equal(a[k], b[k]), f"{part}.{k}"
    assert torch.equal(own.lights, ps.lights)


@pytest.mark.parametrize("kw", [
    dict(width=10, height=10, max_depth=5, spp=2, seed=9),
    dict(width=10, height=10, max_depth=4, spp=2, seed=4, opacity_attempts=2),
], ids=["depth5", "force-accept"])
def test_curtained_parity(curtained, kw):
    js, ps, pcam = curtained
    img = render(ps, pcam, RenderConfig(**kw)).numpy()
    jimg = np.asarray(jax.jit(lambda: jint.render(js, JCAM, JConfig(**kw)))())
    assert np.abs(img - jimg).max() <= JAX_TOL
    d = np.abs(img - Oracle(js, JCAM, JConfig(**kw)).render()).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.02
    assert d[d <= 1e-3].mean() < 1e-4
    assert img.max() > 0.05          # light reaches the camera through layers


def test_opacity_cap_binds(curtained):
    """At opacity_attempts=2 the queries exhaust the re-trace budget and
    force-accept: a larger budget changes the image."""
    _, ps, pcam = curtained
    cfg = RenderConfig(width=10, height=10, max_depth=4, spp=2, seed=4,
                       opacity_attempts=2)
    img2 = render(ps, pcam, cfg).numpy()
    img4 = render(ps, pcam, cfg.replace(opacity_attempts=4)).numpy()
    assert not np.allclose(img2, img4)


@pytest.mark.parametrize("level,depth", [
    (level, depth) for level in (0.5, 0.9, 0.99) for depth in (4, 8, 16)]
    + [(None, 3)])
def test_suggest_max_segments_matches_jax(level, depth):
    if level is None:
        js, ps = jb.cornell_box(), pb.cornell_box(device="cpu")
    else:
        js = jb.mirror_box_scene(spec_level=level)
        ps = pb.mirror_box_scene(spec_level=level, device="cpu")
    assert suggest_max_segments(ps, depth) == j_suggest(js, depth)


def test_suggested_cap_bounds_truncation_bias():
    """The port's render at the suggested cap against an effectively
    unbounded one (64): the energy deficit is below the tolerance the cap
    was sized for, and the default 2·depth+2 cap loses more."""
    scene = pb.mirror_box_scene(spec_level=0.9, diffuse_level=0.9,
                                device="cpu")
    camera = Camera.make(**POSE)
    base = RenderConfig(width=16, height=16, max_depth=2, spp=4, seed=11)
    tol = 1e-3
    s_auto = suggest_max_segments(scene, base.max_depth, tol=tol)
    assert s_auto > base.resolved_max_segments()

    def mean(cfg):
        return float(render(scene, camera, cfg).mean())
    m_ref = mean(base.replace(max_segments=64))
    m_auto = mean(base.replace(max_segments=s_auto))
    m_def = mean(base)
    assert m_ref >= m_auto >= m_def - 1e-7
    assert m_ref - m_auto < tol
    assert m_ref - m_def > m_ref - m_auto


def test_with_auto_segments():
    js, ps = jb.mirror_box_scene(), pb.mirror_box_scene(device="cpu")
    cfg = RenderConfig(width=8, height=8, max_depth=2).with_auto_segments(ps)
    assert cfg.max_segments == suggest_max_segments(ps, 2) == \
        JConfig(width=8, height=8, max_depth=2).with_auto_segments(
            js).max_segments
