"""The port's preview renderer, pick buffer and observability helpers against
the JAX package's.

The seven cases of tests/test_preview.py on the port, every scene on the
CPU: ids identical to the JAX preview's, colour allclose at 1e-5, wavefront
occupancy counts equal to JAX's or within the stated knife-edge budget.
"""

import dataclasses
import functools
import json
import logging
import os
import time

import jax
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.ops.preview import preview_render as j_preview
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.big_scenes import mesh_scene as j_mesh_scene
from pbrpathtracer_tpu.scene.big_scenes import \
    mesh_scene_camera as j_mesh_camera
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu.utils import observability as j_obs
from pbrpathtracer_tpu_torch import RenderConfig, bridge, pick, preview_render
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera, finalize_scene
from pbrpathtracer_tpu_torch.utils import observability as p_obs

from_reference = functools.partial(bridge.from_reference, device="cpu")

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
CAM = Camera.make(**POSE)
JCAM = JCamera.make(**POSE)


def _jax_preview(js, size, jcam=JCAM, intersector="auto", **kw):
    cfg = JConfig(width=size, height=size, intersector=intersector)
    return [np.asarray(x) for x in jax.jit(
        lambda: j_preview(js, jcam, size, size, cfg=cfg, **kw))()]


def _colour_flips(a, b):
    return int((~np.isclose(a, b, rtol=1e-5, atol=1e-5)).any(-1).sum())


def _knife_edge_budget(js, size, **kw):
    """Pixels whose colour hangs on a knife edge: those on which the JAX
    package's own two CPU intersectors ("classic" and "matmul") give
    different previews. The port and the JAX preview each flip their own, so
    the port is held to twice that count, as
    tests/test_torch_render.py::test_translucent sums two budgets."""
    a = _jax_preview(js, size, intersector="classic", **kw)
    b = _jax_preview(js, size, intersector="matmul", **kw)
    return 2 * _colour_flips(a[0], b[0])


def _assert_matches_jax(out, ref, colour_flips=0):
    """Ids identical to the JAX preview's, colour allclose at 1e-5 on all but
    ``colour_flips`` pixels."""
    color, oid, eid = (x.numpy() for x in out)
    assert oid.dtype == np.int32 and eid.dtype == np.int32
    np.testing.assert_array_equal(oid, ref[1])
    np.testing.assert_array_equal(eid, ref[2])
    n = _colour_flips(color, ref[0])
    assert n <= colour_flips, f"{n} pixels differ, budget {colour_flips}"


def test_preview_color_and_ids():
    scene = pb.cornell_box(device="cpu")
    out = preview_render(scene, CAM, 32, 32)
    color, oid, eid = (x.numpy() for x in out)
    assert color.shape == (32, 32, 3)
    assert np.isfinite(color).all() and color.max() > 0.05
    assert (oid == 0).all()                  # closed box: everything hits
    assert eid.min() >= 0 and eid.max() <= 5
    assert eid[16, 16] in range(6)
    _assert_matches_jax(out, _jax_preview(jb.cornell_box(), 32))


def test_pick_matches_id_buffer():
    scene = pb.cornell_box(device="cpu")
    _, oid, eid = preview_render(scene, CAM, 16, 16)
    o, e = pick(oid, eid, 8, 8)
    assert (o, e) == (int(oid[8, 8]), int(eid[8, 8]))
    assert isinstance(o, int) and isinstance(e, int)
    # an open scene: the background is -1 in both buffers
    js = j_mesh_scene(600)
    scene, cam = from_reference(js, j_mesh_camera())
    out = preview_render(scene, cam, 16, 16)
    miss = out[1].numpy() == -1
    assert miss.any() and (~miss).any()
    assert (out[2].numpy()[miss] == -1).all() and not out[0].numpy()[miss].any()
    y, x = np.argwhere(miss)[0]
    assert pick(out[1], out[2], int(x), int(y)) == (-1, -1)
    _assert_matches_jax(out, _jax_preview(js, 16, jcam=j_mesh_camera()))


def test_preview_highlight_tints():
    scene = pb.cornell_box(device="cpu")
    plain, oid, eid = preview_render(scene, CAM, 16, 16)
    target = (0, int(eid[8, 8]))
    tinted, _, _ = preview_render(scene, CAM, 16, 16, selected=target)
    assert not np.allclose(plain.numpy(), tinted.numpy())
    # only that element's pixels change
    changed = (plain != tinted).any(-1).numpy()
    assert (changed <= (eid.numpy() == target[1])).all() and changed.any()
    for kw in (dict(selected=target), dict(highlight=target),
               dict(highlight=(0, None), selected=target)):
        _assert_matches_jax(preview_render(scene, CAM, 16, 16, **kw),
                            _jax_preview(jb.cornell_box(), 16, **kw))


@pytest.mark.parametrize("name,flips", [("cornell_box", 0),
                                        ("translucent_scene", 2)])
def test_wavefront_occupancy_monotone(name, flips):
    """Live lanes per segment: equal to JAX's on Cornell; on the translucent
    scene within 2 lanes per segment (refraction chains turn a float
    difference into another branch, as tests/test_torch_render.py
    records)."""
    kw = dict(width=8, height=8, max_depth=2, spp=1, seed=1)
    scene = getattr(pb, name)(device="cpu")
    occ = p_obs.wavefront_occupancy(scene, CAM, RenderConfig(**kw))
    assert occ.dtype == np.int64 and occ.shape == (6,)
    assert occ[0] == 64
    assert (np.diff(occ) <= 0).all()      # lanes only die
    assert p_obs.rays_per_sample(occ) == 2 * occ.sum()
    ref = j_obs.wavefront_occupancy(getattr(jb, name)(), JCAM, JConfig(**kw))
    assert np.abs(occ - ref).max() <= flips, (occ, ref)
    assert p_obs.rays_per_sample(occ) == j_obs.rays_per_sample(occ)


@pytest.mark.parametrize("base,aspect", [((1024, 768), 1024 / 768),
                                         ((1024, 768), 2.0),
                                         ((640, 480), 0.5), ((3, 2), 40.0)])
def test_auto_resolution(base, aspect):
    w, h = p_obs.auto_resolution(*base, aspect)
    assert (w, h) == j_obs.auto_resolution(*base, aspect)
    if base == (1024, 768) and aspect == 1024 / 768:
        assert (w, h) == (1024, 768)
    if base[0] > 100:
        assert abs(w / h - aspect) < 0.05 * aspect
        assert abs(w * h - base[0] * base[1]) / (base[0] * base[1]) < 0.05


def test_status_text_ttl(caplog):
    st = p_obs.StatusText(ttl_s=0.05)
    with caplog.at_level(logging.INFO, logger="pbrpathtracer_tpu_torch"):
        st.set("hello")
    assert st.get() == "hello"
    time.sleep(0.08)
    assert st.get() == ""
    # the event went to the port's logger as one JSON line, from rank 0
    assert p_obs.is_host0()
    (record,) = [r for r in caplog.records
                 if r.name == "pbrpathtracer_tpu_torch"]
    event = json.loads(record.getMessage())
    assert event["event"] == "status" and event["text"] == "hello"


def test_preview_blended_transparency():
    """The back wall shows through the glass box; a highlighted translucent
    element draws opaque; every layer equals the JAX preview's."""
    scene = pb.translucent_scene(device="cpu")
    assert scene.has_translucent
    out, moved = p_obs.counted(lambda: preview_render(scene, CAM, 48, 48))
    # five layers, each one query of the dense route (its plain version
    # here, where the tensors lie on the CPU)
    assert moved["intersect_dense_plain"] == 5
    color, eid = out[0].numpy(), out[2].numpy()
    assert np.isfinite(color).all()
    glass = eid == 6        # the pick buffer reports the front-most surface
    assert glass.any(), "glass box not visible in the preview"

    opaque_mats = dataclasses.replace(
        scene.materials, mat_type=torch.zeros_like(scene.materials.mat_type))
    opaque_scene = finalize_scene(scene.geom, opaque_mats, scene.textures)
    color_op = preview_render(opaque_scene, CAM, 48, 48)[0].numpy()
    assert not np.allclose(color[glass], color_op[glass]), \
        "translucent element rendered identically to opaque"
    hl = preview_render(scene, CAM, 48, 48, highlight=(0, 6))
    assert not np.allclose(hl[0].numpy()[glass], color[glass])

    # Behind the glass the second layer is the box's bottom face or the
    # floor it stands on, at the same t: knife edges. Measured at 48x48:
    # JAX classic and matmul differ on 34 of the 2304 pixels, the port from
    # the JAX preview on 30.
    js = jb.translucent_scene()
    budget = _knife_edge_budget(js, 48)
    assert budget <= 0.04 * 48 * 48
    _assert_matches_jax(out, _jax_preview(js, 48), budget)
    _assert_matches_jax(hl, _jax_preview(js, 48, highlight=(0, 6)), budget)
    # without a second layer there is no such pixel
    _assert_matches_jax(
        preview_render(scene, CAM, 24, 24, transparency_layers=0),
        _jax_preview(js, 24, transparency_layers=0))
    _assert_matches_jax(
        preview_render(scene, CAM, 24, 24, transparency_layers=1),
        _jax_preview(js, 24, transparency_layers=1),
        _knife_edge_budget(js, 24, transparency_layers=1))


def test_preview_of_a_large_scene_takes_the_bvh_route():
    """Over 2048 triangles the preview's queries go through the BVH route
    (its plain version on the CPU), and match the JAX preview."""
    js = j_mesh_scene(3000)
    scene, cam = from_reference(js, j_mesh_camera())
    assert scene.num_triangles > 2048
    out, moved = p_obs.counted(lambda: preview_render(scene, cam, 16, 16))
    assert moved["intersect_list_plain"] == 1
    assert moved.get("intersect_dense_plain", 0) == 0
    _assert_matches_jax(out, _jax_preview(js, 16, jcam=j_mesh_camera()))


def test_preview_with_textures_matches_jax():
    """Diffuse and opacity textures in the preview shade and alpha. A
    nearest-texel fetch of a random texture is a knife edge wherever uv
    falls on a texel border: measured at 24x24, JAX classic and matmul
    differ on 2 pixels, the port from the JAX preview on 2."""
    from pbrpathtracer_tpu.scene.scene import finalize_scene as j_finalize
    from pbrpathtracer_tpu.scene.scene import pack_textures as j_pack
    from pbrpathtracer_tpu.utils.constants import TEX_DIFFUSE, TEX_OPACITY
    rs = np.random.RandomState(0)
    images = [rs.uniform(size=(8, 8, 4)).astype(np.float32),
              rs.uniform(size=(4, 6, 4)).astype(np.float32)]
    base = jb.cornell_box()
    tex_index = np.asarray(base.materials.tex_index).copy()
    tex_index[:, TEX_DIFFUSE] = 0
    tex_index[2:5, TEX_OPACITY] = 1
    js = j_finalize(base.geom, base.materials.replace(
        tex_index=jax.numpy.asarray(tex_index)), j_pack(images))
    scene, _ = from_reference(js)
    assert scene.has_opacity_tex and scene.has_any_texture
    budget = _knife_edge_budget(js, 24)
    assert budget <= 0.01 * 24 * 24
    _assert_matches_jax(preview_render(scene, CAM, 24, 24),
                        _jax_preview(js, 24), budget)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with p_obs.profile_trace(log_dir) as prof:
        torch.ones(64).sum()
    assert os.path.getsize(os.path.join(log_dir, "trace.json")) > 0
    assert len(prof.key_averages()) > 0
