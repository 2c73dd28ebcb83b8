"""Textured scenes through the port's forward render path: the procedural
texture stacks of tests/test_textures.py (diffuse, emissive, roughness and
metallic overrides, normal mapping through the TBN, stochastic opacity
re-tracing), carried over to the port with ``from_reference`` and rendered
against the JAX render and the CPU oracle at that file's thresholds (a pixel
is an outlier when a channel differs by > 1e-3; at most 1% outliers, 2% with
an opacity texture; mean difference < 1e-4 on the rest)."""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.ops.hit import interpolate_uv as j_interp
from pbrpathtracer_tpu.ops.integrator import render as j_render
from pbrpathtracer_tpu.ops.texture import sample_texture as j_sample
from pbrpathtracer_tpu.oracle.cpu_oracle import Oracle
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import (Camera as JCamera, Textures,
                                           finalize_scene)
from pbrpathtracer_tpu.utils.constants import (TEX_DIFFUSE, TEX_EMISSIVE,
                                               TEX_METALLIC, TEX_NORMAL,
                                               TEX_OPACITY, TEX_ROUGHNESS)
from pbrpathtracer_tpu_torch import RenderConfig, render
from pbrpathtracer_tpu_torch import bridge
from pbrpathtracer_tpu_torch.ops.hit import interpolate_uv
from pbrpathtracer_tpu_torch.ops.texture import sample_texture, texel_coords
from pbrpathtracer_tpu_torch.scene.scene import Textures as PTextures
from pbrpathtracer_tpu_torch.utils import observability as obs

# The port's scenes live on the card by default; these tests run on the CPU.
from_reference = functools.partial(bridge.from_reference, device="cpu")

JCAM = JCamera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                    up=(0, 1, 0), fovy=61)


def _compare(js, outlier_frac, tol=1e-3, **cfg):
    ps, pcam = from_reference(js, JCAM)
    img = render(ps, pcam, RenderConfig(**cfg)).numpy()
    refs = {"JAX": np.asarray(jax.jit(
                lambda: j_render(js, JCAM, JConfig(**cfg)))()),
            "oracle": Oracle(js, JCAM, JConfig(**cfg)).render()}
    for what, ref in refs.items():
        d = np.abs(img - ref).max(axis=-1)
        outliers = (d > tol).mean()
        assert outliers <= outlier_frac, \
            f"vs {what}: {outliers:.3%} pixels differ > {tol}"
        assert d[d <= tol].mean() < 1e-4, what


def _textured_cornell(slot_assignments):
    """Cornell box with procedural textures on the given material rows
    (the builder of tests/test_textures.py)."""
    scene = jb.cornell_box()
    rs = np.random.RandomState(0)
    checker = np.zeros((8, 8, 4), np.float32)
    checker[..., 3] = 1.0
    for i in range(8):
        for j in range(8):
            c = 0.9 if (i + j) % 2 == 0 else 0.2
            checker[i, j, :3] = (c, c * 0.8, c * 0.5)
    noise = rs.uniform(0.3, 1.0, (4, 4, 4)).astype(np.float32)
    nmap = np.zeros((2, 2, 4), np.float32)
    nmap[..., :3] = (np.array([0.3, 0.2, 0.93]) + 1.0) / 2.0
    nmap[..., 3] = 1.0
    omap = np.zeros((4, 4, 4), np.float32)
    omap[..., 0] = rs.uniform(0.2, 0.9, (4, 4))
    images = [checker, noise, nmap, omap]
    data = np.zeros((4, 8, 8, 4), np.float32)
    size = np.zeros((4, 2), np.int32)
    for k, im in enumerate(images):
        data[k, :im.shape[0], :im.shape[1]] = im
        size[k] = (im.shape[1], im.shape[0])
    tex_index = np.asarray(scene.materials.tex_index).copy()
    for row, slots in slot_assignments.items():
        for slot, k in slots.items():
            tex_index[row, slot] = k
    materials = scene.materials.replace(tex_index=jnp.asarray(tex_index))
    return finalize_scene(scene.geom, materials,
                          Textures(data=jnp.asarray(data),
                                   size=jnp.asarray(size)))


@pytest.mark.parametrize("case", ["diffuse", "emissive_rough_metal", "normal",
                                  "opacity"])
def test_textured_scenes(case):
    slots, seed, outlier = {
        "diffuse": ({0: {TEX_DIFFUSE: 0}}, 2, 0.01),
        "emissive_rough_metal": ({3: {TEX_EMISSIVE: 1},
                                  0: {TEX_ROUGHNESS: 1, TEX_METALLIC: 1}},
                                 4, 0.01),
        "normal": ({0: {TEX_NORMAL: 2}}, 6, 0.01),
        "opacity": ({4: {TEX_OPACITY: 3}}, 8, 0.02),
    }[case]
    js = _textured_cornell(slots)
    if case == "emissive_rough_metal":
        js = js.replace(materials=js.materials.replace(
            specular=jnp.ones_like(js.materials.specular) * 0.8))
    assert js.has_opacity_tex == (case == "opacity")
    _compare(js, outlier, width=10, height=10, max_depth=2, spp=2, seed=seed)


def test_sample_texture_matches_jax():
    """Repeat wrap of negative and integer uvs (torch.remainder, as jnp.mod),
    truncation to texels, the true per-texture extent, and the mask."""
    js = _textured_cornell({})
    ps, _ = from_reference(js)
    rs = np.random.RandomState(0)
    n = 4000
    uv = rs.uniform(-3, 3, (n, 2)).astype(np.float32)
    uv[::5] = np.round(uv[::5])
    uv[1::7] = -1e-9
    idx = rs.randint(0, 4, n).astype(np.int32)
    mask = rs.uniform(size=n) < 0.9
    fallback = rs.uniform(size=(n, 4)).astype(np.float32)
    ref = j_sample(js.textures, jnp.asarray(idx), jnp.asarray(uv),
                   jnp.asarray(fallback), jnp.asarray(mask))
    out = sample_texture(ps.textures, torch.tensor(idx), torch.tensor(uv),
                         torch.tensor(fallback), torch.tensor(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _indexed_read(textures, tex_idx, uv, fallback, mask):
    """The texture read as torch advanced indexing (``data[k, y, x]``), the
    expression ``sample_texture`` had before it went through the
    pack-gather: the oracle for its values and its gradient."""
    safe_idx = torch.where(mask, tex_idx, 0)
    x, y = texel_coords(textures, safe_idx, uv)
    texel = textures.data[safe_idx.long(), y.long(), x.long()]
    return torch.where(mask[:, None], texel, fallback)


def _texture_case(case):
    """(textures, tex_idx, uv, mask) of one case: three textures of
    different sizes in one padded stack, so every case reads through the
    padding's row stride."""
    rs = np.random.RandomState(len(case))
    sizes = [(5, 3), (8, 8), (2, 7)]              # (w, h)
    data = np.zeros((3, 8, 8, 4), np.float32)
    for k, (w, h) in enumerate(sizes):
        data[k, :h, :w] = rs.uniform(0.1, 1.0, (h, w, 4))
    textures = PTextures(data=torch.tensor(data),
                         size=torch.tensor(sizes, dtype=torch.int32))
    n = 3001
    uv = rs.uniform(-2, 2, (n, 2)).astype(np.float32)
    idx = rs.randint(0, 3, n).astype(np.int32)
    mask = rs.uniform(size=n) < 0.8
    if case == "all masked":
        mask[:] = False
    elif case == "none masked":
        mask[:] = True
    elif case == "wrap edges":
        edges = np.array([0.0, 1.0, -1.0, 2.0, -1e-9, 1 - 1e-7, 0.5, -0.5],
                         np.float32)
        uv = edges[rs.randint(0, len(edges), (n, 2))]
    elif case == "one texel":
        idx[:] = 1
        uv[:] = (0.3, 0.6)
        mask[:] = True
    return (textures, torch.tensor(idx), torch.tensor(uv),
            torch.tensor(mask))


@pytest.mark.parametrize("case", ["mixed sizes", "all masked", "none masked",
                                  "wrap edges", "one texel"])
def test_sample_texture_equals_the_indexed_read(case):
    """Through the pack-gather (one row of the flattened stack per lane,
    masked lanes out of range) the values equal the advanced-index read's
    bit for bit, and so does the gradient w.r.t. the texels: both sum each
    texel's lanes in lane order on the CPU. The backward is one plain K3
    (``gather_rows_t_bwd_plain``) per read."""
    textures, idx, uv, mask = _texture_case(case)
    rs = np.random.RandomState(5)
    fallback = torch.tensor(rs.uniform(size=(len(idx), 4)), dtype=torch.float32)
    cot = torch.tensor(rs.randn(len(idx), 4), dtype=torch.float32)
    results = []
    for read in (sample_texture, _indexed_read):
        data = textures.data.clone().requires_grad_()
        tex = PTextures(data=data, size=textures.size)
        def run():
            out = read(tex, idx, uv, fallback, mask)
            return out, torch.autograd.grad((out * cot).sum(), data)[0]
        (out, grad), moved = obs.counted(run)
        results.append((out, grad, moved.get("gather_rows_t_bwd_plain", 0)))
    (out, grad, k3), (ref_out, ref_grad, _) = results
    assert torch.equal(out, ref_out)
    assert torch.equal(grad, ref_grad)
    assert k3 == 1
    if case == "all masked":
        assert torch.equal(out, fallback) and not grad.any()
    if case == "one texel":
        assert grad.reshape(-1, 4).any(dim=1).sum() == 1


def test_interpolate_uv_matches_jax():
    js = jb.cornell_spheres_scene()
    ps, _ = from_reference(js)
    rs = np.random.RandomState(1)
    n = 1000
    idx = rs.randint(0, js.num_triangles, n).astype(np.int32)
    u = rs.uniform(0, 0.5, n).astype(np.float32)
    v = rs.uniform(0, 0.5, n).astype(np.float32)
    ref = j_interp(js, jnp.asarray(idx), jnp.asarray(u), jnp.asarray(v))
    out = interpolate_uv(ps, torch.tensor(idx), torch.tensor(u),
                         torch.tensor(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
