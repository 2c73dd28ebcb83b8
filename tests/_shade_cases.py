"""The scenes on which the fused shading segment (``ops/shade._shade_fused``)
is held against its torch twin (``ops/shade.shade_plain``): on the CPU by
``tests/test_torch_shade_fused.py`` (the kernels' source built for the host),
on the card by ``tests/test_torch_gpu.py``. Imports no JAX.

* ``cornell``: the box, diffuse, NEE through K1;
* ``textured``: the textured mesh with a texture in every slot a hit reads
  (the normal map, with texels whose z falls below the surface, the diffuse,
  emissive, roughness (0 and 1 among its texels) and metallic overrides) and
  an opacity map, textures of several sizes in one padded stack, and uvs
  that wrap on both sides;
* ``translucent``: the glass box behind a thin lens, depth 8;
* ``ggx_rr_nee``: the spheres with ``brdf="ggx"``, ``rr_reweight`` and
  ``nee_physical``;
* ``no_lights``: the box with its light list emptied (no NEE, no shadow
  query).
"""

import dataclasses

import numpy as np
import torch

from pbrpathtracer_tpu_torch import Camera, RenderConfig
from pbrpathtracer_tpu_torch.diff.params import MATERIAL_FIELDS
from pbrpathtracer_tpu_torch.ops import integrator, rng
from pbrpathtracer_tpu_torch.ops.hit import closest_hit
from pbrpathtracer_tpu_torch.ops.integrator import SamplePlan
from pbrpathtracer_tpu_torch.scene import builders
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)
from pbrpathtracer_tpu_torch.scene.scene import pack_textures
from pbrpathtracer_tpu_torch.utils.constants import (
    TEX_DIFFUSE, TEX_EMISSIVE, TEX_METALLIC, TEX_NORMAL, TEX_OPACITY,
    TEX_ROUGHNESS)

CASES = ("cornell", "textured", "translucent", "ggx_rr_nee", "no_lights")

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
LENS = dict(focal_dist=2.2, aperture=0.04)


def _every_slot(scene):
    """``scene`` with a texture in every slot of its even materials."""
    rs = np.random.RandomState(3)

    def image(h, w, lo=0.0, hi=1.0):
        return rs.uniform(lo, hi, (h, w, 4)).astype(np.float32)
    normal = image(6, 5)
    normal[..., 2] = rs.uniform(0.3, 1.0, (6, 5))   # z <= 0 after 2x - 1
    rough = image(4, 8)
    rough[0, :4, 0] = (0.0, 1.0, 0.0, 1.0)
    images = {TEX_DIFFUSE: image(8, 8), TEX_NORMAL: normal,
              TEX_EMISSIVE: image(3, 7, 0.0, 0.2), TEX_ROUGHNESS: rough,
              TEX_METALLIC: image(5, 3), TEX_OPACITY: image(8, 8, 0.3, 1.0)}
    slots = sorted(images)
    dev = scene.geom.v0.device
    tex_index = scene.materials.tex_index.clone()
    tex_index[::2] = torch.tensor(slots, dtype=tex_index.dtype)
    textures = pack_textures([images[s] for s in slots]).to(dev)
    g = scene.geom   # uvs below 0 and above 1: the wrap's both sides
    geom = dataclasses.replace(g, uv0=g.uv0 * 3.0 - 1.25,
                               uv1=g.uv1 * 3.0 - 1.25, uv2=g.uv2 * 3.0 - 1.25)
    return dataclasses.replace(
        scene, geom=geom, materials=dataclasses.replace(scene.materials,
                                                        tex_index=tex_index),
        textures=textures, has_any_texture=True, has_opacity_tex=True)


def case(name, device, width, height, mesh_tris):
    """(scene, camera, config) of case ``name`` at ``width`` x ``height``;
    the textured mesh has ``mesh_tris`` triangles."""
    cfg = RenderConfig(width=width, height=height, max_depth=3, seed=5)
    cam = Camera.make(**POSE)
    if name == "cornell":
        scene = builders.cornell_box(device=device)
    elif name == "textured":
        scene = _every_slot(mesh_scene(mesh_tris, device=device))
        cam = mesh_scene_camera()
    elif name == "translucent":
        scene = builders.translucent_scene(device=device)
        cam = Camera.make(**POSE, **LENS)
        cfg = cfg.replace(max_depth=8, max_segments=24)
    elif name == "ggx_rr_nee":
        scene = builders.cornell_spheres_scene(device=device)
        cfg = cfg.replace(brdf="ggx", rr_reweight=True, nee_physical=True,
                          max_depth=2)
    elif name == "no_lights":
        base = builders.cornell_box(device=device)
        scene = dataclasses.replace(base, lights=base.lights[:0])
    else:
        raise ValueError(name)
    return scene, cam.to(device), cfg


def segment_pairs(scene, camera, cfg, seed, sample_idx, shade_a, shade_b):
    """For each segment of one sample that has a live lane: (segment,
    ``shade_a``'s state, ``shade_b``'s state), both shaded from the same
    state and hits; the sample goes on from ``shade_b``'s. ``shade_*`` take
    ``ops/shade._shade``'s arguments."""
    with torch.inference_mode():
        plan = SamplePlan(scene, camera, cfg, sample_idx, seed)
        state, _, _ = plan.prologue()
        packs = plan.packs
        for seg in range(plan.n_segments):
            if not bool(state.alive.any()):
                break
            stream = rng.bounce_stream(seg)
            hits = closest_hit(scene, cfg, state.ro, state.rd, seed,
                               state.pixel, sample_idx, stream,
                               alive=state.alive, uv_pack=packs.uv_opacity)
            args = (scene, cfg, state, *hits, seg, sample_idx, seed,
                    integrator._shadow_trace(scene, cfg, seed, state.pixel,
                                             sample_idx, stream,
                                             packs.uv_opacity),
                    packs)
            a, b = shade_a(*args), shade_b(*args)
            yield seg, a, b
            state = b


FIELDS = ("ro", "rd", "throughput", "radiance", "alive", "inside", "itr",
          "depth", "pixel")

LEAVES = ("materials", "textures", "camera", "geometry")
_GEOMETRY = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2")


def segment_grads(scene, camera, cfg, leaves, shade_fn, seed=3,
                  sample_idx=0):
    """(loss, {leaf: gradient or None}) of a sample's first segment shaded
    by ``shade_fn`` (``ops/shade.shade_segment``'s arguments, packs given)
    with grad on and the leaves named by ``leaves`` requiring grad:
    ``materials`` (the material fields), ``textures`` (the texture stack),
    ``camera`` (the state's ro and rd, which the camera's leaves reach),
    ``geometry`` (the triangles' corners, vertex normals and uvs). The loss
    weighs the new state's float fields by fixed random weights."""
    from pbrpathtracer_tpu_torch.ops import shadepack
    with torch.no_grad():
        plan = SamplePlan(scene, camera, cfg, sample_idx, seed)
        state, _, _ = plan.prologue()
        stream = rng.bounce_stream(0)
        hits = closest_hit(scene, cfg, state.ro, state.rd, seed, state.pixel,
                           sample_idx, stream, alive=state.alive,
                           uv_pack=plan.packs.uv_opacity)

    def leaf(x):
        return x.detach().clone().requires_grad_(True)
    params = {}
    if leaves == "materials":
        m = scene.materials
        params = {f: leaf(getattr(m, f)) for f in MATERIAL_FIELDS}
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(m, **params))
    elif leaves == "textures":
        params = {"data": leaf(scene.textures.data)}
        scene = dataclasses.replace(scene, textures=dataclasses.replace(
            scene.textures, **params))
    elif leaves == "camera":
        params = {"ro": leaf(state.ro), "rd": leaf(state.rd)}
        state = dataclasses.replace(state, **params)
    elif leaves == "geometry":
        params = {f: leaf(getattr(scene.geom, f)) for f in _GEOMETRY}
        scene = dataclasses.replace(
            scene, geom=dataclasses.replace(scene.geom, **params))
    else:
        raise ValueError(leaves)
    with torch.enable_grad():
        packs = shadepack.build_packs(scene)
        shadow = integrator._shadow_trace(scene, cfg, seed, state.pixel,
                                          sample_idx, stream,
                                          packs.uv_opacity)
        out = shade_fn(scene, cfg, state, *hits, 0, sample_idx, seed,
                       shadow, packs)
        gen = torch.Generator().manual_seed(11)
        loss = sum((getattr(out, f)
                    * torch.rand(3, generator=gen).to(out.ro.device)).sum()
                   for f in ("ro", "rd", "throughput", "radiance"))
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return loss.detach(), dict(zip(params, grads))
