"""The shading packs built once per sample (``shadepack.build_packs`` in
``SamplePlan.prologue``), against the packs built at every use, as
``shade_segment``, ``direct_illumination`` and ``closest_hit`` build them
when a caller hands them none.

On the CPU, on the Cornell box, the 3000-triangle textured mesh (K4's
route), the translucent scene behind a lens and Cornell with an opacity
texture:

* a sample is the same bits either way;
* tracing's ``pack_builds`` counts one build per pack a sample (the tri
  pack, the light pack, and the uv-opacity pack where the scene has an
  opacity texture) whatever the number of segments, against one per use
  when every use builds;
* a fwd+bwd gives the same loss bits, and gradients within a relative L2
  error of 1e-5 of the per-use builds (autograd now sums the segments'
  cotangents of a pack before its one backward), under each
  ``remat_segments``;
* the benchmark's ``pack_builds_per_call`` reads the counter per call, and
  nothing from a record without it.

The card's side (the builds in the prologue graph, the replays bit for bit)
is ``tests/test_torch_gpu.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu_torch import Camera, RenderConfig, get_params
from pbrpathtracer_tpu_torch.diff.loss import eager_loss_and_grad
from pbrpathtracer_tpu_torch.ops import integrator
from pbrpathtracer_tpu_torch.ops.integrator import (SamplePlan, render_sample,
                                                    run_segments)
from pbrpathtracer_tpu_torch.scene import builders
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)
from pbrpathtracer_tpu_torch.scene.scene import finalize_scene, pack_textures
from pbrpathtracer_tpu_torch.utils import observability as obs
from pbrpathtracer_tpu_torch.utils.constants import TEX_OPACITY

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
LENS = dict(focal_dist=2.2, aperture=0.04)
SCENES = ["cornell", "mesh3k", "translucent", "opacity"]


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Each test starts with no record and tracing off."""
    monkeypatch.setattr(obs, "_record", None)
    monkeypatch.setattr(obs, "_active", False)
    monkeypatch.setattr(obs, "_forced", 0)
    monkeypatch.setattr(obs, "_pending", [])


def _opacity_cornell():
    """Cornell with a random opacity map on the tall box (material 4), as
    tests/test_torch_hit_vjp.py builds it."""
    base = builders.cornell_box(device="cpu")
    tex_index = base.materials.tex_index.clone()
    tex_index[4, TEX_OPACITY] = 0
    omap = np.zeros((4, 4, 4), np.float32)
    omap[..., 0] = np.random.RandomState(0).uniform(0.2, 0.9, (4, 4))
    return finalize_scene(
        base.geom, dataclasses.replace(base.materials, tex_index=tex_index),
        pack_textures([omap]))


def _case(name, max_depth=3):
    """(scene, camera, config, leaves a gradient takes) at a small image."""
    cfg = RenderConfig(width=10, height=8, max_depth=max_depth, seed=5)
    if name == "cornell":
        return (builders.cornell_box(device="cpu"), Camera.make(**POSE), cfg,
                {})
    if name == "mesh3k":
        return (mesh_scene(3000, device="cpu"), mesh_scene_camera(),
                cfg.replace(width=8, height=6), {"textures": True})
    if name == "translucent":
        return (builders.translucent_scene(device="cpu"),
                Camera.make(**POSE, **LENS),
                cfg.replace(max_depth=max_depth + 2), {"camera_lens": True})
    scene = _opacity_cornell()
    assert scene.has_opacity_tex
    return scene, Camera.make(**POSE), cfg, {}


def _per_use(monkeypatch):
    """Make every sample hand its segments no packs: each use builds."""
    monkeypatch.setattr(integrator, "build_packs", lambda scene: None)


def _packs_of(scene) -> int:
    return 1 + (scene.num_lights > 0) + scene.has_opacity_tex


def _traced_samples(scene, cam, cfg, samples):
    """(radiance of each sample, segments each ran, the record's counts)."""
    with obs.tracing(), torch.inference_mode():
        out = [run_segments(SamplePlan(scene, cam, cfg, k))
               for k in samples]
    return ([r for r, _, _ in out], [n for _, n, _ in out],
            obs.last_record()["counts"])


@pytest.mark.parametrize("name", SCENES)
def test_a_sample_is_the_same_bits_with_the_packs_built_once(name,
                                                             monkeypatch):
    scene, cam, cfg, _ = _case(name)
    with torch.inference_mode():
        once = [render_sample(scene, cam, cfg, k) for k in range(2)]
    _per_use(monkeypatch)
    with torch.inference_mode():
        each = [render_sample(scene, cam, cfg, k) for k in range(2)]
    for a, b in zip(once, each):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_depth", [1, 4])
@pytest.mark.parametrize("name", SCENES)
def test_pack_builds_count_one_per_pack_a_sample(name, max_depth,
                                                 monkeypatch):
    """Once per sample whatever the segments; the builds at every use
    count a tri pack and a light pack per segment, and a uv-opacity pack
    per hit query (the bounce query and the NEE shadow query)."""
    scene, cam, cfg, _ = _case(name, max_depth)
    samples = (0, 1, 2)
    once, runs, counts = _traced_samples(scene, cam, cfg, samples)
    assert counts["pack_builds"] == _packs_of(scene) * len(samples)
    assert sum(runs) > len(samples)
    _per_use(monkeypatch)
    each, runs_each, counts_each = _traced_samples(scene, cam, cfg, samples)
    assert runs_each == runs
    assert all(torch.equal(a, b) for a, b in zip(once, each))
    assert counts_each["pack_builds"] == sum(runs) * (
        2 + 2 * scene.has_opacity_tex)


def _rel_l2(a, b) -> float:
    den = float(torch.linalg.vector_norm(b.double()))
    num = float(torch.linalg.vector_norm((a - b).double()))
    return num / den if den else num


@pytest.mark.parametrize("remat", ["off", "hits", "all"])
@pytest.mark.parametrize("name", SCENES)
def test_a_fwd_bwd_matches_the_builds_at_every_use(name, remat, monkeypatch):
    scene, cam, cfg, select = _case(name)
    cfg = cfg.replace(spp=2, remat_segments=remat)
    params = get_params(scene, cam, **select)
    target = torch.tensor(np.random.RandomState(1).uniform(
        0.0, 0.5, (cfg.height, cfg.width, 3)).astype(np.float32))
    with obs.tracing():
        loss, grads = eager_loss_and_grad(params, scene, cam, cfg, target)
    assert obs.last_record()["counts"]["pack_builds"] == \
        _packs_of(scene) * cfg.spp     # none again in the recompute
    _per_use(monkeypatch)
    loss_each, grads_each = eager_loss_and_grad(params, scene, cam, cfg,
                                                target)
    assert float(loss) == float(loss_each)
    assert grads.keys() == grads_each.keys()
    moved = 0
    for k, g in grads.items():
        assert _rel_l2(g, grads_each[k]) <= 1e-5, k
        moved += bool(grads_each[k].abs().max() > 0)
    assert moved > 0


def test_the_benchmark_reads_pack_builds_per_call(monkeypatch):
    from perfbench.harness import record, specs
    read = specs.metric_reader("pack_builds_per_call")
    rec = {"calls": 4, "counts": {"graph_launches": 20, "pack_builds": 8}}
    monkeypatch.setattr(record, "last_record", lambda: rec)
    assert read(None) == 2.0
    monkeypatch.setattr(record, "last_record", lambda: {
        "calls": 4, "counts": {"graph_launches": 20}})
    assert read(None) is None        # a program without the counter
    monkeypatch.setattr(record, "last_record", lambda: None)
    assert read(None) is None
    listed = {m["name"]: m for m in specs.benchmark()["per_layer"]}
    entry = listed["pack_builds_per_call"]
    assert entry["layer"] == listed["pack_ms_per_call"]["layer"]
    assert entry["moves"] == "paths_per_s"
    assert set(entry["workloads"]) == {
        w["name"] for w in specs.benchmark()["workloads"]}
