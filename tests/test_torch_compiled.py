"""The split sample that the compiled render captures, on the CPU.

The CUDA graphs themselves need the card (tests/test_torch_gpu.py and
``chip_smoke.py`` phase 32 hold them bit-equal to the eager render). Here:

* ``render_sample`` with the seed and sample index as 0-d tensors (as the
  captured graphs read them) equals the Python-int call bit for bit, and the
  JAX ``render_sample`` under ``jax.jit`` with a traced ``jnp.uint32`` seed
  within tests/test_torch_render.py's budgets (at most 0.5% of pixels over
  1e-3, the rest within 1e-4 on average), for 3 seeds;
* ``SamplePlan``'s prologue, segments and epilogue, driven segment by segment
  as the compiled runner drives them, equal ``render`` and the eager loop as
  it stood before the split, bit for bit: Cornell, the translucent scene
  behind a lens, the block pixel order, compaction by sort and by gather,
  a scene over 2048 triangles;
* ``observability.counted`` gives the counts of an eager segment, plain
  versions counting; captured, the segment's counts go to its graph and
  each replay adds them; every kernel wrapper counts under its own name;
* on the CPU no entry point reaches ``engine.compiled`` or constructs a
  ``torch.cuda.CUDAGraph``, and ``render`` and a session's passes equal the
  loop of ``render_sample`` that is the eager render on the card;
* ``compiled.sample_key`` changes when a scene or camera leaf is replaced,
  not for a new seed or spp;
* a key of the cache holds nothing of its scene, and goes when a node of
  its scene or a tensor of its camera is collected, or when it is the least
  recently used of more than ``CACHE_SIZE``.
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
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.ops import integrator as jint
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from chip_smoke import eager_render
from pbrpathtracer_tpu_torch import (RenderConfig, RenderSession, api,
                                     bridge, render)
from pbrpathtracer_tpu_torch.engine import compiled
from pbrpathtracer_tpu_torch.kernels import intersect as KI
from pbrpathtracer_tpu_torch.kernels import intersect_list as KL
from pbrpathtracer_tpu_torch.kernels import packgather as KP
from pbrpathtracer_tpu_torch.ops import integrator as pint
from pbrpathtracer_tpu_torch.ops.camera import generate_rays
from pbrpathtracer_tpu_torch.ops.compaction import scatter_to_slots
from pbrpathtracer_tpu_torch.ops.shade import WavefrontState
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                      mesh_scene_camera)
from pbrpathtracer_tpu_torch.scene.scene import Camera
from pbrpathtracer_tpu_torch.utils import observability as obs

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
LENS = dict(focal_dist=2.2, aperture=0.04)
from_reference = functools.partial(bridge.from_reference, device="cpu")


@functools.lru_cache(maxsize=None)
def _scene(name):
    if name == "mesh3k":
        return mesh_scene(3000, accel="always", device="cpu")
    return getattr(pb, name)(device="cpu")


def _camera(name):
    if name == "mesh3k":
        return mesh_scene_camera()
    return Camera.make(**POSE, **(LENS if name == "translucent_scene"
                                  else {}))


def _eager_loop(scene, camera, cfg, sample_idx, seed):
    """The eager sample as ``ops/integrator.py`` wrote it before the split:
    one loop, the dead-lane test at its top."""
    device = scene.device
    camera = camera.to(device)
    blocked = cfg.resolved_pixel_order() == "block"
    if blocked:
        pixel_idx = torch.from_numpy(
            pint.block_pixel_order(cfg.width, cfg.height)).to(device)
    else:
        pixel_idx = torch.arange(cfg.width * cfg.height, dtype=torch.int32)
    ro, rd = generate_rays(camera, cfg.width, cfg.height, seed, sample_idx,
                           pixel_idx)
    state = WavefrontState.initial(ro, rd, pixel_idx)
    compact = pint._compactor(scene, cfg)
    slot = torch.arange(ro.shape[0], dtype=torch.int32)
    for seg in range(cfg.resolved_max_segments()):
        if cfg.skip_dead_segments and not bool(state.alive.any()):
            break
        if compact is not None:
            state, slot = compact(state, slot)
        state = pint._segment(scene, cfg, state, seg, sample_idx, seed, "off")
    radiance = state.radiance
    if compact is not None:
        radiance = scatter_to_slots(radiance, slot)
    if blocked:
        radiance = scatter_to_slots(radiance, pixel_idx)
    return radiance


def _driven(plan):
    """The plan segment by segment, as ``drive`` runs a captured sample:
    the flag that a body returns decides whether the next one runs.
    Returns (radiance, segments run)."""
    state, slot, flag = plan.prologue()
    run = 0
    for seg in range(plan.n_segments):
        if flag is not None and not bool(flag):
            break
        state, slot, flag = plan.segment(seg, state, slot)
        run += 1
    assert flag is None or run < plan.n_segments
    return plan.epilogue(state, slot), run


# ---- seed and sample index as device values ---------------------------------

@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 - 3])
def test_tensor_seed_and_sample_match_ints_and_jax(seed):
    js, jcam = jb.cornell_box(), JCamera.make(**POSE)
    ps, pcam = from_reference(js, jcam)
    kw = dict(width=24, height=24, max_depth=3, spp=1)
    cfg = RenderConfig(**kw)
    with torch.inference_mode():
        ints = pint.render_sample(ps, pcam, cfg, 3, seed=seed)
        tensors = pint.render_sample(ps, pcam, cfg, torch.tensor(3),
                                     seed=torch.tensor(seed))
    assert torch.equal(ints, tensors)

    jcfg = JConfig(**kw)
    ref = np.asarray(jax.jit(lambda s: jint.render_sample(
        js, jcam, jcfg, 3, seed=s))(jnp.uint32(seed)))
    d = np.abs(tensors.numpy() - ref).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.005, f"{(d > 1e-3).mean():.3%} outliers"
    assert d[d <= 1e-3].mean() < 1e-4


def test_tensor_seed_changes_the_sample():
    scene, cam = _scene("cornell_box"), _camera("cornell_box")
    cfg = RenderConfig(width=16, height=16, max_depth=2)
    with torch.inference_mode():
        a = pint.render_sample(scene, cam, cfg, torch.tensor(0),
                               seed=torch.tensor(1))
        b = pint.render_sample(scene, cam, cfg, torch.tensor(0),
                               seed=torch.tensor(2))
        c = pint.render_sample(scene, cam, cfg, torch.tensor(1),
                               seed=torch.tensor(1))
    assert not torch.equal(a, b) and not torch.equal(a, c)


# ---- the split sample --------------------------------------------------------

SPLIT_CASES = {
    "cornell": ("cornell_box", dict(max_depth=3)),
    "translucent lens": ("translucent_scene", dict(max_depth=5)),
    "block order": ("cornell_box", dict(max_depth=3, pixel_order="block")),
    "sort": ("cornell_spheres_scene",
             dict(max_depth=3, compact_wavefront="sort")),
    "gather + block": ("cornell_box", dict(max_depth=3,
                                           compact_wavefront="gather",
                                           pixel_order="block")),
    "mesh3k sort": ("mesh3k", dict(max_depth=2, compact_wavefront="sort",
                                   bvh_threshold=2048)),
    "no dead-lane test": ("cornell_box", dict(max_depth=2,
                                             skip_dead_segments=False)),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_sample_equals_render_and_the_eager_loop(case):
    name, kw = SPLIT_CASES[case]
    scene, cam = _scene(name), _camera(name)
    size = 8 if name == "mesh3k" else 20
    cfg = RenderConfig(width=size, height=size - 4, spp=2, seed=11, **kw)
    with torch.inference_mode():
        samples = []
        for k in range(cfg.spp):
            plan = pint.SamplePlan(scene, cam, cfg, torch.tensor(k),
                                   torch.tensor(cfg.seed))
            radiance, run = _driven(plan)
            assert 0 < run <= cfg.resolved_max_segments()
            assert torch.equal(radiance,
                               _eager_loop(scene, cam, cfg, k, cfg.seed))
            assert torch.equal(radiance, pint.drive(pint.SamplePlan(
                scene, cam, cfg, k)))
            samples.append(radiance)
        accum = torch.zeros_like(samples[0])
        for r in samples:
            accum = accum + r
        img = (accum / float(cfg.spp)).reshape(cfg.height, cfg.width, 3)
    assert torch.equal(img, render(scene, cam, cfg))


def test_block_order_is_made_once_per_device():
    a = pint.block_pixel_order_on(130, 20, torch.device("cpu"))
    assert a is pint.block_pixel_order_on(130, 20, torch.device("cpu"))
    assert not a.is_inference()
    np.testing.assert_array_equal(a.numpy(), pint.block_pixel_order(130, 20))


# ---- counting ----------------------------------------------------------------

def _in_graph(group, fn):
    """``fn()`` with its counts noted as in a graph being captured."""
    with obs.graph_spans(group):
        return fn()


def _cpu_group():
    """A graph's group whose stamps need no card."""
    group = obs._Group(graph=True)
    group.stamp = lambda: 0
    return group


@pytest.mark.parametrize("name,counters", [
    ("cornell_box", ("intersect_dense_plain", "gather_rows_t_plain")),
    ("mesh3k", ("intersect_list_plain", "gather_rows_t_plain")),
])
def test_launch_deltas_of_a_segment(name, counters):
    scene, cam = _scene(name), _camera(name)
    cfg = RenderConfig(width=8, height=8, max_depth=2)
    group = _cpu_group()
    with torch.inference_mode():
        plan = pint.SamplePlan(scene, cam, cfg, 0)
        (state, slot, _), built = obs.counted(plan.prologue)
        out, delta = obs.counted(lambda: plan.segment(0, state, slot))
        # what a capture does: the counts go to the graph, not the table
        _, captured = obs.counted(
            lambda: _in_graph(group, lambda: plan.segment(0, state, slot)))
    # one bounce query and one shadow query; one tri-pack and one
    # light-pack fetch and, on a textured scene, the five texture reads;
    # the tri pack's material join is the prologue's, which builds the
    # packs of the sample (tri and light); no kernel wrapper on the CPU
    query, gather = counters
    reads = 5 if scene.has_any_texture else 0
    assert delta == {query: 2, gather: 2 + reads}
    assert built == {gather: 1, "pack_builds": 2}
    assert captured == {} and group.counts == delta
    # three replays add the graph's counts three times, and three launches
    _, replayed = obs.counted(lambda: [obs.replaying(group)
                                       for _ in range(3)])
    assert replayed == {"graph_launches": 3,
                        **{k: 3 * n for k, n in delta.items()}}
    assert out[0].radiance.shape == (64, 3)


def test_every_kernel_wrapper_is_a_registered_counter():
    """Each kernel wrapper counts its launch under its own name, and on
    CPU tensors its plain version's (``intersect_dense_plain`` and so on),
    once a call."""
    dense, big = _scene("cornell_box"), _scene("mesh3k")
    ro = torch.zeros((4, 3))
    rd = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    table = torch.ones((6, 3))
    idx = torch.tensor([0, 5, 7, -1], dtype=torch.int32)
    calls = {
        "intersect_dense": lambda: KI.intersect_dense(dense.geom, ro, rd),
        "intersect_list": lambda: KL.intersect_list(big.geom, ro, rd,
                                                    accel=big.accel),
        "gather_rows_t": lambda: KP.gather_rows_t(table, idx),
        "gather_rows_t_bwd": lambda: KP.gather_rows_t_bwd(
            idx, torch.ones((3, 4)), 6),
    }
    for name, call in calls.items():
        _, moved = obs.counted(call)
        assert moved == {f"{name}_plain": 1}, name


# ---- the CPU stays eager -----------------------------------------------------

def test_cpu_entry_points_never_capture(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU render reached the compiled path")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(compiled.SampleCache, "sample", refuse)
    scene, cam = _scene("cornell_box"), _camera("cornell_box")
    cfg = RenderConfig(width=8, height=8, max_depth=2, spp=2, seed=3)
    img = render(scene, cam, cfg)
    assert torch.equal(img, api.render(scene, cam, cfg))
    acc = pint.render_accumulate(scene, cam, cfg, torch.zeros((64, 3)), 0, 2)
    assert torch.equal((acc / 2.0).reshape(8, 8, 3), img)
    s = RenderSession(scene=scene, camera=cam, cfg=cfg)
    s.start()
    assert s.step(2) == 2
    assert torch.equal(s.accum, acc)
    assert len(compiled.SAMPLES) == 0


def test_render_is_the_render_sample_loop_on_the_cpu():
    """The eager render that the card's tests and chip_smoke hold the
    captured one against is ``render`` itself on the CPU, bit for bit."""
    scene, cam = _scene("translucent_scene"), _camera("translucent_scene")
    cfg = RenderConfig(width=12, height=10, max_depth=3, spp=2, seed=4)
    img = render(scene, cam, cfg)
    assert torch.equal(img, eager_render(scene, cam, cfg))
    assert torch.equal(render(scene, cam, cfg, seed=9),
                       eager_render(scene, cam, cfg, seed=9))
    s = RenderSession(scene=scene, camera=cam, cfg=cfg)
    s.start()
    s.step(2)
    assert torch.equal((s.accum / 2.0).reshape(10, 12, 3), img)


def test_a_cpu_scene_is_refused_by_the_cache():
    scene, cam = _scene("cornell_box"), _camera("cornell_box")
    with pytest.raises(ValueError):
        compiled.SAMPLES.sample(scene, cam, RenderConfig(width=4, height=4),
                                0)


# ---- the cache key -----------------------------------------------------------

def test_sample_key_follows_the_leaves_not_the_seed():
    scene, cam = _scene("cornell_box"), _camera("cornell_box")
    cfg = RenderConfig(width=8, height=8, max_depth=2, seed=1)
    key = compiled.sample_key(scene, cam, cfg)
    assert hash(key) == hash(compiled.sample_key(scene, cam, cfg))
    # the seed and spp change no graph; a sample index is not in the key
    assert compiled.sample_key(scene, cam, cfg.replace(seed=9, spp=4)) == key
    # the same tensors behind new containers are the same key
    assert compiled.sample_key(dataclasses.replace(scene), cam.to("cpu"),
                               cfg) == key
    m = scene.materials
    replaced = [
        (dataclasses.replace(scene, materials=dataclasses.replace(
            m, diffuse=m.diffuse.clone())), cam),
        (dataclasses.replace(scene, geom=dataclasses.replace(
            scene.geom, v0=scene.geom.v0 + 0.0)), cam),
        (dataclasses.replace(scene, lights=scene.lights[:1].clone()), cam),
        (scene, dataclasses.replace(cam, pos=cam.pos.clone())),
        (scene, dataclasses.replace(cam, aperture=torch.tensor(0.1))),
    ]
    for s, c in replaced:
        assert compiled.sample_key(s, c, cfg) != key
    for kw in (dict(max_depth=3), dict(width=16), dict(pixel_order="block"),
               dict(compact_wavefront="sort"),
               dict(skip_dead_segments=False)):
        assert compiled.sample_key(scene, cam, cfg.replace(**kw)) != key
    # a BVH is a leaf too
    big, mcam = _scene("mesh3k"), mesh_scene_camera()
    with_bvh = compiled.sample_key(big, mcam, cfg)
    acc = big.accel
    assert acc is not None
    other = dataclasses.replace(big, accel=dataclasses.replace(
        acc, perm=acc.perm.clone()))
    assert compiled.sample_key(other, mcam, cfg) != with_bvh


# ---- the cache's keys and their lifetime -------------------------------------

def _seen(cache, scene, cam, cfg):
    """Note a key as a first call does (no graphs: the CPU has none)."""
    key = compiled.sample_key(scene, cam, cfg)
    cache._note(key, scene, cam)
    return key


@pytest.mark.parametrize("drop", ["scene", "geometry", "material tensor",
                                  "camera tensor"])
def test_a_key_goes_with_a_collected_node(drop):
    """A key holds nothing of its scene: dropping the scene, or replacing
    one of its nodes and dropping the old one, frees it and forgets the
    key."""
    cache = compiled.SampleCache()
    scene, cam = pb.cornell_box(device="cpu"), _camera("cornell_box")
    cfg = RenderConfig(width=8, height=8, max_depth=2)
    key = _seen(cache, scene, cam, cfg)
    assert key in cache._entries and len(cache) == 0
    if drop == "scene":
        gone = weakref.ref(scene)
        del scene
    elif drop == "geometry":
        gone = weakref.ref(scene.geom)
        scene = dataclasses.replace(scene, geom=dataclasses.replace(
            scene.geom))
    elif drop == "material tensor":
        m = scene.materials
        gone = weakref.ref(m.diffuse)
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            m, diffuse=m.diffuse.clone()))
        del m
    else:
        gone = weakref.ref(cam.pos)
        cam = dataclasses.replace(cam, pos=cam.pos.clone())
    gc.collect()
    assert gone() is None
    assert key not in cache._entries and key not in cache._watches


def test_a_key_stays_while_its_scene_lives():
    cache = compiled.SampleCache()
    scene, cam = pb.cornell_box(device="cpu"), _camera("cornell_box")
    cfg = RenderConfig(width=8, height=8, max_depth=2)
    key = _seen(cache, scene, cam, cfg)
    other = dataclasses.replace(scene)   # a new container, the same nodes
    del other
    cam2 = cam.to("cpu")                 # likewise for the camera
    del cam2
    gc.collect()
    assert key in cache._entries
    assert compiled.sample_key(scene, cam.to("cpu"), cfg) == key


def test_the_cache_forgets_the_least_recently_used_key():
    cache = compiled.SampleCache()
    scene, cam = pb.cornell_box(device="cpu"), _camera("cornell_box")
    keys = [_seen(cache, scene, cam, RenderConfig(width=8, height=8 + i))
            for i in range(compiled.CACHE_SIZE + 1)]
    assert list(cache._entries) == keys[1:]
    assert keys[0] not in cache._watches
    assert all(len(cache._watches[k]) > 0 for k in keys[1:])
    cache.clear()
    assert not cache._entries and not cache._watches
    del scene
    gc.collect()   # the detached watches call nothing
    assert not cache._entries

