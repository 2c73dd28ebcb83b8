"""The sharded entries' compiled programs (``engine.compiled.FUSED`` and
``VJPS``, and the captured samples over a pixel shard) on the CPU.

The CUDA graphs need the card (tests/test_torch_gpu.py and ``chip_smoke.py``
phase 34 hold them bit-equal to the eager steps). Here:

* the programs the graphs capture, run eagerly at fixed segment counts
  (the live counts and the cap), on the shards of worlds 1, 2 and 4
  (``Mesh(None, rank, world, cpu)``, the all-reduce replaced by one that
  reduces nothing): the fused step's program (``diff.loss.fused_fwd_bwd``)
  equals the eager fused step's loss and gradients bit for bit, and the
  per-sample VJP (``diff.loss.sample_vjp``), summed over the samples,
  the eager overlapped step's;
* the compiled steps' schedule, with the caches replaced by the programs
  run at the counts a capture would run (the cap, or the segments the
  forward pass found): the same losses, gradients and parameters as the
  eager steps, bit for bit, the same all-reduces, and every VJP asked for
  the segments of the step's longest sample;
* the programs, summed over the shards of a world, against the JAX
  package's ``make_train_step`` and ``make_train_step_overlapped`` on the
  virtual CPU mesh, under SGD with lr 1, at tests/test_torch_parallel.py's
  tolerances (loss 1e-6; parameter changes rtol 1e-4, atol 1e-7);
* the keys: a shard's sample key follows its length, dtype and device,
  never its pointer or values; a program's key differs by program, by
  shard length and by deterministic mode, not by seed or values;
* neither program makes a collective; the CPU never reaches the caches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.diff.params import get_params as j_get_params
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.parallel import mesh as jmesh
from pbrpathtracer_tpu.parallel import render as jrender
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu_torch import RenderConfig, get_params
from pbrpathtracer_tpu_torch.diff.loss import fused_fwd_bwd, sample_vjp
from pbrpathtracer_tpu_torch.diff.params import clip_params
from pbrpathtracer_tpu_torch.dist import multihost as mh
from pbrpathtracer_tpu_torch.engine import compiled
from pbrpathtracer_tpu_torch.ops.integrator import SamplePlan, run_segments
from pbrpathtracer_tpu_torch.parallel import mesh as pmesh
from pbrpathtracer_tpu_torch.parallel import render as prender
from pbrpathtracer_tpu_torch.parallel.mesh import (FlatReduce, Mesh,
                                                   local_shard, make_mesh)
from pbrpathtracer_tpu_torch.parallel.render import (
    eager_render_local, eager_render_sharded, make_train_step,
    make_train_step_overlapped, render_local, render_sharded)
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
CAM = Camera.make(**POSE)
JCAM = JCamera.make(**POSE)
CPU = torch.device("cpu")
FUSED_CFG = dict(width=16, height=16, max_depth=2, spp=1, seed=4)
OVER_CFG = dict(width=16, height=16, max_depth=2, spp=2, seed=4)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _inputs(cfg, seed=0):
    """Pixel ids and target f32[n_pix, 3], made with numpy."""
    rs = np.random.RandomState(seed)
    return (torch.arange(cfg.num_pixels, dtype=torch.int32),
            torch.tensor(rs.uniform(0.1, 0.6, (cfg.num_pixels, 3)).astype(
                np.float32)))


def _leaves(params):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in sorted(params.items())}


class _Recorder(torch.optim.SGD):
    """SGD that keeps the gradients of its last step, in the leaves'
    order: what the reduce handed the update."""

    def step(self, closure=None):
        self.seen = [p.grad.clone() for g in self.param_groups
                     for p in g["params"]]
        return super().step(closure)


@pytest.fixture
def no_reduce(monkeypatch):
    """``all_reduce_flat`` as the steps call it, replaced by one that
    reduces nothing (a fake mesh of several ranks has no group) and counts
    its calls."""
    calls = []

    def fake(tensors, mesh, async_op=False):
        calls.append(len(list(tensors)))
        return FlatReduce(None, None, None, None)
    monkeypatch.setattr(prender, "all_reduce_flat", fake)
    return calls


def _eager_step(make, cfg, mesh, seed=0):
    """(loss, the gradients the update saw by key, p0, p1) of one eager
    step on ``mesh``'s shard."""
    scene = pb.cornell_box(device="cpu")
    pix, target = _inputs(cfg)
    params = {k: v.clone() for k, v in get_params(scene, CAM).items()}
    p0 = {k: v.clone() for k, v in params.items()}
    step = make(scene, CAM, cfg, functools.partial(_Recorder, lr=1.0), mesh)
    loss = step.eager(params, local_shard(pix, mesh),
                      local_shard(target, mesh), seed)
    return loss, dict(zip(sorted(params), step.optimizer.seen)), p0, params


# ---- the programs at fixed counts against the eager steps -------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_program_equals_the_eager_fused_step(no_reduce, world):
    cfg = RenderConfig(**FUSED_CFG)
    scene = pb.cornell_box(device="cpu")
    pix, target = _inputs(cfg)
    n_seg = cfg.resolved_max_segments()
    for rank in range(world):
        mesh = Mesh(None, rank, world, CPU)
        loss, seen, p0, _ = _eager_step(make_train_step, cfg, mesh)
        shard, tgt = local_shard(pix, mesh), local_shard(target, mesh)
        _, _, runs, _ = fused_fwd_bwd(_leaves(p0), scene, CAM, cfg, tgt,
                                      shard, 0)
        for counts in (runs, [n_seg] * cfg.spp):
            f_loss, f_grads, f_runs, _ = fused_fwd_bwd(
                _leaves(p0), scene, CAM, cfg, tgt, shard, 0, counts)
            assert f_runs == counts
            assert _same_bits(f_loss, loss), (rank, counts)
            assert sorted(f_grads) == sorted(seen)
            for k in seen:
                assert _same_bits(f_grads[k], seen[k]), (rank, counts, k)
    assert no_reduce == [1 + len(seen)] * world


def _cotangent(scene, cfg, params, shard, target, seed=0):
    """The overlapped step's pass 1 on this shard: (loss part, cotangent)."""
    posed = prender.set_params(scene, CAM, params)
    mean = eager_render_local(*posed, cfg, shard, seed)
    diff = mean - target
    n_elems = 3 * cfg.num_pixels
    return (torch.sum(diff * diff),
            diff * (2.0 / (n_elems * cfg.spp)))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_vjp_program_equals_the_eager_overlapped_step(no_reduce, world):
    cfg = RenderConfig(**OVER_CFG)
    scene = pb.cornell_box(device="cpu")
    pix, target = _inputs(cfg)
    n_seg = cfg.resolved_max_segments()
    for rank in range(world):
        mesh = Mesh(None, rank, world, CPU)
        loss, seen, p0, _ = _eager_step(make_train_step_overlapped, cfg, mesh)
        shard, tgt = local_shard(pix, mesh), local_shard(target, mesh)
        part, cot = _cotangent(scene, cfg, p0, shard, tgt)
        assert _same_bits(part / (3 * cfg.num_pixels), loss)
        runs = [sample_vjp(_leaves(p0), scene, CAM, cfg, cot, k, shard,
                           0)[2][0] for k in range(cfg.spp)]
        for count in (max(runs), n_seg):
            total = {k: torch.zeros_like(v) for k, v in seen.items()}
            for k in range(cfg.spp):
                value, g, f_runs, tails = sample_vjp(
                    _leaves(p0), scene, CAM, cfg, cot, k, shard, 0, [count])
                assert value is None and f_runs == [count]
                assert tails[0] is None or not bool(tails[0])
                for key in total:
                    total[key] += g[key]
            for key in seen:
                assert _same_bits(total[key], seen[key]), (rank, count, key)
    assert no_reduce == [1, len(seen), len(seen)] * world


# ---- the compiled steps' schedule, the caches standing in ------------------

class _Samples:
    """Stands in for ``SAMPLES``: the sample run as a replay runs it (every
    flag read back), its segments appended to ``runs``."""

    def sample(self, scene, camera, cfg, k, seed=None, consume=torch.clone,
               pixel_idx=None, runs=None):
        with torch.inference_mode():
            radiance, run, _ = run_segments(SamplePlan(scene, camera, cfg, k,
                                                       seed, pixel_idx))
            runs.append(run)
            return consume(radiance)


class _Grads:
    """Stands in for ``FUSED`` or ``VJPS``: the program on fresh leaves at
    the counts a capture runs (``need``, else the cap), every call's
    ``need`` kept."""

    def __init__(self, name):
        self.program = compiled.PROGRAMS[name]
        self.needs = []

    def run(self, params, scene, camera, cfg, inputs, seed=None, need=None,
            defer=False):
        self.needs.append(need)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        n = len(need) if need else cfg.spp
        counts = need or [cfg.resolved_max_segments()] * n
        value, grads, _, tails = self.program(leaves, scene, camera, cfg,
                                              seed, counts, **inputs)
        if not defer:
            assert tails[0] is None or not bool(tails[0])
            return value, grads
        return value, grads, tails[0]


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("make", [make_train_step,
                                  make_train_step_overlapped])
def test_the_compiled_steps_equal_the_eager_ones(monkeypatch, no_reduce,
                                                 make, world):
    grads = {"fused": _Grads("fused"), "vjp": _Grads("vjp")}
    monkeypatch.setattr(compiled, "SAMPLES", _Samples())
    monkeypatch.setattr(compiled, "FUSED", grads["fused"])
    monkeypatch.setattr(compiled, "VJPS", grads["vjp"])
    cfg = RenderConfig(**(FUSED_CFG if make is make_train_step
                          else OVER_CFG))
    scene = pb.cornell_box(device="cpu")
    pix, target = _inputs(cfg)
    mesh = Mesh(None, world - 1, world, CPU)
    shard, tgt = local_shard(pix, mesh), local_shard(target, mesh)
    out = {}
    for way in ("eager", "compiled"):
        params = {k: v.clone() for k, v in get_params(scene, CAM).items()}
        step = make(scene, CAM, cfg, functools.partial(_Recorder, lr=1e-2),
                    mesh)
        del no_reduce[:]
        losses = [getattr(step, way)(params, shard, tgt, s) for s in (0, 3)]
        out[way] = (losses, step.optimizer.seen, params, list(no_reduce))
    (le, ge, pe, re), (lc, gc, pc, rc) = out["eager"], out["compiled"]
    assert all(_same_bits(a, b) for a, b in zip(le, lc))
    assert all(_same_bits(a, b) for a, b in zip(ge, gc))
    assert all(_same_bits(pe[k].detach(), pc[k].detach()) for k in pe)
    assert re == rc
    if make is make_train_step:
        assert grads["fused"].needs == [None, None] and not grads["vjp"].needs
    else:
        # every VJP of a step asks for the segments of its longest sample
        assert len(grads["vjp"].needs) == 2 * cfg.spp
        assert all(len(n) == 1 and 0 < n[0] <= cfg.resolved_max_segments()
                   for n in grads["vjp"].needs)
        assert len(re) == 2 * (cfg.spp + 1)


def test_a_cut_vjp_raises_before_the_update(monkeypatch, no_reduce):
    """A VJP whose tail flag is set (its forward ran more segments than it
    did) stops the compiled overlapped step before the optimizer moves a
    parameter."""
    class Short(_Grads):
        def run(self, *args, need=None, **kwargs):
            return super().run(*args, need=[1], **kwargs)
    monkeypatch.setattr(compiled, "SAMPLES", _Samples())
    monkeypatch.setattr(compiled, "VJPS", Short("vjp"))
    cfg = RenderConfig(**OVER_CFG)
    scene = pb.cornell_box(device="cpu")
    pix, target = _inputs(cfg)
    params = {k: v.clone() for k, v in get_params(scene, CAM).items()}
    before = {k: v.clone() for k, v in params.items()}
    step = make_train_step_overlapped(
        scene, CAM, cfg, functools.partial(torch.optim.SGD, lr=1e-2),
        make_mesh(device="cpu"))
    with pytest.raises(RuntimeError, match="cut short"):
        step.compiled(params, pix, target, 0)
    assert all(torch.equal(params[k].detach(), before[k]) for k in params)


# ---- against the JAX package's steps ----------------------------------------

def _jmesh(n):
    return jmesh.make_mesh(jax.devices("cpu")[:n])


@functools.lru_cache(maxsize=None)
def _jax_step(which, n_dev):
    make, kw = {"fused": (jrender.make_train_step, FUSED_CFG),
                "overlapped": (jrender.make_train_step_overlapped,
                               OVER_CFG)}[which]
    js, jcfg = jb.cornell_box(), JConfig(**kw)
    pix, target = (x.numpy() for x in _inputs(RenderConfig(**kw)))
    jm, opt = _jmesh(n_dev), optax.sgd(1.0)
    params = j_get_params(js, JCAM, materials=True)
    step = make(js, JCAM, jcfg, opt, jm)
    shard, rep = jmesh.ray_sharding(jm), jmesh.replicated(jm)
    p1, _, loss = step(jax.device_put(params, rep),
                       jax.device_put(opt.init(params), rep), js, JCAM,
                       jax.device_put(jnp.asarray(pix), shard),
                       jax.device_put(jnp.asarray(target), shard),
                       jnp.uint32(0))
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in p1.items()}, float(loss))


def _program_step(which, world):
    """(p0, p1, loss) of one SGD-lr-1 step made of the programs: each
    rank's part at the live counts, summed over the ranks of ``world``."""
    cfg = RenderConfig(**(FUSED_CFG if which == "fused" else OVER_CFG))
    scene = pb.cornell_box(device="cpu")
    pix, target = _inputs(cfg)
    p0 = get_params(scene, CAM)
    loss, total = 0.0, {k: torch.zeros_like(v) for k, v in p0.items()}
    for rank in range(world):
        mesh = Mesh(None, rank, world, CPU)
        shard, tgt = local_shard(pix, mesh), local_shard(target, mesh)
        if which == "fused":
            part, grads, _, _ = fused_fwd_bwd(_leaves(p0), scene, CAM, cfg,
                                              tgt, shard, 0)
            parts = [grads]
        else:
            part, cot = _cotangent(scene, cfg, p0, shard, tgt)
            part = part / (3 * cfg.num_pixels)
            parts = [sample_vjp(_leaves(p0), scene, CAM, cfg, cot, k, shard,
                                0)[1] for k in range(cfg.spp)]
        loss += float(part)
        for g in parts:
            for k in total:
                total[k] += g[k]
    p1 = clip_params({k: p0[k] - total[k] for k in p0})
    return p0, p1, loss


@pytest.mark.parametrize("which,world", [("fused", 1), ("fused", 4),
                                         ("overlapped", 4)])
def test_the_programs_match_the_jax_steps(which, world):
    jp0, jp1, jloss = _jax_step(which, world)
    p0, p1, loss = _program_step(which, world)
    assert abs(loss - jloss) < 1e-6
    assert sorted(p1) == sorted(jp1)
    moved = 0.0
    for k in p1:
        np.testing.assert_array_equal(p0[k].numpy(), jp0[k])
        g = (p0[k] - p1[k]).numpy()
        np.testing.assert_allclose(g, jp0[k] - jp1[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
        moved += float(np.abs(g).sum())
    assert moved > 0


# ---- the keys ---------------------------------------------------------------

def test_a_shards_sample_key_follows_its_length_not_its_tensor():
    scene, cfg = pb.cornell_box(device="cpu"), RenderConfig(**OVER_CFG)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
    a = local_shard(pix, Mesh(None, 0, 4, CPU))
    b = local_shard(pix, Mesh(None, 3, 4, CPU)).clone()
    key = compiled.sample_key(scene, CAM, cfg, a)
    assert a.data_ptr() != b.data_ptr() and not torch.equal(a, b)
    assert compiled.sample_key(scene, CAM, cfg, b) == key
    assert compiled.sample_key(scene, CAM, cfg.replace(seed=7), b) == key
    for other in (pix[:32], pix, a.long()):
        assert compiled.sample_key(scene, CAM, cfg, other) != key
    assert compiled.sample_key(scene, CAM, cfg) != compiled.sample_key(
        scene, CAM, cfg, pix)


def _program_inputs(which, shard, cfg):
    n = shard.shape[0]
    if which == "fused":
        return {"target": torch.zeros((n, 3)), "pixel_idx": shard}
    return {"cot": torch.zeros((n, 3)), "sample_idx": 1, "pixel_idx": shard}


def test_program_keys_differ_by_program_shard_length_and_determinism():
    scene, cfg = pb.cornell_box(device="cpu"), RenderConfig(**OVER_CFG)
    params = get_params(scene, CAM)
    pix = torch.arange(cfg.num_pixels, dtype=torch.int32)
    quarter = local_shard(pix, Mesh(None, 1, 4, CPU))

    def key(which, shard, c=cfg, p=params):
        return compiled.program_key(which, p, scene, CAM, c,
                                    _program_inputs(which, shard, c))
    keys = {w: key(w, quarter) for w in ("fused", "vjp")}
    assert keys["fused"] != keys["vjp"]
    assert compiled.grad_key(params, scene, CAM, cfg, torch.zeros(
        (cfg.height, cfg.width, 3))) not in keys.values()
    for w, k in keys.items():
        # another shard of the same length, another seed, other values:
        # the same key
        assert key(w, local_shard(pix, Mesh(None, 2, 4, CPU))) == k
        assert key(w, quarter, cfg.replace(seed=9),
                   {n: v + 0.25 for n, v in params.items()}) == k
        # another length, another config: another key
        assert key(w, local_shard(pix, Mesh(None, 0, 2, CPU))) != k
        assert key(w, quarter, cfg.replace(spp=3)) != k
        torch.use_deterministic_algorithms(True)
        try:
            assert key(w, quarter) != k
        finally:
            torch.use_deterministic_algorithms(False)


def test_each_program_keeps_its_own_cache():
    caches = (compiled.GRADS, compiled.FUSED, compiled.VJPS)
    assert [c.name for c in caches] == ["loss", "fused", "vjp"]
    assert len({id(c._entries) for c in caches}) == 3


# ---- no collective, no capture on the CPU -----------------------------------

def _refuse(*args, **kwargs):
    raise AssertionError("reached where it must not")


def test_neither_program_makes_a_collective(monkeypatch):
    for mod in (pmesh, prender, mh):
        for name in ("all_reduce_flat", "all_gather_rows",
                     "broadcast_params"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, _refuse)
    cfg = RenderConfig(**OVER_CFG)
    scene = pb.cornell_box(device="cpu")
    pix, target = _inputs(cfg)
    shard = local_shard(pix, Mesh(None, 1, 2, CPU))
    params = get_params(scene, CAM)
    for which in ("fused", "vjp"):
        cache = compiled.GradCache(which)
        inputs = _program_inputs(which, shard, cfg)
        value, grads = cache.eager(params, scene, CAM, cfg, inputs, 0)
        assert sorted(grads) == sorted(params)
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        assert (value is None) == (which == "vjp")


def test_cpu_sharded_entries_never_capture(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _refuse)
    monkeypatch.setattr(compiled.SampleCache, "sample", _refuse)
    monkeypatch.setattr(compiled.GradCache, "run", _refuse)
    for cls in (prender._FusedStep, prender._OverlappedStep):
        monkeypatch.setattr(cls, "compiled", _refuse)
    scene = pb.cornell_box(device="cpu")
    cfg = RenderConfig(**OVER_CFG)
    mesh = make_mesh(device="cpu")
    img = render_sharded(scene, CAM, cfg, mesh=mesh)
    assert torch.equal(img, eager_render_sharded(scene, CAM, cfg, mesh=mesh))
    assert torch.equal(mh.render_multihost(scene, CAM, cfg, mesh=mesh), img)
    pix, target = _inputs(cfg)
    local = mh.render_multihost(scene, CAM, cfg, mesh=mesh, gather=False)
    assert not local.is_inference()
    assert torch.equal(local, eager_render_local(scene, CAM, cfg, pix))
    local.zero_()     # a fresh tensor: the next render does not see it
    assert torch.equal(render_local(scene, CAM, cfg, pix),
                       eager_render_local(scene, CAM, cfg, pix))
    for make in (make_train_step, make_train_step_overlapped):
        params = {k: v.clone() for k, v in get_params(scene, CAM).items()}
        step = make(scene, CAM, cfg, functools.partial(torch.optim.SGD,
                                                       lr=1e-2), mesh)
        assert bool(torch.isfinite(step(params, pix, target, 0)))
    for cache in (compiled.SAMPLES, compiled.FUSED, compiled.VJPS):
        assert not cache._entries
