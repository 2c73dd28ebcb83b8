"""Wavefront integrator, as ``pbrpathtracer_tpu.ops.integrator``: every
(pixel, sample) lane runs closest hit → masked shading → next ray, one bounce
segment at a time.

Lane order: the primary rays go in scanline or 64x8-block pixel order
(``cfg.resolved_pixel_order``), and each live segment may first compact the
wavefront (``cfg.resolved_compact``; ops/compaction.py), by the coherence
key for scenes over ``cfg.bvh_threshold`` triangles. Both permutations are
undone at the end; a reordered render equals the scanline one bit for bit
per pixel.

The loop stops once every lane is dead (``skip_dead_segments``); that test
reads one flag back from the device per segment: the count of live lanes,
which tracing also counts (``observability.segment_run``). A sample is
split where the compiled runner (``engine/compiled.py``) splits it, into a
prologue (rays and the initial wavefront), one body per segment and an
epilogue (the scatters): ``SamplePlan``, driven by ``drive``, or by
``run_segments`` with a fixed segment count, which reads nothing back (a
captured fwd+bwd, whose backward cannot be cut at the segments). The
prologue also builds the scene's shading packs (``shadepack.build_packs``),
which every segment of the sample reads.

Compiled entries: on a CUDA scene, where no autograd graph is recorded,
``render`` and ``render_accumulate`` go through the captured samples of
``engine/compiled.py`` (the JAX package runs them under ``jax.jit``): the
first sample of a scene, camera and config runs eagerly, the second is
captured in CUDA graphs, and every later one replays them, with the same
result bit for bit. ``render_sample`` is always eager: a loop of it, summed
and divided by the sample count as ``render`` does, is the eager render.

Progressive accumulation matches the reference's buffer semantics: float
accumulation of per-pass radiance, display = floor(clamp(accum / samples, 0,
1) * 255), no gamma.

A render records an autograd graph only when a scene or camera leaf
requires grad (and grad mode is on); otherwise it runs under
``torch.inference_mode()``. Under a graph each bounce segment is
recomputed in the backward as ``cfg.remat_segments`` says (the JAX
package's remat of the segment body, ``jax.checkpoint``); the keyed RNG
draws the same numbers in the recompute with no state saved.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..scene.scene import Camera, Scene
from ..utils import observability
from . import rng
from .camera import generate_rays
from .compaction import (coherence_key, compact_gather, compact_sort,
                         scatter_to_slots)
from .hit import closest_hit
from .shade import WavefrontState, shade_segment
from .shadepack import build_packs


@functools.lru_cache(maxsize=32)
def block_pixel_order(width: int, height: int, bw: int = 64, bh: int = 8):
    """Block-major pixel permutation (i32 numpy array): consecutive lanes
    cover bw x bh image rectangles instead of scanlines; ragged edge blocks
    give shorter runs."""
    idx = np.arange(width * height, dtype=np.int32).reshape(height, width)
    blocks = [idx[y0:y0 + bh, x0:x0 + bw].ravel()
              for y0 in range(0, height, bh)
              for x0 in range(0, width, bw)]
    return np.concatenate(blocks)


def _records_graph(scene: Scene, camera: Camera) -> bool:
    leaves = [getattr(c, f.name)
              for c in (scene.geom, scene.materials, scene.textures, camera)
              for f in dataclasses.fields(c)]
    return torch.is_grad_enabled() and any(x.requires_grad for x in leaves)


def _grad_mode(scene: Scene, camera: Camera):
    if _records_graph(scene, camera):
        return contextlib.nullcontext()
    return torch.inference_mode()


def _shadow_trace(scene, cfg, seed, pixel, sample_idx, stream, uv_pack):
    def trace(p, l, sh_alive=None):
        return closest_hit(scene, cfg, p, l, seed, pixel, sample_idx, stream,
                           slot_base=rng.SLOT_NEE_OPACITY_BASE,
                           alive=sh_alive, discrete=True, uv_pack=uv_pack)
    return trace


class _ShadowTape:
    """Shadow queries recorded on a segment's first run and replayed when
    the checkpoint recomputes the segment, so no query runs in the
    backward."""

    def __init__(self, trace):
        self.trace = trace
        self.saved = []
        self.pos = 0

    def __call__(self, p, l, sh_alive=None):
        if self.pos == len(self.saved):
            self.saved.append(self.trace(p, l, sh_alive))
        out = self.saved[self.pos]
        self.pos += 1
        return out


def _segment(scene, cfg, state, seg, sample_idx, seed, remat, packs=None):
    """One bounce: hit query, then shading, recomputed in the backward as
    ``remat`` says. ``packs`` (``shadepack.ScenePacks``, or None to build
    them at each use) are closed over, so a recompute reads them and never
    builds them again."""
    stream = rng.bounce_stream(seg)
    uv_pack = None if packs is None else packs.uv_opacity
    shadow = _shadow_trace(scene, cfg, seed, state.pixel, sample_idx, stream,
                           uv_pack)

    def query(st):
        return closest_hit(scene, cfg, st.ro, st.rd, seed, st.pixel,
                           sample_idx, stream, alive=st.alive,
                           uv_pack=uv_pack)

    def query_and_shade(st):
        return shade_segment(scene, cfg, st, *query(st), seg, sample_idx,
                             seed, shadow, packs)

    if remat == "all":
        return checkpoint(query_and_shade, state, use_reentrant=False,
                          preserve_rng_state=False)
    hits = query(state)
    if remat == "off":
        return shade_segment(scene, cfg, state, *hits, seg, sample_idx, seed,
                             shadow, packs)
    tape = _ShadowTape(shadow)

    def shade(st, hits):
        tape.pos = 0
        return shade_segment(scene, cfg, st, *hits, seg, sample_idx, seed,
                             tape, packs)
    return checkpoint(shade, state, hits, use_reentrant=False,
                      preserve_rng_state=False)


def _compactor(scene, cfg):
    """fn(state, slot) -> (state, slot) for cfg.resolved_compact, or None."""
    mode = cfg.resolved_compact()
    if mode == "off":
        return None
    base = compact_sort if mode == "sort" else compact_gather
    if scene.num_triangles > cfg.bvh_threshold:
        return lambda st, sl: base(st, sl, key=coherence_key(st, scene))
    return base


@functools.lru_cache(maxsize=32)
def block_pixel_order_on(width: int, height: int, device: torch.device):
    """``block_pixel_order`` as an i32 tensor on ``device``, copied there
    once per (width, height, device): a captured sample reads it."""
    with torch.inference_mode(False):
        return torch.from_numpy(block_pixel_order(width, height)).to(device)


class SamplePlan:
    """One sample of ``render_sample``, split where the compiled runner
    (``engine/compiled.py``) captures it:

    * ``prologue()``: the scene's shading packs (``packs``, kept on the
      plan), the camera rays and the initial wavefront;
    * ``segment(k, state, slot)``: compaction (if any) and bounce segment k,
      which reads the prologue's packs;
    * ``epilogue(state, slot)``: the scatters that undo compaction and the
      block pixel order; the radiance f32[N, 3].

    The first two return (state, slot, flag): ``flag`` is ``alive.sum()``
    of the new state, the count of its live lanes on the device, which the
    next segment is tested on, or None where no test follows (the last
    segment, or ``skip_dead_segments`` off). ``drive`` runs the three in
    the eager loop's order. ``seed`` and ``sample_idx`` are ints or 0-d
    tensors.
    """

    def __init__(self, scene, camera, cfg, sample_idx, seed=None,
                 pixel_idx=None, remat="off"):
        device = scene.device
        self.scene, self.cfg, self.remat = scene, cfg, remat
        self.camera = camera.to(device)
        self.sample_idx = sample_idx
        self.seed = cfg.seed if seed is None else seed
        self.n_segments = cfg.resolved_max_segments()
        self.compact = _compactor(scene, cfg)
        # the block order is keyed by the pixel value, so only lane
        # positions change; the epilogue's scatter undoes it
        self.order = None
        if pixel_idx is None and cfg.resolved_pixel_order() == "block":
            pixel_idx = self.order = block_pixel_order_on(
                cfg.width, cfg.height, device)
        elif pixel_idx is None:
            pixel_idx = torch.arange(cfg.width * cfg.height,
                                     dtype=torch.int32, device=device)
        self.pixel_idx = pixel_idx
        self.packs = None   # the prologue's shadepack.ScenePacks

    def _flag(self, state, next_seg):
        if self.cfg.skip_dead_segments and next_seg < self.n_segments:
            return state.alive.sum()
        return None

    def prologue(self):
        self.packs = build_packs(self.scene)
        ro, rd = generate_rays(self.camera, self.cfg.width, self.cfg.height,
                               self.seed, self.sample_idx, self.pixel_idx)
        state = WavefrontState.initial(ro, rd, self.pixel_idx)
        slot = torch.arange(ro.shape[0], dtype=torch.int32, device=ro.device)
        return state, slot, self._flag(state, 0)

    def segment(self, seg, state, slot):
        if self.compact is not None:
            state, slot = self.compact(state, slot)
        state = _segment(self.scene, self.cfg, state, seg, self.sample_idx,
                         self.seed, self.remat, self.packs)
        return state, slot, self._flag(state, seg + 1)

    def epilogue(self, state, slot):
        return unscatter(state.radiance,
                         None if self.compact is None else slot, self.order)


def unscatter(radiance, slot, order):
    """The epilogue's scatters: undo the compaction (``slot``, or None) and
    then the block pixel order (``order``, or None)."""
    with observability.span("pbr.epilogue"):
        if slot is not None:
            radiance = scatter_to_slots(radiance, slot)
        if order is not None:
            radiance = scatter_to_slots(radiance, order)
        return radiance


def drive(plan):
    """Run a ``SamplePlan`` (or anything with its three methods, such as a
    captured sample) as the eager loop does: a segment runs only while its
    flag, read back from the device, says a lane is alive."""
    return run_segments(plan)[0]


def run_segments(plan, count=None):
    """(radiance, segments run, tail flag) of a ``SamplePlan``.

    ``count=None`` is ``drive``'s loop, which reads each flag back. A fixed
    ``count`` runs exactly that many segments and reads nothing back, as a
    captured fwd+bwd must (``engine/compiled.py``): a segment over lanes
    that are all dead returns its input state bit for bit, in value and in
    gradient, so running past the live segments changes nothing. The tail
    flag is the device flag after the last segment run, where the eager
    loop would test again (None where it would not): non-zero means that
    ``count`` cut live lanes short. At a fixed count, the flag that each
    segment enters with is noted for a graph being captured
    (``observability.segment_entered``: its dead segments); with
    ``count=None`` each segment run is noted with the live lanes it was
    entered with (``observability.segment_run``)."""
    state, slot, flag = plan.prologue()
    lanes = state.alive.shape[0]
    run = 0
    for seg in range(plan.n_segments if count is None else count):
        if count is not None:
            observability.segment_entered(flag)
            state, slot, flag = plan.segment(seg, state, slot)
        else:
            live = None
            if flag is not None:
                with observability.host_read("pbr.read.flag"):
                    live = int(flag)
                if not live:
                    break
            with observability.segment_run(live, lanes):
                state, slot, flag = plan.segment(seg, state, slot)
        run += 1
    return plan.epilogue(state, slot), run, flag


def _render_sample(scene, camera, cfg, sample_idx, pixel_idx, seed):
    remat = cfg.resolved_remat() if torch.is_grad_enabled() else "off"
    return drive(SamplePlan(scene, camera, cfg, sample_idx, seed, pixel_idx,
                            remat))


def render_sample(scene: Scene, camera: Camera, cfg, sample_idx,
                  pixel_idx=None, seed=None):
    """Trace one sample per pixel. Returns radiance f32[N, 3].

    ``sample_idx`` is the absolute sample counter, so progressive passes and
    resumed renders draw fresh, seed-exact samples. ``seed`` overrides
    ``cfg.seed``. Both may be Python ints or 0-d integer tensors (a device
    value, as the JAX package traces them). Always eager: the compiled
    sample is ``engine.compiled.SAMPLES.sample``.
    """
    with _grad_mode(scene, camera):
        return _render_sample(scene, camera, cfg, sample_idx, pixel_idx,
                              seed)


def render_accumulate(scene: Scene, camera: Camera, cfg, accum,
                      sample_start, num_samples: int, seed=None):
    """Add ``num_samples`` progressive passes onto ``accum`` (f32[N,3]) and
    return it; the caller tracks the sample counter. On a CUDA scene with
    no graph to record, the passes go through the captured samples
    (``engine/compiled.py``); the sum is the same bit for bit."""
    if scene.device.type == "cuda" and not _records_graph(scene, camera):
        from ..engine.compiled import SAMPLES
        return SAMPLES.accumulate(scene, camera, cfg, accum, sample_start,
                                  num_samples, seed)
    with _grad_mode(scene, camera):
        for k in range(num_samples):
            radiance = render_sample(scene, camera, cfg, sample_start + k,
                                     seed=seed)
            with observability.span("pbr.epilogue"):
                accum = accum + radiance
    return accum


def render(scene: Scene, camera: Camera, cfg, seed=None):
    """Render cfg.spp samples; returns the mean radiance f32[H, W, 3] on the
    scene's device, differentiable w.r.t. every leaf that requires grad.
    A forward-only render on the card goes through the captured samples
    (``render_accumulate``)."""
    with _grad_mode(scene, camera):
        accum = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                            device=scene.device)
        accum = render_accumulate(scene, camera, cfg, accum, 0, cfg.spp,
                                  seed=seed)
        img = (accum / float(cfg.spp)).reshape(cfg.height, cfg.width, 3)
    # a forward-only render is an inference tensor, which autograd cannot
    # save: hand back a normal one, so that it can be a loss's target
    return img.clone() if img.is_inference() else img


def tonemap_u8(accum, samples):
    """Display conversion: clamp the running mean to [0, 1] and truncate to
    bytes (no gamma)."""
    res = torch.clamp(accum / float(samples), 0.0, 1.0)
    return (res * 255.0).to(torch.uint8)
