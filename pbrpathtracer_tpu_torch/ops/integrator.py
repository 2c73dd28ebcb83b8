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
reads one flag back from the device per segment.

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
from . import rng
from .camera import generate_rays
from .compaction import (coherence_key, compact_gather, compact_sort,
                         scatter_to_slots)
from .hit import closest_hit
from .shade import WavefrontState, shade_segment


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


def _shadow_trace(scene, cfg, seed, pixel, sample_idx, stream):
    def trace(p, l, sh_alive=None):
        return closest_hit(scene, cfg, p, l, seed, pixel, sample_idx, stream,
                           slot_base=rng.SLOT_NEE_OPACITY_BASE,
                           alive=sh_alive)
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


def _segment(scene, cfg, state, seg, sample_idx, seed, remat):
    """One bounce: hit query, then shading, recomputed in the backward as
    ``remat`` says."""
    stream = rng.bounce_stream(seg)
    shadow = _shadow_trace(scene, cfg, seed, state.pixel, sample_idx, stream)

    def query(st):
        return closest_hit(scene, cfg, st.ro, st.rd, seed, st.pixel,
                           sample_idx, stream, alive=st.alive)

    def query_and_shade(st):
        return shade_segment(scene, cfg, st, *query(st), seg, sample_idx,
                             seed, shadow)

    if remat == "all":
        return checkpoint(query_and_shade, state, use_reentrant=False,
                          preserve_rng_state=False)
    hits = query(state)
    if remat == "off":
        return shade_segment(scene, cfg, state, *hits, seg, sample_idx, seed,
                             shadow)
    tape = _ShadowTape(shadow)

    def shade(st, hits):
        tape.pos = 0
        return shade_segment(scene, cfg, st, *hits, seg, sample_idx, seed,
                             tape)
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


def _render_sample(scene, camera, cfg, sample_idx, pixel_idx, seed):
    device = scene.device
    camera = camera.to(device)
    blocked = pixel_idx is None and cfg.resolved_pixel_order() == "block"
    if blocked:
        # keyed by the pixel value, so only lane positions change; undone
        # by the scatter at the end
        pixel_idx = torch.from_numpy(
            block_pixel_order(cfg.width, cfg.height)).to(device)
    elif pixel_idx is None:
        pixel_idx = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                                 device=device)
    seed = cfg.seed if seed is None else seed
    remat = cfg.resolved_remat() if torch.is_grad_enabled() else "off"

    ro, rd = generate_rays(camera, cfg.width, cfg.height, seed, sample_idx,
                           pixel_idx)
    state = WavefrontState.initial(ro, rd, pixel_idx)
    compact = _compactor(scene, cfg)
    slot = torch.arange(ro.shape[0], dtype=torch.int32, device=device)
    for seg in range(cfg.resolved_max_segments()):
        if cfg.skip_dead_segments and not bool(state.alive.any()):
            break
        if compact is not None:
            state, slot = compact(state, slot)
        state = _segment(scene, cfg, state, seg, sample_idx, seed, remat)
    radiance = state.radiance
    if compact is not None:
        radiance = scatter_to_slots(radiance, slot)
    if blocked:
        radiance = scatter_to_slots(radiance, pixel_idx)
    return radiance


def render_sample(scene: Scene, camera: Camera, cfg, sample_idx,
                  pixel_idx=None, seed=None):
    """Trace one sample per pixel. Returns radiance f32[N, 3].

    ``sample_idx`` is the absolute sample counter, so progressive passes and
    resumed renders draw fresh, seed-exact samples. ``seed`` overrides
    ``cfg.seed``.
    """
    with _grad_mode(scene, camera):
        return _render_sample(scene, camera, cfg, sample_idx, pixel_idx,
                              seed)


def render_accumulate(scene: Scene, camera: Camera, cfg, accum,
                      sample_start, num_samples: int, seed=None):
    """Add ``num_samples`` progressive passes onto ``accum`` (f32[N,3]) and
    return it; the caller tracks the sample counter."""
    with _grad_mode(scene, camera):
        for k in range(num_samples):
            accum = accum + render_sample(scene, camera, cfg,
                                          sample_start + k, seed=seed)
    return accum


def render(scene: Scene, camera: Camera, cfg, seed=None):
    """Render cfg.spp samples; returns the mean radiance f32[H, W, 3] on the
    scene's device, differentiable w.r.t. every leaf that requires grad."""
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
