"""Wavefront integrator, as ``pbrpathtracer_tpu.ops.integrator``: every
(pixel, sample) lane runs closest hit → masked shading → next ray, one bounce
segment at a time, in scanline pixel order and without lane compaction.

The loop stops once every lane is dead (``skip_dead_segments``); that test
reads one flag back from the device per segment.

Progressive accumulation matches the reference's buffer semantics: float
accumulation of per-pass radiance, display = floor(clamp(accum / samples, 0,
1) * 255), no gamma. Everything runs under ``torch.inference_mode()`` on the
scene's device; gradients are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.scene import Camera, Scene
from . import rng
from .camera import generate_rays
from .hit import closest_hit
from .shade import WavefrontState, shade_segment


def _require_no_grad(scene: Scene, camera: Camera):
    leaves = [getattr(c, f.name)
              for c in (scene.geom, scene.materials, scene.textures, camera)
              for f in dataclasses.fields(c)]
    if any(x.requires_grad for x in leaves):
        raise NotImplementedError(
            "gradients through the renderer are not ported yet")


def _shadow_trace(scene, cfg, seed, pixel, sample_idx, stream):
    def trace(p, l, sh_alive=None):
        return closest_hit(scene, cfg, p, l, seed, pixel, sample_idx, stream,
                           slot_base=rng.SLOT_NEE_OPACITY_BASE,
                           alive=sh_alive)
    return trace


@torch.inference_mode()
def render_sample(scene: Scene, camera: Camera, cfg, sample_idx,
                  pixel_idx=None, seed=None):
    """Trace one sample per pixel. Returns radiance f32[N, 3].

    ``sample_idx`` is the absolute sample counter, so progressive passes and
    resumed renders draw fresh, seed-exact samples. ``seed`` overrides
    ``cfg.seed``.
    """
    _require_no_grad(scene, camera)
    device = scene.device
    camera = camera.to(device)
    if pixel_idx is None:
        pixel_idx = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                                 device=device)
    seed = cfg.seed if seed is None else seed

    ro, rd = generate_rays(camera, cfg.width, cfg.height, seed, sample_idx,
                           pixel_idx)
    state = WavefrontState.initial(ro, rd, pixel_idx)
    for seg in range(cfg.resolved_max_segments()):
        if cfg.skip_dead_segments and not bool(state.alive.any()):
            break
        stream = rng.bounce_stream(seg)
        hit, idx, t, u, v = closest_hit(scene, cfg, state.ro, state.rd, seed,
                                        state.pixel, sample_idx, stream,
                                        alive=state.alive)
        state = shade_segment(
            scene, cfg, state, hit, idx, t, u, v, seg, sample_idx, seed,
            _shadow_trace(scene, cfg, seed, state.pixel, sample_idx, stream))
    return state.radiance


@torch.inference_mode()
def render_accumulate(scene: Scene, camera: Camera, cfg, accum,
                      sample_start, num_samples: int, seed=None):
    """Add ``num_samples`` progressive passes onto ``accum`` (f32[N,3]) and
    return it; the caller tracks the sample counter."""
    for k in range(num_samples):
        accum = accum + render_sample(scene, camera, cfg, sample_start + k,
                                      seed=seed)
    return accum


@torch.inference_mode()
def render(scene: Scene, camera: Camera, cfg, seed=None):
    """Render cfg.spp samples; returns the mean radiance f32[H, W, 3] on the
    scene's device."""
    accum = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                        device=scene.device)
    accum = render_accumulate(scene, camera, cfg, accum, 0, cfg.spp,
                              seed=seed)
    return (accum / float(cfg.spp)).reshape(cfg.height, cfg.width, 3)


def tonemap_u8(accum, samples):
    """Display conversion: clamp the running mean to [0, 1] and truncate to
    bytes (no gamma)."""
    res = torch.clamp(accum / float(samples), 0.0, 1.0)
    return (res * 255.0).to(torch.uint8)
