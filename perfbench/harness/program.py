"""The system under test, ``pbrpathtracer_tpu_torch``, as the benchmark
drives it: the only module of the benchmark that imports the program.

The benchmark hands the program raw scene arrays (a configuration's
``build``), and the program derives everything else itself: its packs,
lights, flags and, over 4,096 triangles, its BVH (``finalize_scene``).
"""

from __future__ import annotations

import numpy as np
import torch


def scene(arrays: dict, device):
    """The program's scene of a configuration's arrays, on ``device``."""
    from pbrpathtracer_tpu_torch.scene.scene import (
        MaterialSpec, finalize_scene, pack_geometry, pack_materials,
        pack_textures)
    geom = pack_geometry({k: np.asarray(v) for k, v in
                          arrays["tris"].items()})
    mats = pack_materials([MaterialSpec(**m) for m in arrays["materials"]])
    textures = pack_textures(arrays["textures"]) if arrays["textures"] \
        else None
    return finalize_scene(geom, mats, textures).to(device)


def camera(spec: dict, device):
    from pbrpathtracer_tpu_torch.scene.scene import Camera
    return Camera.make(**spec).to(device)


def config(render: dict, seed):
    """The program's ``RenderConfig`` of a run's render keys (every key is
    a field of it) and seed."""
    from pbrpathtracer_tpu_torch.engine.config import RenderConfig
    return RenderConfig(seed=seed, **render)


def session(scene_, camera_, cfg):
    """A started progressive session: ``step(1)`` renders one pass."""
    from pbrpathtracer_tpu_torch.engine.session import RenderSession
    s = RenderSession(scene=scene_, camera=camera_, cfg=cfg,
                      device=scene_.device)
    s.start()
    return s


def fit(scene_, camera_, cfg, target, lr, materials, textures, callback):
    """``diff.fit.fit`` (Adam at ``lr``, the clip after each step, step s
    seeded ``cfg.seed + s``) until ``callback`` stops it."""
    from pbrpathtracer_tpu_torch.diff.fit import fit as run
    return run(scene_, camera_, cfg, target, steps=2 ** 62, lr=lr,
               materials=materials, textures=textures, callback=callback)


def counters() -> dict:
    """The compiled caches' captures and regrowths so far, to show a
    capture inside the window."""
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS, SAMPLES
    return {"sample_captures": SAMPLES.captures,
            "sample_capture_s": SAMPLES.capture_s,
            "grad_captures": GRADS.captures,
            "grad_capture_s": GRADS.capture_s,
            "grad_regrowths": GRADS.regrowths}


def release():
    """Drop every captured program, so that the reference runs in the
    memory they held."""
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS, SAMPLES
    SAMPLES.clear()
    GRADS.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
