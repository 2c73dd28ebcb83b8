"""Public headless API of the port, as ``pbrpathtracer_tpu.api``:

    render(scene, camera, cfg)            -> f32[H, W, 3]
    grad_render(scene, camera, cfg, ...)  -> (loss, grads)
    fit(scene, camera, cfg, target, ...)  -> FitResult
    render_pts(path, ...)                 -> (image, editor, settings)
    RenderSession                         -> progressive/pause/resume/export
    EditorScene / load_pts / save_pts     -> scene authoring + persistence
    export_png                            -> PNG of a render

Scenes are built on the card unless the caller names another device, and
every call runs on its scene's device. ``render`` and ``render_pts`` reach
the compiled forward through ``ops.integrator.render``: on the card, with no
autograd graph to record, their samples go through CUDA graphs
(``engine/compiled.py``, the JAX package's ``_jit_render``): the first
sample renders eagerly, the second is captured, the later ones replay, with
the eager render's result bit for bit (``ops.integrator.render_sample`` is
the eager sample). ``grad_render`` and ``fit``'s steps reach the compiled
fwd+bwd through ``diff.loss.loss_and_grad`` (the JAX package's
``_jit_grad``): on the card a key's first call runs eagerly, its second
captures one CUDA graph of the fwd+bwd, and later calls replay it, with the
eager result bit for bit (``diff.loss.eager_loss_and_grad`` is the eager
program). On the CPU every entry runs eagerly.
"""

from __future__ import annotations

import torch

from .diff.fit import FitResult, fit
from .diff.loss import l2_image_loss, loss_and_grad
from .diff.params import get_params, set_params
from .engine.config import RenderConfig
from .engine.session import RenderSession, RenderState
from .io.png import export_png
from .ops.integrator import render
from .scene import builders
from .scene.editor import EditorScene
from .scene.pts import get_resolution_from_scene_file, load_pts, save_pts
from .scene.scene import Camera, MaterialSpec, Scene


def grad_render(scene: Scene, camera: Camera, cfg: RenderConfig, target,
                materials=True, textures=False, camera_lens=False, seed=None):
    """(loss, grads dict) of the L2 pixel loss against ``target``, w.r.t.
    the parameters that ``get_params`` selects; compiled on the card
    (``loss_and_grad``)."""
    params = get_params(scene, camera, materials=materials, textures=textures,
                        camera_lens=camera_lens)
    return loss_and_grad(params, scene, camera, cfg, target, seed)


def render_pts(pts_path: str, cfg: RenderConfig | None = None, spp=None,
               seed=None, device: str | torch.device = "cuda"):
    """Load a .pts scene and render it on ``device`` (compiled on the card,
    as ``render``); returns (image, editor, settings)."""
    editor, settings = load_pts(pts_path)
    if settings["missing_objects"]:
        raise FileNotFoundError(
            f"missing OBJ assets: {settings['missing_objects']} "
            f"(use EditorScene.redirect + load_pts(editor=...))")
    if cfg is None:
        cfg = RenderConfig(width=settings["width"],
                           height=settings["height"],
                           max_depth=settings["trace_depth"])
    if spp is not None:
        cfg = cfg.replace(spp=spp)
    scene = editor.build_scene(device=device)
    camera = editor.tracer_camera(device=device)
    return render(scene, camera, cfg, seed=seed), editor, settings


__all__ = [
    "Camera", "EditorScene", "FitResult", "MaterialSpec", "RenderConfig",
    "RenderSession", "RenderState", "Scene", "builders", "export_png", "fit",
    "get_resolution_from_scene_file", "get_params", "grad_render",
    "l2_image_loss", "load_pts", "loss_and_grad", "render", "render_pts",
    "save_pts", "set_params",
]
