"""Public render and gradient API of the port, as the render/gradient half
of ``pbrpathtracer_tpu.api``:

    render(scene, camera, cfg)            -> f32[H, W, 3]
    grad_render(scene, camera, cfg, ...)  -> (loss, grads)
    fit(scene, camera, cfg, target, ...)  -> FitResult

The session, editor, .pts and PNG entry points are not ported yet.
"""

from __future__ import annotations

from .diff.fit import FitResult, fit
from .diff.loss import l2_image_loss, loss_and_grad
from .diff.params import get_params, set_params
from .engine.config import RenderConfig
from .ops.integrator import render
from .scene import builders
from .scene.scene import Camera, Scene


def grad_render(scene: Scene, camera: Camera, cfg: RenderConfig, target,
                materials=True, textures=False, camera_lens=False, seed=None):
    """(loss, grads dict) of the L2 pixel loss against ``target``, w.r.t.
    the parameters that ``get_params`` selects."""
    params = get_params(scene, camera, materials=materials, textures=textures,
                        camera_lens=camera_lens)
    return loss_and_grad(params, scene, camera, cfg, target, seed)


__all__ = [
    "Camera", "FitResult", "RenderConfig", "Scene", "builders", "fit",
    "get_params", "grad_render", "l2_image_loss", "loss_and_grad", "render",
    "set_params",
]
