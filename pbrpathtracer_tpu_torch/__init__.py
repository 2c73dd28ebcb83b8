"""pbrpathtracer_tpu_torch: the PyTorch + CUDA port of ``pbrpathtracer_tpu``.

The scene builders put a scene on the card unless the caller names another
device (``device="cpu"``), and the render and its gradient run on the
scene's device. On an NVIDIA H100
the closest-hit queries, the shading-pack fetches and their backward run in
hand-written CUDA kernels (``csrc/``), built with nvcc at first use; on the
CPU the same calls take the kernels' plain torch versions. The JAX package
stays the reference that the port is tested against; this package never
imports JAX.

    from pbrpathtracer_tpu_torch import builders, Camera, RenderConfig, render
    scene = builders.cornell_box()      # on the card; device="cpu": the CPU
    camera = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                         fovy=61)
    cfg = RenderConfig(width=512, height=512, max_depth=4)
    img = render(scene, camera, cfg)
    loss, grads = grad_render(scene, camera, cfg, target=img * 0.8)
    result = fit(scene, camera, cfg, target=img, steps=40)

Scene files and the application path (``api``): ``load_pts`` / ``save_pts``
and ``EditorScene`` (OBJ objects, transforms, materials, textures;
``build_scene()`` puts the scene on the card), ``RenderSession``
(progressive passes with pause, resume and checkpoints), ``preview_render``
and ``pick`` (``ops/preview``), ``export_png``, and the command line
``python -m pbrpathtracer_tpu_torch render scene.pts -o out.png``.

Over several devices (``parallel/``, ``dist/``): one process per device on
``torch.distributed``, the scene replicated, the pixels sharded by rank;
``dist.multihost.initialize``, ``render_multihost`` and
``parallel.render.make_train_step`` (one all-reduce per step).
"""

import torch

from .api import (  # noqa: F401
    EditorScene, MaterialSpec, RenderSession, RenderState, export_png, fit,
    get_params, get_resolution_from_scene_file, grad_render, l2_image_loss,
    load_pts, loss_and_grad, render_pts, save_pts, set_params)
from .engine.config import RenderConfig  # noqa: F401
from .ops.integrator import render, tonemap_u8  # noqa: F401
from .ops.preview import pick, preview_render  # noqa: F401
from .scene import builders  # noqa: F401
from .scene.scene import Camera  # noqa: F401

# The path has no matmul, but a float32 product anywhere in the port must run
# in full float32, not TF32: state it rather than rely on defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
