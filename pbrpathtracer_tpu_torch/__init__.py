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
"""

import torch

from .api import (  # noqa: F401
    fit, get_params, grad_render, l2_image_loss, loss_and_grad, set_params)
from .engine.config import RenderConfig  # noqa: F401
from .ops.integrator import render, tonemap_u8  # noqa: F401
from .scene import builders  # noqa: F401
from .scene.scene import Camera  # noqa: F401

# The path has no matmul, but a float32 product anywhere in the port must run
# in full float32, not TF32: state it rather than rely on defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
