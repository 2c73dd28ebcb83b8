"""Differentiable rendering losses and gradient entry points, as
``pbrpathtracer_tpu.diff.loss``."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.integrator import render
from .params import set_params


def render_with_params(params, scene, camera, cfg, seed=None):
    """Render after putting ``params`` in place: the differentiable
    forward."""
    scene, camera = set_params(scene, camera, params)
    return render(scene, camera, cfg, seed=seed)


def l2_image_loss(params, scene, camera, cfg, target, seed=None):
    """Mean squared pixel error against a target image f32[H, W, 3]."""
    img = render_with_params(params, scene, camera, cfg, seed=seed)
    return torch.mean((img - target) ** 2)


def loss_and_grad(params, scene, camera, cfg, target, seed=None):
    """(loss, grads): the loss as a detached scalar tensor and a dict of
    gradients keyed like ``params``. ``params`` are taken as fresh leaves;
    the tensors passed in are not modified."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = l2_image_loss(leaves, scene, camera, cfg, target, seed)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)}


def finite_difference_grad(loss_fn, params, key, eps=1e-3, indices=None):
    """Central finite differences of ``loss_fn(params)`` w.r.t.
    ``params[key]``.

    ``indices``: flat indices to probe (all if None, only sane for small
    parameters). Returns an f64 array shaped like ``params[key]`` with the
    FD values at the probed entries and 0 elsewhere.
    """
    base = params[key].detach().cpu().numpy().astype(np.float64)
    flat = base.reshape(-1)
    out = np.zeros_like(flat)
    for i in (range(flat.size) if indices is None else indices):
        for sgn in (+1, -1):
            pert = flat.copy()
            pert[i] += sgn * eps
            p = dict(params)
            p[key] = torch.tensor(pert.reshape(base.shape), dtype=torch.float32,
                                  device=params[key].device)
            with torch.no_grad():
                out[i] += sgn * float(loss_fn(p))
        out[i] /= 2 * eps
    return out.reshape(base.shape)
