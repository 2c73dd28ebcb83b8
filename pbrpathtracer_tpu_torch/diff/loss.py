"""Differentiable rendering losses and gradient entry points, as
``pbrpathtracer_tpu.diff.loss``.

``loss_and_grad`` is the port's counterpart of the JAX package's
``jax.jit(jax.value_and_grad(l2_image_loss))``: on a CUDA scene it replays
a fwd+bwd captured in a CUDA graph (``engine.compiled.GRADS``; a key's
first call runs eagerly, its second captures, later ones replay, with the
eager result bit for bit). ``eager_loss_and_grad`` is the same program
run eagerly, as every CPU call runs it: the gradient's ``render_sample``,
for code that watches the eager program (its launch shapes, its
operators).

The sharded train steps (``parallel/render.py``) differentiate two more
programs, written here once for their eager and their captured runs
(``engine.compiled.FUSED`` and ``VJPS``): ``fused_fwd_bwd``, a pixel
shard's squared error over the global element count and its gradient, and
``sample_vjp``, one sample's vector-Jacobian product with a cotangent.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.integrator import SamplePlan, render, run_segments
from ..utils import observability
from .params import set_params


def render_with_params(params, scene, camera, cfg, seed=None):
    """Render after putting ``params`` in place: the differentiable
    forward."""
    scene, camera = set_params(scene, camera, params)
    return render(scene, camera, cfg, seed=seed)


def l2_image_loss(params, scene, camera, cfg, target, seed=None):
    """Mean squared pixel error against a target image f32[H, W, 3], which
    follows the scene's device as the camera does."""
    img = render_with_params(params, scene, camera, cfg, seed=seed)
    return torch.mean((img - target.to(img.device)) ** 2)


def sampled_loss(scene, camera, cfg, target, seed=None, counts=None,
                 pixel_idx=None, divisor=None):
    """(loss, segments run per sample, tail flag per sample): the L2 loss
    of ``render``'s image, sample by sample as ``render`` sums them, on the
    program that ``loss_and_grad`` differentiates.

    ``counts=None`` runs each sample as ``render`` does, skipping its dead
    tail (a flag read back per segment). Otherwise sample k runs exactly
    ``counts[k]`` segments and reads nothing back (``run_segments``): the
    schedule of a captured fwd+bwd.

    ``pixel_idx`` (i32[n]) renders only those lanes, and the image is then
    their mean radiance f32[n, 3], not reshaped. ``divisor=None`` takes the
    mean squared error; an int takes the sum of squares over it."""
    remat = cfg.resolved_remat()
    n = cfg.width * cfg.height if pixel_idx is None else pixel_idx.shape[0]
    accum = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
    runs, tails = [], []
    for k in range(cfg.spp):
        radiance, run, tail = run_segments(
            SamplePlan(scene, camera, cfg, k, seed, pixel_idx, remat),
            None if counts is None else counts[k])
        accum = accum + radiance
        runs.append(run)
        tails.append(tail)
    img = accum / float(cfg.spp)
    if pixel_idx is None:
        img = img.reshape(cfg.height, cfg.width, 3)
    err = (img - target.to(img.device)) ** 2
    loss = torch.mean(err) if divisor is None else torch.sum(err) / divisor
    return loss, runs, tails


def _dense(leaves, grads):
    """``autograd.grad``'s results keyed like ``leaves``, zeros where a
    leaf takes no part."""
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def fwd_bwd(leaves, scene, camera, cfg, target, seed=None, counts=None,
            pixel_idx=None, divisor=None):
    """(loss, grads, segments run per sample, tail flags) with ``leaves``
    (tensors that require grad) put in place by ``set_params``: the loss
    detached, the gradients keyed like ``leaves`` (zeros where a leaf
    takes no part). ``counts``, ``pixel_idx`` and ``divisor`` as
    ``sampled_loss``'s."""
    with torch.enable_grad():
        s, c = set_params(scene, camera, leaves)
        loss, runs, tails = sampled_loss(s, c, cfg, target, seed, counts,
                                         pixel_idx, divisor)
        with observability.device_span("pbr.backward", loss.is_cuda):
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
    return loss.detach(), _dense(leaves, grads), runs, tails


def fused_fwd_bwd(leaves, scene, camera, cfg, target, pixel_idx, seed=None,
                  counts=None):
    """The fused train step's program: ``fwd_bwd`` of the lanes
    ``pixel_idx`` against ``target`` (f32[n, 3]), their squared error over
    the global element count ``3 * cfg.num_pixels``, so that the sum over
    the ranks of the loss and of its gradients is the mean loss and its
    gradients."""
    return fwd_bwd(leaves, scene, camera, cfg, target, seed, counts,
                   pixel_idx, 3 * cfg.num_pixels)


def sample_vjp(leaves, scene, camera, cfg, cot, sample_idx, pixel_idx=None,
               seed=None, counts=None):
    """(None, grads, [segments run], [tail flag]): the overlapped train
    step's program, ``autograd.grad(sample, leaves, grad_outputs=cot)`` of
    sample ``sample_idx`` (an int or a 0-d integer tensor) over the lanes
    ``pixel_idx``, with ``leaves`` put in place by ``set_params``; the
    gradients keyed like ``leaves``. ``counts`` as ``sampled_loss``'s, of
    length 1."""
    with torch.enable_grad():
        s, c = set_params(scene, camera, leaves)
        radiance, run, tail = run_segments(
            SamplePlan(s, c, cfg, sample_idx, seed, pixel_idx,
                       cfg.resolved_remat()),
            None if counts is None else counts[0])
        with observability.device_span("pbr.backward", radiance.is_cuda):
            grads = torch.autograd.grad(radiance, list(leaves.values()),
                                        grad_outputs=cot, allow_unused=True)
    return None, _dense(leaves, grads), [run], [tail]


def eager_loss_and_grad(params, scene, camera, cfg, target, seed=None):
    """``loss_and_grad`` run eagerly, on any device. ``params`` are taken
    as fresh leaves; the tensors passed in are not modified."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    return fwd_bwd(leaves, scene, camera, cfg, target, seed)[:2]


def loss_and_grad(params, scene, camera, cfg, target, seed=None):
    """(loss, grads): the loss as a detached scalar tensor and a dict of
    gradients keyed like ``params``, fresh tensors; the tensors passed in
    are not modified. On a CUDA scene by the captured fwd+bwd
    (``engine.compiled.GRADS``), elsewhere eagerly
    (``eager_loss_and_grad``); ``seed`` may be an int or a 0-d integer
    tensor."""
    if scene.device.type == "cuda":
        from ..engine.compiled import GRADS
        return GRADS.loss_and_grad(params, scene, camera, cfg, target, seed)
    return eager_loss_and_grad(params, scene, camera, cfg, target, seed)


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
