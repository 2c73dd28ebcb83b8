"""Inverse-rendering optimization loop, as ``pbrpathtracer_tpu.diff.fit``:
Adam on the dict of differentiable parameters.

Checkpoint/resume: parameters, optimizer state, the absolute step and the
loss history are saved together, and a resume is trajectory-exact: each
step renders with seed ``cfg.seed + step``, so an interrupted fit continues
on the same gradients bit for bit (on a CUDA card, under
``torch.use_deterministic_algorithms(True)``, which makes the index
backward of the material join deterministic).

The checkpoint keeps the JAX package's npz layout, so a fit checkpointed by
the JAX package resumes here: ``step``, ``losses``,
``n_p``, ``n_o``, the parameters ``p{i}`` in sorted-key order, then the
optimizer state ``o{i}`` in the leaf order of optax's ``ScaleByAdamState``:
the step count (int32), the first moments, the second moments.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .loss import l2_image_loss
from .params import clip_params, get_params, set_params


@dataclasses.dataclass
class FitResult:
    params: dict
    losses: list
    scene: object
    camera: object


def save_fit_checkpoint(path: str, params: dict, opt, step: int, losses):
    """Write (params, Adam state, absolute step, loss history) to ``path``
    (npz). ``opt`` is the torch Adam, after at least one step, whose
    parameters are ``params``' values in sorted-key order."""
    leaves = [params[k] for k in sorted(params)]
    states = [opt.state[p] for p in leaves]
    o_leaves = [np.int32(int(states[0]["step"]))] + [
        s[m].detach().cpu().numpy()
        for m in ("exp_avg", "exp_avg_sq") for s in states]
    payload = {f"p{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)}
    payload.update({f"o{i}": x for i, x in enumerate(o_leaves)})
    np.savez(path, step=step, losses=np.asarray(losses, np.float64),
             n_p=len(leaves), n_o=len(o_leaves), **payload)


def load_fit_checkpoint(path: str, params: dict, opt):
    """Restore a checkpoint into ``params`` (in place, keys as saved) and
    the torch Adam ``opt`` over them. Returns (step, losses)."""
    data = np.load(path)
    keys = sorted(params)
    n_p, n_o = int(data["n_p"]), int(data["n_o"])
    if n_p != len(keys) or n_o != 1 + 2 * len(keys):
        raise ValueError("checkpoint does not match the params/optimizer "
                         f"spec: {n_p} params and {n_o} optimizer leaves")
    count = int(data["o0"])
    with torch.no_grad():
        for i, k in enumerate(keys):
            p = params[k]
            p.copy_(torch.from_numpy(data[f"p{i}"]))
            if count:
                mu = data[f"o{1 + i}"]
                nu = data[f"o{1 + len(keys) + i}"]
                opt.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.from_numpy(mu).to(p.device),
                    "exp_avg_sq": torch.from_numpy(nu).to(p.device),
                }
    return int(data["step"]), [float(x) for x in data["losses"]]


def fit(scene, camera, cfg, target, *, steps=100, lr=2e-2,
        materials=True, textures=False, camera_lens=False,
        sample_offset_per_step=True, callback=None,
        checkpoint_path=None, checkpoint_every=0, resume=False):
    """Fit the selected scene/camera parameters to a target image with
    ``torch.optim.Adam(lr)`` (whose defaults match ``optax.adam``), clipping
    them into their physical ranges after each step.

    ``sample_offset_per_step`` re-seeds each step (``cfg.seed + step``), so
    the optimizer sees fresh Monte Carlo noise. ``checkpoint_path`` with
    ``checkpoint_every=k`` writes a checkpoint every k steps; ``resume=True``
    restores it, if present, and continues from its absolute step.
    """
    start = get_params(scene, camera, materials=materials,
                       textures=textures, camera_lens=camera_lens)
    params = {k: start[k].detach().clone().requires_grad_(True)
              for k in sorted(start)}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    start_step, losses = 0, []
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        start_step, losses = load_fit_checkpoint(checkpoint_path, params, opt)

    for s in range(start_step, steps):
        seed = cfg.seed + (s if sample_offset_per_step else 0)
        opt.zero_grad(set_to_none=True)
        loss = l2_image_loss(params, scene, camera, cfg, target, seed=seed)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for k, v in clip_params(params).items():
                params[k].copy_(v)
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(s, losses[-1], params)
        if (checkpoint_path and checkpoint_every
                and (s + 1) % checkpoint_every == 0):
            save_fit_checkpoint(checkpoint_path, params, opt, s + 1, losses)

    final = {k: v.detach() for k, v in params.items()}
    final_scene, final_camera = set_params(scene, camera, final)
    return FitResult(params=final, losses=losses, scene=final_scene,
                     camera=final_camera)
