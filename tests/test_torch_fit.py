"""The port's ``fit`` on the CPU: recovery of a perturbed albedo, a
bit-exact checkpoint resume, and agreement with the JAX package's ``fit``
(optax Adam) -- one step from the same start at atol 1e-6, and a JAX
checkpoint written after 3 steps, resumed by the port to 6, against the
JAX 6-step parameters at atol 1e-5 (Adam's update divides by the root of
the second moment, so float noise in a small gradient moves a parameter by
up to ~lr times its relative size)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.diff.fit import fit as j_fit
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.scene import builders as jb
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu_torch import RenderConfig, fit, render, set_params
from pbrpathtracer_tpu_torch.bridge import from_reference
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
CAM = Camera.make(**POSE)


def test_fit_recovers_perturbed_albedo():
    """tests/test_diff.py's case: the red wall's diffuse perturbed to
    (0.4, 0.5, 0.5) and fitted back with a fixed seed (the target's own
    Monte Carlo noise), 12x12, 40 steps."""
    scene = pb.cornell_box()
    cfg = RenderConfig(width=12, height=12, max_depth=2, spp=2, seed=3)
    target = render(scene, CAM, cfg)
    true = scene.materials.diffuse.clone()
    perturbed = true.clone()
    perturbed[1] = torch.tensor([0.4, 0.5, 0.5])
    scene_p, _ = set_params(scene, CAM, {"mat.diffuse": perturbed})
    res = fit(scene_p, CAM, cfg, target, steps=40, lr=4e-2,
              sample_offset_per_step=False)
    assert res.losses[-1] < res.losses[0] * 0.15, res.losses[::10]
    rec = res.params["mat.diffuse"][1]
    assert (rec - true[1]).abs().max() < 0.15, rec


def test_fit_checkpoint_resume_bitexact(tmp_path):
    """Interrupting a fit at step 3 and resuming reproduces the
    uninterrupted 6-step trajectory bit for bit."""
    scene = pb.cornell_box()
    cfg = RenderConfig(width=8, height=8, max_depth=2, spp=1, seed=7)
    target = torch.zeros((8, 8, 3))
    ckpt = str(tmp_path / "fit.npz")
    full = fit(scene, CAM, cfg, target, steps=6, lr=3e-2)
    fit(scene, CAM, cfg, target, steps=3, lr=3e-2, checkpoint_path=ckpt,
        checkpoint_every=3)
    resumed = fit(scene, CAM, cfg, target, steps=6, lr=3e-2,
                  checkpoint_path=ckpt, resume=True)
    assert len(resumed.losses) == 6
    assert resumed.losses == full.losses
    for k in full.params:
        assert torch.equal(full.params[k], resumed.params[k]), k


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """One JAX fit of 6 steps (tests/test_diff.py's resume config), with
    its parameters after step 1 and its checkpoint after step 3."""
    tmp = tmp_path_factory.mktemp("jfit")
    ckpt, at3 = str(tmp / "fit.npz"), str(tmp / "fit3.npz")
    after = {}

    def callback(s, loss, params):
        if s == 0:
            after[1] = {k: np.asarray(v) for k, v in params.items()}
        if s == 3:   # the step-3 checkpoint is on disk until step 6
            shutil.copy(ckpt, at3)

    js = jb.cornell_box()
    jcam = JCamera.make(**POSE)
    cfg = dict(width=8, height=8, max_depth=2, spp=1, seed=7)
    res = j_fit(js, jcam, JConfig(**cfg), jnp.zeros((8, 8, 3), jnp.float32),
                steps=6, lr=3e-2, checkpoint_path=ckpt, checkpoint_every=3,
                callback=callback)
    ps, pcam = from_reference(js, jcam)
    return dict(scene=ps, camera=pcam, cfg=RenderConfig(**cfg), ckpt=at3,
                after1=after[1], losses=res.losses,
                final={k: np.asarray(v) for k, v in res.params.items()})


def test_one_step_matches_jax_fit(jax_fit):
    res = fit(jax_fit["scene"], jax_fit["camera"], jax_fit["cfg"],
              torch.zeros((8, 8, 3)), steps=1, lr=3e-2)
    assert sorted(res.params) == sorted(jax_fit["after1"])
    np.testing.assert_allclose(res.losses[0], jax_fit["losses"][0],
                               rtol=1e-5)
    for k, v in res.params.items():
        np.testing.assert_allclose(v.numpy(), jax_fit["after1"][k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_port_resumes_a_jax_checkpoint(jax_fit, tmp_path):
    ckpt = str(tmp_path / "fit.npz")
    shutil.copy(jax_fit["ckpt"], ckpt)
    res = fit(jax_fit["scene"], jax_fit["camera"], jax_fit["cfg"],
              torch.zeros((8, 8, 3)), steps=6, lr=3e-2, checkpoint_path=ckpt,
              resume=True)
    assert res.losses[:3] == jax_fit["losses"][:3]
    np.testing.assert_allclose(res.losses[3:], jax_fit["losses"][3:],
                               rtol=1e-5)
    for k, v in res.params.items():
        np.testing.assert_allclose(v.numpy(), jax_fit["final"][k], rtol=0,
                                   atol=1e-5, err_msg=k)
