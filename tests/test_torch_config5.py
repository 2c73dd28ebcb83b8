"""BASELINE config 5's sharded fit (benchmarks/ladder.py, rung 5) at toy
size, through the JAX package's ``make_train_step`` on the virtual 8-device
CPU mesh and through the port's on the one-process mesh: the same scene,
start, target and seeds, made once and handed to both."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu.diff.params import get_params as j_get_params
from pbrpathtracer_tpu.engine.config import RenderConfig as JConfig
from pbrpathtracer_tpu.parallel import mesh as jmesh
from pbrpathtracer_tpu.parallel import render as jrender
from pbrpathtracer_tpu.scene.big_scenes import (
    mesh_scene as j_mesh_scene, mesh_scene_camera as j_mesh_camera)
from pbrpathtracer_tpu_torch import RenderConfig, bridge
from pbrpathtracer_tpu_torch.parallel.mesh import broadcast_params, make_mesh
from pbrpathtracer_tpu_torch.parallel.render import (make_train_step,
                                                     render_sharded)

from_reference = functools.partial(bridge.from_reference, device="cpu")


def test_config5_fit_follows_the_jax_fit():
    """BASELINE config 5's fit (benchmarks/ladder.py, rung 5) at toy size:
    diffuse x 0.6 and emissive intensity x 1.5, Adam 3e-2, seed ``s % 4``,
    six fused steps on a 1200-triangle textured ``mesh_scene``. The port's
    losses and parameters follow the JAX step's, step for step, and so does
    the ladder's recovery error (which on this scene does not fall in so
    few steps, in either package: two of the three materials emit nothing
    and the terrain's diffuse is textured over, so they have no gradient)."""
    js, jcam = j_mesh_scene(1200, textured=True, tex_size=64), j_mesh_camera()
    kw = dict(width=16, height=16, max_depth=2, spp=1)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jm = jmesh.make_mesh(jax.devices("cpu")[:8])
    shard, rep = jmesh.ray_sharding(jm), jmesh.replicated(jm)
    true = j_get_params(js, jcam, materials=True)
    start = dict(true)
    start["mat.diffuse"] = true["mat.diffuse"] * 0.6
    start["mat.emissive_intensity"] = true["mat.emissive_intensity"] * 1.5
    target = np.asarray(jrender.render_sharded(js, jcam, jcfg, mesh=jm))
    pix = np.arange(cfg.num_pixels, dtype=np.int32)

    def recovery(p):
        return float(sum(np.abs(np.asarray(p[k]) - np.asarray(true[k])).mean()
                         for k in ("mat.diffuse", "mat.emissive_intensity")))

    jopt = optax.adam(3e-2)
    jstep = jrender.make_train_step(js, jcam, jcfg, jopt, jm)
    jp = jax.device_put(start, rep)
    jo = jax.device_put(jopt.init(start), rep)
    jpix = jax.device_put(jnp.asarray(pix), shard)
    jtarget = jax.device_put(jnp.asarray(target.reshape(-1, 3)), shard)
    jlosses = []
    for s in range(6):
        jp, jo, loss = jstep(jp, jo, js, jcam, jpix, jtarget,
                             jnp.uint32(s % 4))
        jlosses.append(float(loss))

    scene, cam = from_reference(js, jcam)
    mesh = make_mesh(device="cpu")
    np.testing.assert_allclose(
        render_sharded(scene, cam, cfg, mesh=mesh).numpy(), target, atol=1e-5)
    params = broadcast_params(
        bridge.params_from_reference(start, device="cpu"), mesh)
    step = make_train_step(scene, cam, cfg,
                           functools.partial(torch.optim.Adam, lr=3e-2), mesh)
    losses = [float(step(params, torch.tensor(pix),
                         torch.tensor(target.reshape(-1, 3)), s % 4))
              for s in range(6)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-6)
    final = {k: v.detach().numpy() for k, v in params.items()}
    for k in final:
        np.testing.assert_allclose(final[k], np.asarray(jp[k]), atol=2e-3,
                                   err_msg=k)
    assert abs(recovery(final) - recovery(jp)) < 2e-3
    assert recovery(jp) > 0.9 * recovery(start)     # (not recovered yet)
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
