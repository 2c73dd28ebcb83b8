"""Primary rays of the port against ``pbrpathtracer_tpu.ops.camera``:
allclose at atol 2e-6 (float32 trigonometry and square roots may differ by an
ULP between XLA and torch), pinhole and thin lens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrpathtracer_tpu.ops.camera import generate_rays as jgen
from pbrpathtracer_tpu.scene.scene import Camera as JCamera
from pbrpathtracer_tpu_torch.ops.camera import generate_rays
from pbrpathtracer_tpu_torch.scene.scene import Camera

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)


@pytest.mark.parametrize("lens", [{}, dict(focal_dist=2.5, aperture=0.05),
                                  dict(focal_dist=1.0, aperture=0.3)])
@pytest.mark.parametrize("width,height,seed,sample", [
    (16, 12, 0, 0), (7, 9, 3, 5), (32, 32, 2 ** 32 - 1, 2 ** 31)])
def test_rays_match_jax(lens, width, height, seed, sample):
    jr = jax.jit(lambda: jgen(JCamera.make(**POSE, **lens), width, height,
                              jnp.uint32(seed), jnp.uint32(sample)))()
    pr = generate_rays(Camera.make(**POSE, **lens), width, height, seed,
                       sample)
    for a, b in zip(jr, pr):
        assert b.shape == (width * height, 3) and b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-6)


def test_pixel_subset_matches_full_image():
    rs = np.random.RandomState(0)
    sub = np.sort(rs.choice(20 * 10, 37, replace=False)).astype(np.int32)
    cam = Camera.make(**POSE, focal_dist=2.0, aperture=0.1)
    full = generate_rays(cam, 20, 10, 1, 2)
    part = generate_rays(cam, 20, 10, 1, 2, torch.tensor(sub))
    for f, p in zip(full, part):
        torch.testing.assert_close(p, f[torch.tensor(sub).long()], rtol=0,
                                   atol=0)
