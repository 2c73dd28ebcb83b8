"""The reference (``perfbench/reference``) against the program's eager
program on the CPU at small sizes: one sample's radiance, the loss and its
gradients, and the closest hit against the program's plain one."""

import pytest
import torch

from perfbench.harness import program, specs
from perfbench.reference import hit, pathtracer as ref
from pbrpathtracer_tpu_torch.diff.loss import eager_loss_and_grad
from pbrpathtracer_tpu_torch.diff.params import get_params
from pbrpathtracer_tpu_torch.ops.integrator import render_sample
from pbrpathtracer_tpu_torch.ops.intersect import intersect_classic

W, H = 24, 16


def _both(name, seed, n_tris=None):
    spec, builder = specs.config(name)
    if n_tris:
        spec = {**spec, "n_tris": n_tris}
    arrays = builder.build(spec, seed)
    ours = (program.scene(arrays, "cpu"),
            program.camera(spec["camera"], "cpu"))
    theirs = (ref.build_scene(arrays, "cpu"),
              ref.make_camera(spec["camera"], "cpu"))
    return spec, ours, theirs


CASES = [("cornell", 3, None, 4), ("cornell", 2 ** 33 + 5, None, 3),
         ("mesh50k", 11, 3000, 3)]


@pytest.mark.parametrize("name, seed, n_tris, depth", CASES)
def test_sample_equals_the_program(name, seed, n_tris, depth):
    spec, (scene, cam), (rscene, rcam) = _both(name, seed, n_tris)
    cfg = program.config(dict(width=W, height=H, max_depth=depth), seed)
    rcfg = ref.Config(width=W, height=H, max_depth=depth, seed=seed)
    for sample in (0, 5):
        want = render_sample(scene, cam, cfg, sample)
        pixel = torch.arange(W * H, dtype=torch.int32)
        got = ref.Renderer(rscene, rcam, rcfg).radiance(
            pixel, torch.full((W * H,), sample, dtype=torch.int64))
        assert torch.equal(got, want)


def test_accumulated_passes_equal_the_program():
    spec, (scene, cam), (rscene, rcam) = _both("cornell", 9)
    cfg = program.config(dict(width=W, height=H, max_depth=3), 9)
    acc = torch.zeros((W * H, 3))
    for k in range(4):
        acc = acc + render_sample(scene, cam, cfg, k)
    pixels = torch.tensor([0, 7, 100, W * H - 1], dtype=torch.int32)
    got = ref.accumulate_passes(rscene, rcam, ref.Config(W, H, 3, 9), pixels,
                                4, block=8)
    assert torch.equal(got, acc[pixels.long()])


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("name, seed, n_tris, depth", CASES)
def test_loss_and_grad_equal_the_program(name, seed, n_tris, depth, spp):
    spec, (scene, cam), (rscene, rcam) = _both(name, seed, n_tris)
    which = spec["fit"]
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(1))
    cfg = program.config(dict(width=W, height=H, max_depth=depth, spp=spp),
                         seed)
    params = get_params(scene, cam, materials=which["materials"],
                        textures=which["textures"])
    loss, grads = eager_loss_and_grad(params, scene, cam, cfg, target)
    rparams = ref.fit_params(rscene, which["materials"], which["textures"])
    rloss, rgrads = ref.loss_and_grad(
        rscene, rcam, ref.Config(W, H, depth, seed, spp), target, rparams)
    assert set(rgrads) == set(grads)
    torch.testing.assert_close(rloss, loss, rtol=1e-6, atol=0)
    for k in grads:
        torch.testing.assert_close(rgrads[k], grads[k], rtol=1e-5,
                                   atol=1e-7)


def test_closest_hit_equals_the_program_plain_one():
    spec, (scene, _), (rscene, _) = _both("mesh50k", 4, 3000)
    g = torch.Generator().manual_seed(0)
    n = 4000
    ro = torch.rand((n, 3), generator=g) * torch.tensor([12.0, 2.0, 14.0]) \
        + torch.tensor([-6.0, -0.5, 1.0])
    rd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                       dim=1)
    t_lower = torch.where(torch.rand(n, generator=g) < 0.3,
                          torch.rand(n, generator=g), 0.0)
    alive = torch.rand(n, generator=g) < 0.9
    want = intersect_classic(scene.geom, ro, rd, t_lower, alive)
    got = hit.closest_hit_plain(rscene.chunks, ro, rd, t_lower, alive)
    assert int(want[0].sum()) > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fit_steps_follow_adam_and_the_clip():
    spec, _, (rscene, rcam) = _both("cornell", 1)
    target = torch.full((H, W, 3), 0.2)
    params = ref.fit_params(rscene)
    losses, grads, kept = ref.fit_steps(
        rscene, rcam, ref.Config(W, H, 4, 1), target, params, 2, 0.02, 1,
        keep_grads=(0,), keep_params=(1,))
    assert len(losses) == 2
    # Adam's first step moves each entry with a gradient by lr, then the clip
    for k, g in grads[0].items():
        moved = torch.clamp(params[k] - 0.02 * torch.sign(g),
                            *ref.RANGES.get(k, (None, None)))
        torch.testing.assert_close(kept[1][k], moved, rtol=0, atol=1e-6)


def test_the_reference_refuses_a_render_key_it_does_not_implement():
    assert ref.Config.of(dict(width=4, height=2, max_depth=3, spp=2), 7) \
        == ref.Config(4, 2, 3, 7, 2)
    with pytest.raises(ValueError, match="brdf"):
        ref.Config.of(dict(width=4, height=2, max_depth=3, brdf="ggx"), 7)
