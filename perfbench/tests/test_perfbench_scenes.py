"""The frozen scene builders of ``perfbench/configs`` equal the program's
builders, leaf for leaf, once the program has packed them."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import program, specs
from pbrpathtracer_tpu_torch.scene import big_scenes, builders


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), f.name


def _scenes_equal(ours, theirs):
    for part in ("geom", "materials", "textures"):
        _assert_same(getattr(ours, part), getattr(theirs, part))
    assert torch.equal(ours.lights, theirs.lights)
    for flag in ("has_opacity_tex", "has_any_texture", "has_translucent"):
        assert getattr(ours, flag) == getattr(theirs, flag)


def test_cornell_equals_the_program_builder():
    spec, builder = specs.config("cornell")
    ours = program.scene(builder.build(spec, 123), "cpu")
    _scenes_equal(ours, builders.cornell_box(device="cpu"))
    assert ours.num_triangles == spec["triangles"]


@pytest.mark.parametrize("n_tris, seed", [(5000, 0), (5000, 2 ** 31 + 17)])
def test_mesh_equals_the_program_builder(n_tris, seed):
    spec, builder = specs.config("mesh50k")
    spec = {**spec, "n_tris": n_tris}
    ours = program.scene(builder.build(spec, seed), "cpu")
    theirs = big_scenes.mesh_scene(n_tris, seed=seed % 2 ** 32,
                                   device="cpu")
    _scenes_equal(ours, theirs)
    assert torch.equal(ours.accel.perm, theirs.accel.perm)


def test_mesh50k_triangle_count():
    spec, builder = specs.config("mesh50k")
    arrays = builder.build(spec, 0)
    assert arrays["tris"]["v0"].shape[0] == spec["triangles"]
    assert np.all(np.asarray(arrays["tris"]["mat_id"]) <= 2)
