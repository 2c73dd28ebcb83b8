"""The port's multi-process layer (``dist/multihost.py``), the mirror of
tests/test_multihost.py: worlds of 2 and 4 real OS processes, joined over
gloo on the CPU through a ``file://`` store, must produce the same image, bit
for bit, as a single-process render (the keyed RNG makes the sharding
invisible), and identical replicated state on every rank.

Every wait has a limit: the group's collectives 60 s, the workers 120 s.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu_torch import RenderConfig, get_params, render
from pbrpathtracer_tpu_torch.parallel.mesh import broadcast_params, make_mesh
from pbrpathtracer_tpu_torch.parallel.render import (
    make_train_step, make_train_step_overlapped)
from pbrpathtracer_tpu_torch.scene import builders as pb
from pbrpathtracer_tpu_torch.scene.scene import Camera

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_multihost_worker.py")
WORKER_LIMIT_S = 120
CAM = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                  up=(0, 1, 0), fovy=61)
CFG = RenderConfig(width=16, height=16, max_depth=2, spp=2, seed=4)


@pytest.fixture(scope="module", params=[2, 4])
def workers(request, tmp_path_factory):
    world = request.param
    outdir = tmp_path_factory.mktemp(f"mh{world}")
    store = outdir / "store"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(rank), str(world), str(store),
         str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=WORKER_LIMIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
    return world, [np.load(outdir / f"p{rank}.npz") for rank in range(world)]


def test_multihost_render_bitexact_vs_single_process(workers):
    _, results = workers
    ref = render(pb.cornell_box(device="cpu"), CAM, CFG).numpy()
    for r in results:
        assert r["img"].shape == ref.shape
        assert np.array_equal(r["img"], ref)


def test_multihost_processes_agree(workers):
    """The gathered image and both steps' results are identical on every
    rank: replicated state never diverges, though each rank started from
    other parameters than rank 0's."""
    _, results = workers
    for r in results[1:]:
        for key in ("img", "fused_loss", "fused_diffuse", "over_loss",
                    "over_diffuse"):
            assert np.array_equal(results[0][key], r[key]), key


@pytest.mark.parametrize("name,make,spp", [
    ("fused", make_train_step, 1), ("over", make_train_step_overlapped, 2)])
def test_multihost_steps_equal_the_one_rank_step(workers, name, make, spp):
    _, results = workers
    scene = pb.cornell_box(device="cpu")
    cfg = CFG.replace(spp=spp)
    mesh = make_mesh(device="cpu")
    assert mesh.world_size == 1
    params = broadcast_params(get_params(scene, CAM), mesh)
    step = make(scene, CAM, cfg,
                functools.partial(torch.optim.Adam, lr=1e-2), mesh)
    loss = float(step(params, torch.arange(cfg.num_pixels, dtype=torch.int32),
                      torch.full((cfg.num_pixels, 3), 0.25), 0))
    assert np.isfinite(loss)
    assert abs(loss - float(results[0][f"{name}_loss"])) < 1e-5
    assert np.allclose(params["mat.diffuse"].detach().numpy(),
                       results[0][f"{name}_diffuse"], atol=1e-5)
    assert not np.array_equal(results[0][f"{name}_diffuse"],
                              scene.materials.diffuse.numpy())


def test_multihost_local_shard_is_the_local_pixel_slice(workers):
    world, results = workers
    flat = results[0]["img"].reshape(-1, 3)
    per = CFG.num_pixels // world
    for rank, r in enumerate(results):
        assert (int(r["lo"]), int(r["hi"])) == (rank * per, (rank + 1) * per)
        assert np.array_equal(r["local"], flat[int(r["lo"]):int(r["hi"])])


def test_multihost_host0_only_logs(workers):
    _, results = workers
    assert [bool(r["host0"]) for r in results] == [True] + [False] * (
        len(results) - 1)
    assert [int(r["logged"]) for r in results] == [1] + [0] * (
        len(results) - 1)
