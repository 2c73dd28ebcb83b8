"""Worker process for tests/test_torch_multihost.py.

Usage: python _torch_multihost_worker.py <rank> <world> <store file> <outdir>

Joins a gloo group on the CPU through a ``file://`` store (no port to
collide with another test), renders the Cornell box with
``render_multihost`` (gathered, and as the local shard), takes one fused and
one overlapped training step, and writes what it got to
``<outdir>/p<rank>.npz`` for the parent test to compare. Every collective
gives up after 60 s, so a worker whose peer died exits non-zero instead of
waiting.
"""

import functools
import logging
import os
import sys


def main():
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import numpy as np
    import torch
    torch.set_num_threads(1)

    from pbrpathtracer_tpu_torch import RenderConfig, get_params
    from pbrpathtracer_tpu_torch.dist import multihost as mh
    from pbrpathtracer_tpu_torch.parallel.render import (
        make_train_step_overlapped)
    from pbrpathtracer_tpu_torch.scene import builders
    from pbrpathtracer_tpu_torch.scene.scene import Camera
    from pbrpathtracer_tpu_torch.utils import observability as obs

    got = mh.initialize(init_method=f"file://{store}", num_processes=world,
                        process_id=rank, device="cpu", timeout_s=60)
    assert got == (rank, world), got

    scene = builders.cornell_box(device="cpu")
    cam = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                      up=(0, 1, 0), fovy=61)
    cfg = RenderConfig(width=16, height=16, max_depth=2, spp=2, seed=4)
    mesh = mh.host_device_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size) == (rank, world)
    assert mh.mesh_shape(mesh) == (1, world)

    # ---- forward render: gathered everywhere, and the local shard ----
    img = mh.render_multihost(scene, cam, cfg, mesh=mesh)
    local = mh.render_multihost(scene, cam, cfg, mesh=mesh, gather=False)
    sl = mh.local_pixel_slice(cfg, mesh)

    # ---- one fused and one overlapped step, from rank 0's parameters ----
    n_pix = cfg.num_pixels
    pix = mh.wavefront_sharding(torch.arange(n_pix, dtype=torch.int32), mesh)
    target = mh.wavefront_sharding(torch.full((n_pix, 3), 0.25), mesh)
    start = get_params(scene, cam, materials=True)
    if rank:    # only rank 0's values may count
        start = {k: v + 0.125 * rank for k, v in start.items()}
    out = {}
    for name, make, c in (
            ("fused", mh.make_train_step_multihost, cfg.replace(spp=1)),
            ("over", make_train_step_overlapped, cfg)):
        params = mh.replicated(start, mesh)
        step = make(scene, cam, c,
                    functools.partial(torch.optim.Adam, lr=1e-2), mesh)
        out[f"{name}_loss"] = float(step(params, pix, target, 0))
        out[f"{name}_diffuse"] = params["mat.diffuse"].detach().numpy()

    # ---- rank-0-only logging on a real group ----
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    obs.logger.addHandler(handler)
    obs.logger.setLevel(logging.INFO)
    obs.log_event("worker", rank=rank)

    np.savez(os.path.join(outdir, f"p{rank}.npz"), img=img.numpy(),
             local=local.numpy(), lo=sl.start, hi=sl.stop,
             host0=obs.is_host0(), logged=len(records), **out)
    torch.distributed.destroy_process_group()
    print(f"worker {rank}: OK", flush=True)


if __name__ == "__main__":
    main()
