"""Runs over several processes and hosts, as
``pbrpathtracer_tpu.dist.multihost``.

One process per device, joined by ``torch.distributed``:

  * ranks ordered (host, local rank), as ``torchrun`` numbers them, so each
    host owns a contiguous block of the mesh;
  * the (pixel x sample) wavefront sharded over both axes, host-major: every
    host renders a contiguous stripe of the image and each of its devices a
    sub-stripe;
  * the scene (triangles, BVH, materials, textures) replicated per device;
  * parameter gradients summed over the whole mesh in one all-reduce per
    step;
  * the image assembled on every rank by one all-gather.

A forward render needs no communication until that gather. Tested without a
cluster by two and four CPU processes over gloo on one machine
(``tests/test_torch_multihost.py``).

Several processes are started as ``torchrun`` starts them: each with
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and, on hosts of
several devices, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` in its environment.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..parallel.mesh import (Mesh, all_gather_rows, broadcast_params,
                             local_shard, make_mesh, pad_to_devices)
from ..parallel.render import (mesh_for, make_train_step, padded_pixels,
                               render_local)

HOST_AXIS = "host"
DEVICE_AXIS = "device"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               init_method: str | None = None, timeout_s: float = 60,
               device=None) -> tuple[int, int]:
    """Join the job; returns (rank, world size). Call once per process.

    Arguments fall back to torch's own environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the coordinator (``"host:port"``), ``WORLD_SIZE``,
    ``RANK``. ``init_method`` takes any torch rendezvous URL instead, for
    instance a ``file://`` store. ``device`` is this process's device:
    by default the CUDA device ``LOCAL_RANK`` (0 when unset), which is made
    current; name ``"cpu"`` for the CPU. ``backend`` defaults to "nccl" for
    a CUDA device and to "gloo" for the CPU. Every collective of the group
    gives up after ``timeout_s`` seconds.
    """
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(
        backend=backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_rank(), dist.get_world_size()


def host_device_mesh(group=None, device=None) -> Mesh:
    """The ("host", "device") mesh over the initialised group: the pixel
    dimension is sharded by rank, and ranks are numbered host-major, so the
    host boundary falls between stripes. ``mesh_shape(mesh)`` gives its
    extent along both axes."""
    mesh = make_mesh(group, device)
    mesh_shape(mesh)    # (raises on uneven hosts)
    return mesh


def mesh_shape(mesh: Mesh) -> tuple[int, int]:
    """(hosts, devices per host) from ``LOCAL_WORLD_SIZE``; one host when it
    is unset."""
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.world_size))
    if per_host < 1 or mesh.world_size % per_host:
        raise ValueError(f"{mesh.world_size} ranks in hosts of {per_host}: "
                         "uneven devices per host are not supported")
    return mesh.world_size // per_host, per_host


def wavefront_sharding(x, mesh: Mesh):
    """This rank's rows of a ``[n_pad, ...]`` tensor, sharded host-major
    over both mesh axes."""
    return local_shard(x, mesh)


def replicated(params: dict, mesh: Mesh) -> dict:
    """``params`` as replicated state: rank 0's values on every rank."""
    return broadcast_params(params, mesh)


def render_multihost(scene, camera, cfg, mesh: Mesh | None = None, seed=None,
                     gather: bool = True):
    """Forward render with the wavefront sharded across hosts and devices,
    in scanline order.

    Every rank computes only its stripe. With ``gather`` (the default) the
    whole f32[H, W, 3] image is assembled on every rank by one all-gather
    (rank 0 uses it; others may drop it); without, this rank's rows
    f32[n_pad / world, 3] come back, for callers that go on working on the
    shard (``local_pixel_slice`` says which pixels they are).
    """
    mesh = host_device_mesh(device=scene.device) if mesh is None \
        else mesh_for(scene, mesh)
    n_pix = cfg.width * cfg.height
    shard = local_shard(padded_pixels(n_pix, mesh), mesh)
    local = render_local(scene, camera, cfg, shard, seed)
    if not gather:
        return local
    return all_gather_rows(local, mesh)[:n_pix].reshape(cfg.height,
                                                        cfg.width, 3)


def make_train_step_multihost(scene, camera, cfg, optimizer,
                              mesh: Mesh | None = None):
    """The sharded inverse-rendering step over the ("host", "device") mesh:
    the contract of ``parallel.render.make_train_step``."""
    if mesh is None:
        mesh = host_device_mesh(device=scene.device)
    return make_train_step(scene, camera, cfg, optimizer, mesh)


def local_pixel_slice(cfg, mesh: Mesh | None = None) -> slice:
    """The contiguous global pixel range owned by this process."""
    if mesh is None:
        mesh = host_device_mesh()
    n_pix = cfg.width * cfg.height
    per = pad_to_devices(n_pix, mesh.world_size) // mesh.world_size
    lo = mesh.rank * per
    return slice(lo, min(lo + per, n_pix))
