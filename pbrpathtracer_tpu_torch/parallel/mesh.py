"""Process-mesh helpers, as ``pbrpathtracer_tpu.parallel.mesh``.

What a JAX ``Mesh`` is to ``shard_map``, a process group is to
``torch.distributed``: one process per device, the scene (triangles, BVH,
materials, textures) replicated in each, the pixel dimension of the
(pixel x sample) wavefront cut into contiguous shards by rank, and parameter
gradients all-reduced over the group. Rays are independent, so a forward
render needs no collective until the image is gathered, and a training step
needs one all-reduce.

A ``Mesh`` over no group is the one-process mesh (rank 0 of 1); it makes no
collective. Every collective of the port goes through this module, with
plain ``all_reduce`` / ``all_gather`` / ``broadcast``. A gloo group moves
host memory, so tensors on a card are staged through the host for it (chosen
by the group's backend); an NCCL group takes them where they lie.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils import observability

RAYS_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in a 1-D mesh over the pixel dimension."""

    group: object           # a torch.distributed group; None = one process
    rank: int
    world_size: int
    device: torch.device    # where this process's shard is computed

    @property
    def staged(self) -> bool:
        """Whether a collective's buffers go through host memory."""
        return (self.group is not None and self.device.type != "cpu"
                and dist.get_backend(self.group) == "gloo")


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over ``group`` (default: the initialised default group).
    With no group initialised it is the one-process mesh. ``device``
    defaults to the current CUDA device; name ``"cpu"`` for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, device)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device)


def pad_to_devices(n: int, n_dev: int) -> int:
    """Smallest multiple of n_dev >= n (pixel counts must divide evenly)."""
    return ((n + n_dev - 1) // n_dev) * n_dev


def local_shard(x, mesh: Mesh):
    """This rank's contiguous rows of a ``[n_pad, ...]`` tensor whose
    leading dimension the world size divides (a view)."""
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not divide over {mesh.world_size} "
                         "ranks; pad with pad_to_devices")
    per = n // mesh.world_size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _need_group(mesh: Mesh):
    if mesh.group is None and mesh.world_size != 1:
        raise ValueError(f"a mesh of {mesh.world_size} ranks without a "
                         "process group cannot communicate")


def broadcast_params(params: dict, mesh: Mesh) -> dict:
    """Fresh tensors on the mesh's device holding rank 0's values of
    ``params``, key for key, so that replicated state starts equal on every
    rank (one broadcast of one flat buffer)."""
    _need_group(mesh)
    keys = sorted(params)
    out = {k: params[k].detach().to(mesh.device, copy=True) for k in keys}
    if mesh.group is None or not keys:
        return out
    flat = torch.cat([out[k].reshape(-1) for k in keys])
    buf = flat.cpu() if mesh.staged else flat
    dist.broadcast(buf, src=dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    _write_back(buf.to(mesh.device), [out[k] for k in keys])
    return out


def all_gather_rows(x, mesh: Mesh):
    """Every rank's ``[n, ...]`` block concatenated in rank order, on every
    rank: one all-gather."""
    _need_group(mesh)
    if mesh.group is None:
        return x
    buf = x.cpu() if mesh.staged else x.contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(x.device)


def _write_back(flat, tensors):
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


class FlatReduce:
    """A sum over the mesh in flight. ``wait()`` ends it and writes the
    sums into the tensors it was given; calling it again does nothing."""

    def __init__(self, tensors, flat, buf, work):
        self._tensors, self._flat, self._buf, self._work = (tensors, flat,
                                                            buf, work)

    def wait(self):
        if self._tensors is None:
            return
        if self._work is not None:
            self._work.wait()
        if self._buf is not self._flat:
            self._flat.copy_(self._buf)
        if self._buf is not None:
            _write_back(self._flat, self._tensors)
        self._tensors = self._flat = self._buf = self._work = None


def all_reduce_flat(tensors, mesh: Mesh, async_op: bool = False) -> FlatReduce:
    """Sum ``tensors`` (float32, any shapes) over the mesh, in place: they
    are flattened into one buffer, reduced once, and written back. With
    ``async_op`` the reduction is left in flight and the tensors hold the
    sums only after the returned handle's ``wait()``; otherwise it has
    been waited for already.

    The calls and the bytes of their buffers are counted as
    ``all_reduces`` and ``all_reduce_bytes`` (``utils/observability.py``).
    The one-process mesh counts too, and reduces nothing."""
    _need_group(mesh)
    tensors = list(tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("all_reduce_flat sums float32 tensors")
    observability.count("all_reduces")
    observability.count("all_reduce_bytes",
                        4 * sum(t.numel() for t in tensors))
    if mesh.group is None:
        return FlatReduce(None, None, None, None)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    buf = flat.cpu() if mesh.staged else flat
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group,
                           async_op=async_op)
    handle = FlatReduce(tensors, flat, buf, work if async_op else None)
    if not async_op:
        handle.wait()
    return handle

