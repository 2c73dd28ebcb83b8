"""Live-lane wavefront compaction, as ``pbrpathtracer_tpu.ops.compaction``.

Each live segment may reorder the lanes so that live ones form a prefix
and, for large scenes, so that neighbouring lanes carry coherent rays
(``coherence_key``: dead last, then direction octant, then origin Morton
code). Every random draw is keyed by (seed, pixel, sample, stream, slot),
and the pixel travels with the lane, so a compacted render equals the
uncompacted one bit for bit per pixel; ``slot`` records each lane's
original position and ``scatter_to_slots`` undoes the order at the end.

Two formulations, as in the JAX package, both a stable sort of the key:

  * "sort": the state packed into one f32 block (integer and boolean
    columns bit-cast), moved by one row gather, unpacked;
  * "gather": one gather per state column.

Keys are int32, with the JAX package's bit layout.
"""

from __future__ import annotations

import dataclasses

import torch

DEAD_KEY = 2 ** 31 - 1


def _spread3(x):
    """Interleave 8-bit x into every 3rd bit (Morton spread, int32)."""
    x = x & 0xFF
    x = (x | (x << 8)) & 0x00F00F
    x = (x | (x << 4)) & 0x0C30C3
    x = (x | (x << 2)) & 0x249249
    return x


def scene_bounds(scene):
    """(lo, hi) f32[3] of the scene's vertices, cached on its geometry."""
    g = scene.geom
    cached = getattr(g, "_bounds", None)
    if cached is None:
        v0, v1, v2 = g.vertices()
        cached = (torch.minimum(torch.minimum(v0, v1), v2).amin(dim=0),
                  torch.maximum(torch.maximum(v0, v1), v2).amax(dim=0))
        object.__setattr__(g, "_bounds", cached)
    return cached


def coherence_key(state, scene):
    """int32 lane key: dead lanes last; live lanes by (direction octant,
    origin Morton code over the scene's bounding box)."""
    lo, hi = scene_bounds(scene)
    rd, ro = state.rd.detach(), state.ro.detach()
    oct_ = ((rd[:, 0] > 0).to(torch.int32)
            | ((rd[:, 1] > 0).to(torch.int32) << 1)
            | ((rd[:, 2] > 0).to(torch.int32) << 2))
    scale = 255.0 / torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((ro - lo) * scale, 0.0, 255.0).to(torch.int32)
    morton = ((_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1)
              | _spread3(q[:, 2]))
    key = (oct_ << 24) | morton
    return torch.where(state.alive, key, DEAD_KEY)


def _order(state, key):
    if key is None:
        key = (~state.alive).to(torch.int32)
    return torch.sort(key, stable=True).indices


_FLOAT_COLUMNS = ("ro", "rd", "throughput", "radiance")
_INT_COLUMNS = ("itr", "depth", "pixel")
_BOOL_COLUMNS = ("alive", "inside")


def compact_sort(state, slot, key=None):
    """Reorder the lanes by a stable sort of ``key`` (default: the dead
    flag, live lanes first; pass ``coherence_key`` for large scenes), the
    state moved as one packed block. Returns (state, slot)."""
    order = _order(state, key)
    ints = torch.stack([getattr(state, f) for f in _INT_COLUMNS]
                       + [getattr(state, f).to(torch.int32)
                          for f in _BOOL_COLUMNS] + [slot], dim=1)
    block = torch.cat([getattr(state, f) for f in _FLOAT_COLUMNS]
                      + [ints.view(torch.float32)], dim=1)[order]
    cols, k = {}, 0
    for f in _FLOAT_COLUMNS:
        cols[f] = block[:, k:k + 3]
        k += 3
    moved = block[:, k:].detach().contiguous().view(torch.int32)
    for j, f in enumerate(_INT_COLUMNS):
        cols[f] = moved[:, j].contiguous()
    for j, f in enumerate(_BOOL_COLUMNS):
        cols[f] = moved[:, len(_INT_COLUMNS) + j] != 0
    return dataclasses.replace(state, **cols), moved[:, -1].contiguous()


def compact_gather(state, slot, key=None):
    """As ``compact_sort``, with one gather per state column."""
    order = _order(state, key)
    cols = {f.name: getattr(state, f.name)[order]
            for f in dataclasses.fields(state)}
    return dataclasses.replace(state, **cols), slot[order]


def scatter_to_slots(values, slot):
    """Undo the lane reordering: values[i] lands at its original lane
    ``slot[i]`` (slots are a permutation of arange)."""
    return torch.zeros_like(values).index_copy(0, slot.long(), values)
