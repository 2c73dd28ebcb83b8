"""The fused forward shading segment: the launchers of ``csrc/shade.cu``'s
kernels S1, S2 and S3, which ``ops/shade.shade_segment`` runs around K2 and
the shadow query on a CUDA scene that records no autograd graph.

Replaces no TPU kernel (the JAX package leaves shading to XLA). Their plain
torch version is ``ops.shade.shade_plain``, the chain they reproduce bit
for bit on the card; it is also the CPU path and the path of every call
that records a graph. Nothing here runs on the CPU: a CPU tensor raises.

The three kernels take one argument struct, ``ShadeArgs`` (its fields in
``_ARGS``'s order, each 8 bytes wide); ``launch`` fills it from keyword
arguments (tensors, None for a null pointer, ints) and launches one kernel on
the current stream. Each launch counts under its kernel's name
(``shade_s1``, ``shade_s2``, ``shade_s3``) in the program's count table, and
is recorded for ``utils.roofline`` while ``record_launches`` is open.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import observability
from . import native

# csrc/shade.cu's ShadeArgs, in order: pointers, then 64-bit integers.
_POINTERS = (
    "ro", "rd", "tp", "rad", "alive", "inside", "itr", "depth", "pixel",
    "hit", "t", "bu", "bv", "tri", "light", "texels", "tex_size",
    "seed_ptr", "sample_ptr", "sh_hit", "sh_idx",
    "rows", "lid", "ro_out", "rd_out", "tp_out", "rad_out", "alive_out",
    "inside_out", "itr_out", "depth_out", "p_sh", "l_sh", "sh_alive",
    "rad_vis")
_INTS = ("n", "seed_val", "sample_val", "seed_bytes", "sample_bytes", "ctr",
         "n_lights", "max_depth", "tex_ph", "tex_pw", "n_texels", "flags")
_ARGS = _POINTERS + _INTS

# ShadeArgs.flags
TEXTURED, GGX, RR_REWEIGHT, NEE_PHYSICAL = 1, 2, 4, 8


class ShadeArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_longlong) for k in _INTS])


def word(x):
    """(pointer, bytes, value) of an RNG key word: a 0-d int32 or int64
    tensor on the card is read through its pointer by every launch (a
    replay reads its new value); a Python int, or a CPU tensor, is passed by
    value."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        if x.numel() != 1:
            raise ValueError(f"an RNG word must be one value, got "
                             f"{tuple(x.shape)}")
        if x.dtype not in (torch.int32, torch.int64):
            x = x.to(torch.int64)
        return x, x.element_size(), 0
    return None, 0, int(x)


def launch(kernel: str, **kw) -> None:
    """One launch of ``pbr_shade_s1``, ``_s2`` or ``_s3`` with the struct
    filled from ``kw``: a tensor gives its pointer (it must lie on the
    card), None a null pointer, an int its value; a field not given is 0."""
    args = ShadeArgs()
    device = None
    for k, v in kw.items():
        if isinstance(v, torch.Tensor):
            if not v.is_cuda:
                raise ValueError(f"{kernel}: {k} on {v.device}, not the card")
            device = v.get_device()
            v = v.data_ptr()
        setattr(args, k, v)
    err = getattr(native.load(), kernel)(
        ctypes.addressof(args), torch._C._cuda_getCurrentRawStream(device))
    native.check(err, kernel)
    name = kernel.removeprefix("pbr_")
    observability.count(name)
    if native.launch_records is not None:
        # the shadow mask that S2 writes, read when the launch is priced
        native.launch_records.append((name, {
            "n": args.n, "alive": kw["alive"], "hit": kw["hit"],
            "cast": kw.get("sh_alive") if name != "shade_s1" else None,
            "lights": args.n_lights > 0,
            "textured": bool(args.flags & TEXTURED)}))
