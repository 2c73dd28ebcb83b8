"""Speed-of-light (roofline) model for the render step on the H100, as
``pbrpathtracer_tpu.utils.roofline``.

For one step (a render, or a render and its backward) the least time the
card could take is the larger of

  * the memory bound: the bytes the step must move over the peak HBM rate;
  * the FP32 bound: its floating-point operations over the peak FP32 rate
    outside the tensor cores (the port issues no matmul that the tensor
    cores could take).

``fraction_of_roofline = t_roofline / t_measured`` is then a utilization
number: 1.0 means the step runs at the speed of light for this program on
this card.

Peaks of one NVIDIA H100 SXM5 80 GB at its 700 W limit, from NVIDIA's H100
Tensor Core GPU data sheet (dense rates): HBM3 3.35 TB/s; FP32 67 TFLOP/s.
A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load; the bound stays the published one.

What is counted:

  * The eager program (``count_program``): PyTorch has no cost analysis of
    a compiled graph, so a ``TorchDispatchMode`` watches every ATen
    operator that the step dispatches, forward and backward. Each one reads
    its tensor inputs once and writes its outputs once; a broadcast input
    counts its distinct elements. Views, metadata and allocations move
    nothing. A pointwise operator does one operation per floating output
    element, a reduction one per floating input element, a matrix product
    2 M N K. This is the traffic of the eager program, which writes every
    intermediate to memory: a fused program would move far fewer bytes.
  * The hand-written kernels K1-K4 and S1-S3: they launch through
    ``ctypes`` (``kernels/native.py``) and dispatch no operator, so each
    launch's shapes are recorded by its wrapper while ``record_launches`` is
    open, and its bytes and operations are reckoned from them (``k1_work``
    .. ``k4_work``, ``shade_work``, the same reckonings that
    ``chip_smoke.py`` holds each kernel's time against): every input read
    once, every output written once, and the operations that this launch's
    data needs. This is the counterpart of the JAX package's
    ``pallas_pair_flops``.

The model prices the work the step issues at peak rates: a utilization
measure, not a proof that less work could not do.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import native

HBM_BYTES_PER_S = 3.35e12        # H100 SXM5 HBM3
FP32_FLOPS_PER_S = 67e12         # H100 SXM5, FP32 outside the tensor cores

# FP32 operations of one Möller-Trumbore pair test and of one slab test
# (csrc/intersect.cu, csrc/bvh_intersect.cu). K4 reads a node of its wide
# tree as one 128-byte record of K4_WIDTH boxes and a triangle as a 48-byte
# row.
PAIR_OPS, SLAB_OPS = 47, 27
K4_RECORD_BYTES, K4_ROW_BYTES, K4_WIDTH = 128, 48, 4
# Bytes of one ray's inputs and outputs to a closest-hit query: origin and
# direction (24), t_lower (4), alive (1); hit, id, t, u, v (17).
RAY_IO_BYTES = 24 + 4 + 1 + 17


@dataclasses.dataclass(frozen=True)
class Roofline:
    bytes_accessed: float        # program bytes + kernel bytes
    flops: float                 # operations the program's operators do
    kernel_flops: float          # operations K1-K4 do (reckoned)
    t_hbm_s: float
    t_fp32_s: float              # (flops + kernel_flops) / FP32 peak
    t_roofline_s: float
    bound: str                   # "hbm" | "fp32"

    def fraction(self, t_measured_s: float) -> float:
        return self.t_roofline_s / max(t_measured_s, 1e-12)

    def as_dict(self, t_measured_s: float | None = None) -> dict:
        d = {
            "bytes_accessed_GB": round(self.bytes_accessed / 1e9, 3),
            "gflops": round(self.flops / 1e9, 2),
            "kernel_gflops": round(self.kernel_flops / 1e9, 2),
            "t_hbm_ms": round(self.t_hbm_s * 1e3, 3),
            "t_fp32_ms": round(self.t_fp32_s * 1e3, 3),
            "t_roofline_ms": round(self.t_roofline_s * 1e3, 3),
            "bound": self.bound,
        }
        if t_measured_s is not None:
            d["fraction_of_roofline"] = round(self.fraction(t_measured_s), 4)
        return d


def build(bytes_accessed: float, flops: float, kernel_flops: float = 0.0,
          hbm_bytes_per_s: float = HBM_BYTES_PER_S,
          fp32_flops_per_s: float = FP32_FLOPS_PER_S) -> Roofline:
    t_hbm = bytes_accessed / hbm_bytes_per_s
    t_fp32 = (flops + kernel_flops) / fp32_flops_per_s
    return Roofline(bytes_accessed=bytes_accessed, flops=flops,
                    kernel_flops=kernel_flops, t_hbm_s=t_hbm,
                    t_fp32_s=t_fp32, t_roofline_s=max(t_hbm, t_fp32),
                    bound="hbm" if t_hbm >= t_fp32 else "fp32")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take for one kernel's work: the bytes
    at HBM_BYTES_PER_S against the operations at FP32_FLOPS_PER_S.
    Returns (ms, "bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ---- the kernels' work, from their launch shapes: (bytes, operations) ----

def k1_work(n_rays: int, n_tris: int) -> tuple[int, int]:
    """K1, the dense closest hit, on ``n_rays`` live rays: each ray's inputs
    and outputs, the triangle rows (36 bytes) and one chunk box; one slab
    test and a pair test per triangle for each ray."""
    return (n_rays * RAY_IO_BYTES + n_tris * 36 + 24,
            n_rays * (SLAB_OPS + n_tris * PAIR_OPS))


def rows_named(idx: torch.Tensor, n_rows: int) -> int:
    """The distinct in-range rows that the ids ``idx`` name."""
    return int(torch.unique(idx[(idx >= 0) & (idx < n_rows)]).numel())


def k2_work(n: int, width: int, rows: int) -> tuple[int, int]:
    """K2, the pack-gather forward, of ``n`` ids naming ``rows`` distinct
    rows of ``width`` floats: the ids read, each named row read once (a
    gather touches at most min(T, N) rows, coherent hit ids far fewer), the
    [W, N] output written. No arithmetic."""
    return 4 * n + 4 * width * rows + 4 * width * n, 0


def k3_work(n: int, n_rows: int, width: int) -> tuple[int, int]:
    """K3, the pack-gather backward: ids and the [W, N] cotangent read, the
    [T, W] table written; one addition per cotangent element."""
    return 4 * n + 4 * n * width + 4 * n_rows * width, n * width


def k4_work(n_rays: int, n_nodes: int, n_tris: int, hits: int,
            leaf_size: int) -> tuple[int, int]:
    """K4, the BVH closest hit, at its least walk: each ray's inputs and
    outputs, every node of the binary BVH (48 bytes) and triangle (44 bytes)
    once; one slab test per level of the binary tree for each live ray and
    one leaf of pair tests for each hit."""
    levels = max(1, (n_nodes + 1).bit_length() - 1)
    return (n_rays * RAY_IO_BYTES + n_nodes * 48 + n_tris * 44,
            n_rays * levels * SLAB_OPS + hits * leaf_size * PAIR_OPS)


def k4_walk_work(n_rays: int, nodes_per_ray: float,
                 tris_per_ray: float) -> tuple[float, float]:
    """K4's walk as counted by its counting twin: each ray's inputs and
    outputs, the node records and triangle rows it visited read once per
    visit, a slab test per child box and a pair test per triangle."""
    return (n_rays * (RAY_IO_BYTES + nodes_per_ray * K4_RECORD_BYTES
                      + tris_per_ray * K4_ROW_BYTES),
            n_rays * (nodes_per_ray * K4_WIDTH * SLAB_OPS
                      + tris_per_ray * PAIR_OPS))


def shade_work(kernel: str, n: int, live: int, cast: int, lights: bool,
               textured: bool) -> tuple[int, int]:
    """S1, S2 or S3 (``kernels/shade.py``) over ``n`` lanes, ``live`` of
    them alive and hit and ``cast`` of them casting a shadow ray: the bytes
    that every such lane reads and writes, whatever its branches. Left out,
    so that the time is a least one: the reads that a lane's branch decides
    (vertex normals of smooth triangles, specular, ior and translucency,
    the tangent frame under a normal map, the texels of its textured slots,
    the light's colour, the radiance of a lane that sees its light). A dead
    lane reads its flags and, in S2, copies its state. Operations are not
    reckoned: a few hundred FP32 operations a lane take under a tenth of
    its bytes' time."""
    dead = n - live
    if kernel == "shade_s1":
        # alive, hit, itr (and pixel for the light pick); lid; texel rows
        # from bu, bv, the uv and texture-index columns
        writes = (4 if lights else 0) + (20 if textured else 0)
        return (live * (6 + (4 if lights else 0) + (52 if textured else 0)
                        + writes)
                + dead * (1 + writes)), 0
    if kernel == "shade_s2":
        # the state in (less pixel for a dead lane) and out; t, bu, bv and
        # 14 columns of the tri rows (the texture indices where textured);
        # the shadow mask; a casting lane's light corners and colour, its
        # shadow ray and stash
        mask = 1 if lights else 0
        return (live * (75 + 56 + (20 if textured else 0) + 58 + mask)
                + cast * (48 + 36) + dead * (58 + 58 + mask)), 0
    if kernel == "shade_s3":
        # the mask; a casting lane's shadow hit and its light's triangle
        return n + cast * 5, 0
    raise ValueError(f"no reckoning for kernel {kernel!r}")


@contextlib.contextmanager
def record_launches():
    """While open, every launch of K1-K4 and S1-S3 appends ``(kernel, shapes)`` to the
    list this yields (``kernels/native.launch_records``); ``kernel_work``
    prices them. Records hold the tensors that decide a launch's work (the
    live mask, the ids, the hits), so keep a window to one step."""
    if native.launch_records is not None:
        raise RuntimeError("record_launches is already open")
    native.launch_records = records = []
    try:
        yield records
    finally:
        native.launch_records = None


def _live(n, alive):
    return n if alive is None else int(alive.sum())


def launch_work(kernel: str, shapes: dict) -> tuple[int, int]:
    """(bytes, operations) of one recorded launch."""
    if kernel == "intersect_dense":
        return k1_work(_live(shapes["n"], shapes["alive"]), shapes["n_tris"])
    if kernel == "gather_rows_t":
        return k2_work(shapes["idx"].shape[0], shapes["width"],
                       rows_named(shapes["idx"], shapes["n_rows"]))
    if kernel == "gather_rows_t_bwd":
        return k3_work(shapes["n"], shapes["n_rows"], shapes["width"])
    if kernel == "intersect_list":
        return k4_work(_live(shapes["n"], shapes["alive"]),
                       shapes["n_nodes"], shapes["n_tris"],
                       int(shapes["hit"].sum()), shapes["leaf_size"])
    if kernel.startswith("shade_"):
        cast = shapes["cast"]
        return shade_work(kernel, shapes["n"],
                          int((shapes["alive"] & shapes["hit"]).sum()),
                          0 if cast is None else int(cast.sum()),
                          shapes["lights"], shapes["textured"])
    raise ValueError(f"no reckoning for kernel {kernel!r}")


def kernel_work(records) -> dict:
    """Sum the recorded launches: {"bytes", "ops", "launches": {kernel: n}}."""
    total_b = total_o = 0
    launches = {}
    for kernel, shapes in records:
        b, o = launch_work(kernel, shapes)
        total_b += b
        total_o += o
        launches[kernel] = launches.get(kernel, 0) + 1
    return {"bytes": total_b, "ops": total_o, "launches": launches}


# ---- the eager program's traffic ----

_ZERO_COST = {
    torch.ops.aten.empty, torch.ops.aten.empty_like,
    torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view,
    torch.ops.aten.set_, torch.ops.aten.resize_,
    torch.ops.aten.record_stream, torch.ops.aten.is_same_size,
}
_MATMUL = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
           torch.ops.aten.baddbmm}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor covers: a broadcast (stride
    0) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _float_numel(tensors):
    return sum(t.numel() for t in tensors if t.is_floating_point())


def operator_cost(func, args, kwargs, out) -> tuple[int, int]:
    """(bytes, operations) of one dispatched ATen operator call."""
    if func.is_view or func.overloadpacket in _ZERO_COST:
        return 0, 0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    n_bytes = sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
    if func.overloadpacket in _MATMUL:
        a, b = args[-2], args[-1]
        ops = 2 * a.numel() * b.shape[-1]
    elif torch.Tag.pointwise in func.tags:
        ops = _float_numel(outs)
    elif torch.Tag.reduction in func.tags:
        ops = _float_numel(ins)
    else:
        ops = 0
    return n_bytes, ops


class _ProgramCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        b, o = operator_cost(func, args, kwargs, out)
        self.bytes += b
        self.ops += o
        self.calls += 1
        return out


@dataclasses.dataclass(frozen=True)
class StepCost:
    """What one step moves and computes: its program's operators and its
    kernels' launches."""
    program_bytes: int
    program_ops: int
    operator_calls: int
    kernel_bytes: int
    kernel_ops: int
    launches: dict

    def roofline(self) -> Roofline:
        return build(self.program_bytes + self.kernel_bytes,
                     self.program_ops, self.kernel_ops)


def count_program(fn):
    """Run ``fn()`` once with its operators watched and its kernel launches
    recorded. Returns (fn's result, StepCost)."""
    with record_launches() as records, _ProgramCounter() as counter:
        out = fn()
    work = kernel_work(records)
    return out, StepCost(program_bytes=counter.bytes,
                         program_ops=counter.ops,
                         operator_calls=counter.calls,
                         kernel_bytes=work["bytes"], kernel_ops=work["ops"],
                         launches=work["launches"])
