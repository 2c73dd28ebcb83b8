"""Pack-gather: the CUDA kernels ``csrc/packgather.cu`` (forward K2,
backward K3) and their plain torch versions.

Replaces ``pbrpathtracer_tpu/kernels/packgather_pallas.py``: ``_run_fwd``
and ``_run_bwd`` via the ``jax.custom_vjp`` ``gather_rows_t``.
``gather_rows_t(table, idx)`` returns ``table[idx]`` transposed to a
field-major f32[W, N] block; an out-of-range id gives a zero row. Its
gradient w.r.t. ``table`` is ``gather_rows_t_bwd``: the cotangent columns
summed per id, out-of-range ids dropped; ``idx`` gets none. Unlike the TPU
kernels these take a table of any height.

Tensors on the CPU take the plain versions; CUDA tensors launch the kernels.
The backward kernel orders the lanes by id (a stable radix sort written for
it) and sums each id's run in double, in an order that the ids alone
decide: no float atomics, so the same inputs give the same bits on every
call, and its work and scratch do not grow with the table's height.
"""

from __future__ import annotations

import dataclasses

import torch

from . import native

# The backward kernel's constants (csrc/packgather.cu checks them): lanes per
# block of a sort pass, sorted lanes per block of the reduction, bits per
# radix digit.
BWD_SORT_TILE = 2048
BWD_CHUNK = 512
BWD_RADIX_BITS = 8


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """Launch plan of the backward kernel for N lanes into T rows of W."""

    passes: int         # radix passes: 8-bit digits of the keys 0..T
    sort_blocks: int    # blocks of a sort pass
    chunks: int         # blocks of the reduction, one (A, B) record pair each
    scratch_ints: int   # two (key, lane) buffers, histograms and digit
                        # totals, record rows
    scratch_doubles: int  # the records, f64[chunks, 2, W]

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_ints + 8 * self.scratch_doubles


def bwd_plan(n: int, n_rows: int, width: int) -> BwdPlan:
    """Sizes of the backward kernel's launches and scratch. The keys are the
    ids 0..T-1 and T (every dropped id), so T decides the passes and nothing
    else: the scratch is 16 N + N W / 32 bytes and change, whatever T."""
    passes = max(1, -(-max(n_rows, 1).bit_length() // BWD_RADIX_BITS))
    sort_blocks = -(-n // BWD_SORT_TILE)
    chunks = -(-n // BWD_CHUNK)
    return BwdPlan(
        passes=passes, sort_blocks=sort_blocks, chunks=chunks,
        scratch_ints=(4 * n + (1 << BWD_RADIX_BITS) * (sort_blocks + 1)
                      + chunks),
        scratch_doubles=2 * chunks * width)


def _check_inputs(table, idx):
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be [T, W] and idx [N], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"table must be float32 and idx int32, got "
                        f"{table.dtype} and {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")


def _device_stream(t):
    if t.device.type != "cuda":
        raise ValueError(f"no pack-gather kernel for device {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_rows_t_plain(table, idx):
    """Plain torch version of the forward kernel."""
    gather_rows_t_plain.launches += 1
    T = table.shape[0]
    ok = (idx >= 0) & (idx < T)
    rows = table[torch.where(ok, idx, 0).long()]
    return torch.where(ok[:, None], rows, 0.0).T.contiguous()


gather_rows_t_plain.launches = 0


def gather_rows_t_bwd_plain(idx, cot, n_rows: int):
    """Plain torch version of the backward kernel: f32[T, W] zeros,
    ``index_add_`` of ``cot.T`` over the in-range ids."""
    gather_rows_t_bwd_plain.launches += 1
    ok = (idx >= 0) & (idx < n_rows)
    out = torch.zeros((n_rows, cot.shape[0]), dtype=torch.float32,
                      device=cot.device)
    return out.index_add_(0, idx[ok].long(), cot.T[ok])


gather_rows_t_bwd_plain.launches = 0


def _fwd(table, idx):
    if idx.device.type == "cpu":
        return gather_rows_t_plain(table, idx)
    stream = _device_stream(idx)
    T, W = table.shape
    N = idx.shape[0]
    out = torch.empty((W, N), dtype=torch.float32, device=idx.device)
    err = native.load().pbr_packgather_fwd(
        idx.data_ptr(), table.data_ptr(), N, T, W, out.data_ptr(), stream)
    native.check(err, "gather_rows_t")
    gather_rows_t.launches += 1
    return out


def gather_rows_t_bwd(idx, cot, n_rows: int):
    """d_table f32[T, W]: the columns of ``cot`` f32[W, N] summed per id
    ``idx`` i32[N]; ids outside [0, T) are dropped. Kernel for CUDA
    tensors, plain version for CPU tensors."""
    if idx.dim() != 1 or cot.dim() != 2 or cot.shape[1] != idx.shape[0]:
        raise ValueError(f"cot must be [W, N] and idx [N], got "
                         f"{tuple(cot.shape)} and {tuple(idx.shape)}")
    if cot.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"cot must be float32 and idx int32, got "
                        f"{cot.dtype} and {idx.dtype}")
    if cot.device != idx.device:
        raise ValueError(f"cot on {cot.device}, idx on {idx.device}")
    if not (cot.is_contiguous() and idx.is_contiguous()):
        raise ValueError("cot and idx must be contiguous")
    if idx.device.type == "cpu":
        return gather_rows_t_bwd_plain(idx, cot, n_rows)
    stream = _device_stream(idx)
    W, N = cot.shape
    plan = bwd_plan(N, n_rows, W)
    scratch_i = torch.empty(plan.scratch_ints, dtype=torch.int32,
                            device=idx.device)
    scratch_d = torch.empty(plan.scratch_doubles, dtype=torch.float64,
                            device=idx.device)
    out = torch.empty((n_rows, W), dtype=torch.float32, device=idx.device)
    err = native.load().pbr_packgather_bwd(
        idx.data_ptr(), cot.data_ptr(), N, n_rows, W, BWD_SORT_TILE,
        BWD_CHUNK, plan.passes, scratch_i.data_ptr(), scratch_d.data_ptr(),
        out.data_ptr(), stream)
    native.check(err, "gather_rows_t_bwd")
    gather_rows_t_bwd.launches += 1
    return out


gather_rows_t_bwd.launches = 0


class _GatherRowsT(torch.autograd.Function):
    """K2 forward, K3 backward; no gradient w.r.t. the ids."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return _fwd(table, idx)

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        return gather_rows_t_bwd(idx, cot.contiguous(), ctx.n_rows), None


def gather_rows_t(table, idx):
    """``table[idx]`` transposed: f32[W, N], zero rows for ids outside
    [0, T). Differentiable w.r.t. ``table``. Kernels for CUDA tensors,
    plain versions for CPU tensors."""
    _check_inputs(table, idx)
    return _GatherRowsT.apply(table, idx)


gather_rows_t.launches = 0
