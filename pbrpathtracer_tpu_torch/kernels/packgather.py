"""Pack-gather forward: the CUDA kernel ``csrc/packgather.cu`` and its plain
torch version.

Replaces ``pbrpathtracer_tpu/kernels/packgather_pallas.py`` (``_run_fwd``
via ``gather_rows_t``): ``gather_rows_t(table, idx)`` returns ``table[idx]``
transposed to a field-major f32[W, N] block; an out-of-range id gives a zero
row. Unlike the TPU kernel it takes a table of any height.

Tensors on the CPU take the plain version; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import torch

from . import native


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


def gather_rows_t_plain(table, idx):
    """Plain torch version of the kernel."""
    gather_rows_t_plain.launches += 1
    T = table.shape[0]
    ok = (idx >= 0) & (idx < T)
    rows = table[torch.where(ok, idx, 0).long()]
    return torch.where(ok[:, None], rows, 0.0).T.contiguous()


gather_rows_t_plain.launches = 0


def gather_rows_t(table, idx):
    """``table[idx]`` transposed: f32[W, N], zero rows for ids outside
    [0, T). Kernel for CUDA tensors, plain version for CPU tensors."""
    _check_inputs(table, idx)
    if idx.device.type == "cpu":
        return gather_rows_t_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"no pack-gather kernel for device {idx.device}")
    T, W = table.shape
    N = idx.shape[0]
    out = torch.empty((W, N), dtype=torch.float32, device=idx.device)
    err = native.load().pbr_packgather_fwd(
        idx.data_ptr(), table.data_ptr(), N, T, W, out.data_ptr(),
        torch.cuda.current_stream(idx.device).cuda_stream)
    native.check(err, "gather_rows_t")
    gather_rows_t.launches += 1
    return out


gather_rows_t.launches = 0
