"""Scaling-efficiency model and readout for the sharded train step, as
``pbrpathtracer_tpu.utils.scaling``.

The 1-card → N-host efficiency of BASELINE.json's third metric is
projected from (a) a measured single-card fwd+bwd step time (the port's
``bench`` on the card), (b) the exact bytes of the gradient all-reduce
(``grad_psum_bytes``) and (c) a ring all-reduce cost model over published
link rates. Compute is taken as perfectly parallel over rays (the wavefront
is embarrassingly parallel and the scene is replicated), so the only loss
is the parameter-gradient all-reduce, which ``parallel/render.py`` confines
to one all-reduce of one flat buffer per fused training step
(``spp + 1`` per overlapped one). Forward renders all-reduce nothing.

Link rates (bytes/s, one direction, per GPU), published figures:

  * within a host: NVLink 4 of the H100 SXM5, 900 GB/s both ways = 450 GB/s
    per direction (NVIDIA H100 data sheet), through the NVSwitch of an
    HGX/DGX H100 node of 8 GPUs (``chips_per_host=8``; NVIDIA DGX H100
    user guide);
  * across hosts: one 400 Gb/s ConnectX-7 NDR InfiniBand port per GPU
    (DGX H100 user guide) = 50 GB/s.

Every model function takes the two rates as arguments, so that another
deployment (or the JAX package's TPU figures) can be put in.
"""

from __future__ import annotations

import numpy as np

NVLINK_BYTES_PER_S = 4.5e11   # per direction per GPU, NVLink 4
NIC_BYTES_PER_S = 5.0e10      # per GPU, 400 Gb/s NDR
CHIPS_PER_HOST = 8            # HGX/DGX H100


def grad_psum_bytes(params: dict) -> int:
    """Bytes all-reduced per training step: the size of the gradient dict
    (same keys and shapes as ``params``; replicated params, one
    all-reduce)."""
    return int(sum(v.numel() * v.element_size() for v in params.values()))


def ring_allreduce_time(bytes_: int, n: int, bw: float) -> float:
    """Ring all-reduce wall time over n participants at per-link bw."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * bytes_ / bw


def efficiency_estimate(t_sample_1chip: float, grad_bytes: int,
                        n_hosts: int, chips_per_host: int = CHIPS_PER_HOST,
                        spp: int = 1,
                        intra_bw: float = NVLINK_BYTES_PER_S,
                        inter_bw: float = NIC_BYTES_PER_S) -> dict:
    """Scaling efficiency T(1) / (N · T(N)) for the fused step.

    ``t_sample_1chip`` is the single-card fwd+bwd time of ONE sample; a step
    renders ``spp`` samples, then all-reduces once. T(N) = spp·t_sample/N +
    t_allreduce(N): compute splits perfectly over rays; the all-reduce runs
    hierarchically, a ring inside each host at ``intra_bw``, then a ring
    across hosts at ``inter_bw`` (what NCCL's hierarchical algorithms do on
    such a cluster). Keys as the JAX package's (``t_psum_ici_s`` is the
    within-host term, ``t_psum_dcn_s`` the across-host one).
    """
    n = n_hosts * chips_per_host
    t_compute = spp * t_sample_1chip / n
    t_in = ring_allreduce_time(grad_bytes, chips_per_host, intra_bw)
    t_across = ring_allreduce_time(grad_bytes, n_hosts, inter_bw)
    t_step = t_compute + t_in + t_across
    return {
        "n_hosts": n_hosts,
        "n_chips": n,
        "t_step_s": t_step,
        "t_compute_s": t_compute,
        "t_psum_ici_s": t_in,
        "t_psum_dcn_s": t_across,
        "efficiency": spp * t_sample_1chip / (n * t_step),
    }


def efficiency_estimate_overlapped(t_sample_1chip: float, grad_bytes: int,
                                   n_hosts: int, spp: int,
                                   chips_per_host: int = CHIPS_PER_HOST,
                                   intra_bw: float = NVLINK_BYTES_PER_S,
                                   inter_bw: float = NIC_BYTES_PER_S) -> dict:
    """Scaling efficiency for ``make_train_step_overlapped``.

    The overlapped step all-reduces each sample's partial gradients while
    the next sample's fwd+bwd runs: per-sample all-reduce latency hides
    under per-sample compute and only the last one is exposed. It costs one
    extra forward (the per-sample backward re-runs the forward), modelled as
    compute × 4/3:

        T(N) = spp · max(t_sample·4/3/N, t_ar) + t_ar
    """
    n = n_hosts * chips_per_host
    c = spp * t_sample_1chip * (4.0 / 3.0) / n
    t_ar = (ring_allreduce_time(grad_bytes, chips_per_host, intra_bw)
            + ring_allreduce_time(grad_bytes, n_hosts, inter_bw))
    t_step = spp * max(c / spp, t_ar) + t_ar
    return {
        "n_hosts": n_hosts,
        "n_chips": n,
        "t_step_s": t_step,
        "t_compute_s": c,
        "t_psum_each_s": t_ar,
        "t_psum_exposed_s": t_step - c,
        "efficiency": spp * t_sample_1chip / (n * t_step),
    }


def fit_virtual_psum_model(meas_s_by_devices: dict, nbytes: int) -> dict:
    """Fit all-reduce timings taken on processes that share one host's
    memory and no links (gloo on one machine, a virtual device mesh):

        t(n) ≈ t0 + n · bytes / host_bw

    every participant's reduced copy goes through the one memory system, so
    wall time follows the total traffic plus a fixed synchronization floor;
    the ring model above is for devices with links of their own. A
    least-squares fit of (t0, host_bw) with the relative error per point.
    """
    ns = np.array(sorted(int(k) for k in meas_s_by_devices), np.float64)
    ts = np.array([float(meas_s_by_devices[str(int(n))]) for n in ns])
    A = np.stack([np.ones_like(ns), ns], axis=1)
    (t0, b), *_ = np.linalg.lstsq(A, ts, rcond=None)
    pred = t0 + b * ns
    rel = np.abs(pred - ts) / np.maximum(ts, 1e-12)
    return {
        "model": "t0 + n*bytes/host_bw (shared-memory host, no links)",
        "t0_s": round(float(t0), 6),
        "host_bw_bytes_per_s": (round(float(nbytes / b), 1)
                                if b > 0 else None),
        "pred_s_by_devices": {str(int(n)): round(float(p), 5)
                              for n, p in zip(ns, pred)},
        "rel_err_by_devices": {str(int(n)): round(float(r), 3)
                               for n, r in zip(ns, rel)},
        "max_rel_err": round(float(rel.max()), 3),
    }


def scaling_report(params: dict, t_step_1chip: float | None = None,
                   hosts=(1, 2, 4, 8), chips_per_host: int = CHIPS_PER_HOST,
                   spp: int = 8, intra_bw: float = NVLINK_BYTES_PER_S,
                   inter_bw: float = NIC_BYTES_PER_S) -> dict:
    """Collective bytes and the per-host-count efficiency table of both
    train-step variants (fused: one all-reduce; overlapped). Without
    ``t_step_1chip`` the flagship fwd+bwd step is measured on the card by
    ``bench.measure_flagship`` (which raises where there is no card)."""
    if t_step_1chip is None:
        from ..bench import measure_flagship
        res = measure_flagship(extra_workloads=False)
        t_step_1chip = res["extras"]["t_fwdbwd_ms"] / 1e3
    b = grad_psum_bytes(params)
    return {
        "grad_psum_bytes": b,
        "t_step_1chip_s": t_step_1chip,
        "assumptions": {
            "intra_host_bytes_per_s": intra_bw,
            "inter_host_bytes_per_s": inter_bw,
            "chips_per_host": chips_per_host,
            "model": "compute perfectly parallel over rays; fused = one "
                     "hierarchical gradient all-reduce per step; overlapped "
                     "= per-sample all-reduce pipelined one sample behind "
                     f"the backward (spp={spp})",
        },
        "spp": spp,
        "by_hosts": [efficiency_estimate(t_step_1chip, b, h, chips_per_host,
                                         spp, intra_bw, inter_bw)
                     for h in hosts],
        "by_hosts_overlapped": [
            efficiency_estimate_overlapped(t_step_1chip, b, h, spp,
                                           chips_per_host, intra_bw,
                                           inter_bw)
            for h in hosts],
    }
