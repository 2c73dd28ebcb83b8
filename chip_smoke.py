#!/usr/bin/env python
"""Drive the PyTorch port's render, gradient and large-scene paths once on one
CUDA card.

    python3 chip_smoke.py

Phases, one line each, any failure ends the run with a non-zero exit:

1. device   -- a CUDA card must be present (no CPU carry-on); prints
               ``nvidia-smi --query-gpu=name,power.limit``.
2. build    -- nvcc builds the kernels from ``pbrpathtracer_tpu_torch/csrc``.
3. K1       -- the closest-hit kernel against its plain torch version, on the
               card: Cornell (1 chunk) and cornell_spheres (588 triangles,
               2 chunks), flagship primary rays and random rays with random
               t_lower and alive, N = 262,144; the same with t_lower=None
               and alive=None, without and with a triangle order ``perm``;
               the spheres queried between two Cornell queries (each
               geometry keeps its own prepared rows). Every output bit-equal:
               0 hit/idx mismatches, |dt| = |du| = |dv| = 0, misses and dead
               lanes clean (idx = t = u = v = 0).
4. K2       -- the pack-gather kernel against its plain version: the Cornell
               and spheres tri packs and the light pack, N = 262,144, with
               out-of-range ids. Must be bit-equal.
5. flagship -- ``render`` of 512x512 Cornell, depth 4, 1 spp: finite, >= 0,
               lit (max > 0.5); both kernels launched on that run and neither
               plain version. Then CUDA-event times of the render and of each
               kernel beside its plain version at the render's shapes, K2
               beside ``torch.index_select``.
6. goldens  -- rung1_cornell, rung2_spheres and rung4_translucent (128x128,
               16 spp) against ``tests/goldens`` by the port's
               ``utils.goldens.compare``.
7. K3       -- the pack-gather backward kernel against an f64 ``index_add_``
               reference at rtol 1e-6, atol 1e-5 (tests/test_packgather.py's
               tolerance): the Cornell and spheres tri packs and the light
               pack, N = 262,144, a random cotangent, out-of-range ids; the
               flagship's primary hit ids; on the 36-row, 2-row and 1-row
               tables, every lane on one row, every id out of range, and
               N = 262,139. Two calls must be bit-identical. Its plain
               version (f32 ``index_add_``, atomics on the card) is reported
               beside it.
8. flagship fwd+bwd -- ``grad_render`` of 512x512 Cornell, depth 4, 1 spp,
               materials, zero target: finite loss and gradients; K1, K2 and
               K3 launched on that run and no plain version. Then CUDA-event
               times of the forward render and of fwd+bwd with
               ``remat_segments`` "hits", "off" and "all", the peak device
               memory of each, and K3 beside its plain version and beside
               one ``index_add_`` at the backward's shapes.
9. gradcheck -- 64x64, depth 2, spp 2: AD against central FD on the
               non-max diffuse channels of the red wall at rtol 5e-3
               (tests/test_diff.py's case).
10. fit     -- the perturbed-red-wall fit at 64x64, 40 steps: the loss falls
               below 0.15 of its start. Then, under
               ``torch.use_deterministic_algorithms(True)``, a 3+3-step resume
               must equal 6 uninterrupted steps bit for bit.
11. texture grads -- textured Cornell, ``grad_render(textures=True)`` twice
               with deterministic algorithms off (reported) and on (must be
               bit-identical).
12. big scenes -- ``mesh_scene`` at 50k, 200k and 1M triangles built on the
               host with their BVHs (times printed).
13. K4      -- the BVH closest-hit kernel against its plain torch version
               (K1's tolerance): the 50k scene with the 262,144 flagship
               primary rays of ``mesh_scene_camera`` and with random rays
               (random t_lower, 20% dead), a flat plane under a flat quad
               (no BVH of its own: the kernel's private one; down rays,
               a t_lower re-trace, rays parallel to the planes), and the 1M
               scene on 16,384 rays. Then K2 against its plain version
               (bit-equal) at the 50k and 1M tri packs, on the 512^2
               primary hit ids and on random ids with out-of-range ones.
14. rung 3  -- BASELINE config 3 at spec on the 50k scene: the 512x512,
               depth 3, 64 spp forward (finite, max > 0.05, timed); the 512^2
               ``grad_render(materials=False, textures=True)`` (finite,
               nonzero); the 512^2 material ``grad_render`` (finite, K3
               launched at the 50k tri pack); the FD probe of the 3 largest
               texel gradients at 64^2, depth 2 (rel < 1%); the textured
               256^2 backward (the shape that faulted on the TPU, finite).
15. goldens -- rung3_mesh50k and rung5_million (200k triangles) against
               ``tests/goldens`` by ``utils.goldens.compare``.
16. 1M      -- ``million_tri_scene``, 512x512 depth 3 1 spp forward: finite,
               timed, peak device memory.
17. timing  -- K4 per query beside its plain version, the 50k render per spp
               without and with compaction ("off"/"scan" and "sort"/"block",
               in turns), K2 at the 50k and 1M tri packs and K3 at the 50k
               tri pack, each beside its plain version. K2 also beside
               ``torch.index_select``. K3 at the 50k and 1M tri packs on the
               512^2 primary hit ids and on random ids against f64, the edge
               cases on the 50k-row table, its scratch at the 1M pack, and
               its time beside its plain version and one ``index_add_`` (K3
               must not be the slower at the 50k pack). K4's bound.
18. launches -- after every timing: one K1 query is one kernel launch and
               dispatches no ATen operator but its allocations (counted
               by a ``TorchDispatchMode``). Then, by ``torch.profiler``, for
               the record (the profiler may deliver no device events; then
               the line says so): the K1 kernel's own time beside the
               wrapper's, K3's device time by kernel at the Cornell and 50k
               packs, and the device kernels of one flagship render and of
               one 512^2 material gradient of the 50k scene with K3's share.
Every large-scene run (phases 14-16) is driven with the launch counters at 0
and must launch K4, never K1 (``intersect_dense``) and no plain version.

Then one JSON line of per-kernel results (time, plain version's time, the
library call's time where one PyTorch call computes the same function, and
the bound: bytes over 3.35 TB/s against FP32 operations over 67 T/s), the
nvidia-smi line, and the result line ``{"ok": true, "device": {...}}`` last.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_RAYS = 262_144
CAM_POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1.0),
                up=(0.0, 1.0, 0.0), fovy=61.0)
K1_TOL = 1e-5
# BASELINE config 3 at spec (benchmarks/ladder.py's rung 3): 512^2, 64 spp;
# K4's 1M-triangle case on a 128^2 image, its flat-plane case on 65,536 rays.
RUNG3_SIZE = 512
RUNG3_SPP = 64
MILLION_RAYS = 16_384
PLANE_RAYS = 65_536
K3_RTOL, K3_ATOL = 1e-6, 1e-5
# Published peaks of the H100 SXM, for the kernels' bounds: device memory
# 3.35 TB/s; 67 T FP32 operations a second outside the tensor cores. A
# Möller-Trumbore pair test is 47 FP32 operations, a slab test 27.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
PAIR_OPS, SLAB_OPS = 47, 27


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_rays(rs, n, device):
    """Rays from inside the room with random directions, t_lower and
    alive."""
    import numpy as np
    import torch
    ro = rs.uniform([-0.95, -0.95, 0.05], [0.95, 0.95, 3.95], (n, 3))
    d = rs.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_lower = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0, 2, n), 0.0)
    alive = rs.uniform(size=n) < 0.8

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return (f32(ro), f32(rd), f32(t_lower),
            torch.tensor(alive, dtype=torch.bool, device=device))


def compare_k1(name, geom, ro, rd, t_lower, alive, perm=None):
    """K1 against its plain version: every output bit-equal (hit, idx, t, u,
    v), dead lanes and misses clean. ``t_lower`` and ``alive`` may be None
    (the plain version then gets zeros and ones)."""
    import torch
    from pbrpathtracer_tpu_torch.kernels.intersect import (
        intersect_dense, intersect_dense_plain)
    n, dev = ro.shape[0], ro.device
    kh, ki, kt, ku, kv = intersect_dense(geom, ro, rd, t_lower, alive,
                                         perm=perm)
    if t_lower is None:
        t_lower = torch.zeros(n, dtype=torch.float32, device=dev)
    if alive is None:
        alive = torch.ones(n, dtype=torch.bool, device=dev)
    ph, pi, pt, pu, pv = intersect_dense_plain(geom, ro, rd, t_lower, alive,
                                               perm)
    torch.cuda.synchronize()
    require(kh.dtype == torch.bool and ki.dtype == torch.int32,
            f"K1 {name}: output types {kh.dtype}, {ki.dtype}")
    n_mism = int(((kh != ph) | (ki != pi)).sum())
    err = max(float((a - b).abs().max()) if n else 0.0
              for a, b in ((kt, pt), (ku, pu), (kv, pv)))
    off = ~kh
    clean = bool((~kh[~alive]).all()) and all(
        bool((x[off] == 0).all()) for x in (ki, kt, ku, kv))
    print(f"K1 {name}: lanes={n} hits={int(kh.sum())} "
          f"hit/idx mismatches={n_mism} max|dt,du,dv|={err:.3g} "
          f"misses-and-dead-lanes-clean={clean}", flush=True)
    require(n_mism == 0, f"K1 {name}: {n_mism} mismatches")
    require(err == 0.0, f"K1 {name}: max error {err}")
    require(clean, f"K1 {name}: a miss or a dead lane is not a clean miss")
    return err


def render_mean_var(scene, camera, cfg):
    """Per-pixel mean and variance over cfg.spp samples, as
    benchmarks/goldens.render_one computes them."""
    import torch
    from pbrpathtracer_tpu_torch.ops.integrator import render_sample
    with torch.inference_mode():
        s = torch.zeros((cfg.num_pixels, 3), device=scene.device)
        s2 = torch.zeros_like(s)
        for k in range(cfg.spp):
            img = render_sample(scene, camera, cfg, k)
            s += img
            s2 += img * img
        mean = s / cfg.spp
        var = torch.clamp(s2 / cfg.spp - mean * mean, min=0.0)
    shape = (cfg.height, cfg.width, 3)
    return (mean.reshape(shape).cpu().numpy(),
            var.reshape(shape).cpu().numpy())


def random_ids(rs, T, dev):
    """N_RAYS random ids into a table of T rows, 1% of them -1 and 1% T + 3
    (out of range)."""
    import torch
    idx = rs.randint(0, T, N_RAYS)
    idx[rs.uniform(size=N_RAYS) < 0.01] = -1
    idx[rs.uniform(size=N_RAYS) < 0.01] = T + 3
    return torch.tensor(idx, dtype=torch.int32, device=dev)


def compare_k2(name, table, idx):
    """K2 against its plain version; must be bit-equal. Returns the max
    |difference|."""
    import torch
    from pbrpathtracer_tpu_torch.kernels.packgather import (
        gather_rows_t, gather_rows_t_plain)
    k = gather_rows_t(table, idx)
    p = gather_rows_t_plain(table, idx)
    torch.cuda.synchronize()
    equal = torch.equal(k, p)
    err = float((k - p).abs().max())
    print(f"K2 {name}: T={table.shape[0]} W={table.shape[1]} "
          f"N={idx.shape[0]} bit-equal={equal} max|d|={err:.3g}", flush=True)
    require(equal, f"K2 {name}: not bit-equal")
    return err


def compare_k3(name, T, W, idx_t, rs):
    """K3 on the ids ``idx_t`` with a random cotangent against f64 at
    rtol 1e-6 / atol 1e-5; two calls bit-identical. Returns
    max |kernel - f64|."""
    import torch
    from pbrpathtracer_tpu_torch.kernels.packgather import (
        gather_rows_t_bwd, gather_rows_t_bwd_plain)
    n, dev = idx_t.shape[0], idx_t.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rs.randint(1 << 31)))
    cot = torch.randn((W, n), generator=gen, dtype=torch.float32, device=dev)
    ok = (idx_t >= 0) & (idx_t < T)
    ref = torch.zeros((T, W), dtype=torch.float64, device=dev).index_add_(
        0, idx_t[ok].long(), cot.double().T[ok])
    k1 = gather_rows_t_bwd(idx_t, cot, T)
    k2 = gather_rows_t_bwd(idx_t, cot, T)
    plain = gather_rows_t_bwd_plain(idx_t, cot, T)
    torch.cuda.synchronize()
    same = torch.equal(k1, k2)
    err = float((k1.double() - ref).abs().max())
    plain_err = float((plain.double() - ref).abs().max())
    close = bool(torch.allclose(k1.double(), ref, rtol=K3_RTOL,
                                atol=K3_ATOL))
    print(f"K3 {name}: T={T} W={W} N={n} in-range={int(ok.sum())} "
          f"rows touched={int(torch.unique(idx_t[ok]).numel())} "
          f"max|k-f64|={err:.3g} max|plain-f64|={plain_err:.3g} "
          f"within tol={close} bit-identical repeat={same}", flush=True)
    require(close, f"K3 {name}: off the f64 reference by {err}")
    require(same, f"K3 {name}: two calls differ")
    return err


def k3_edge_cases(T, W, rs, dev):
    """K3 on ids that no random draw gives: every lane on one row, every id
    out of range, a lane count that no block size divides. Returns the max
    error."""
    import torch
    n = 262_139
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.tensor(rs.choice([-1, T, T + 3], n), **i32)
    return max(
        compare_k3(f"T={T}/one row", T, W,
                   torch.full((N_RAYS,), T // 2, **i32), rs),
        compare_k3(f"T={T}/all out of range", T, W, out, rs),
        compare_k3(f"T={T}/N={n}", T, W, random_ids(rs, T, dev)[:n], rs))


def device_kernels(fn):
    """The device kernels that one call of ``fn`` launches, by name, from
    ``torch.profiler``: {name: (count, total microseconds)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            count, us = out.get(ev.name, (0, 0.0))
            out[ev.name] = (count + 1, us + ev.time_range.elapsed_us())
    return out


def index_add_ms(idx, cot, T):
    """One ``index_add_`` of ``cot.T`` into a [T, W] buffer over the
    in-range ids ``idx``: the library call K3 is measured against."""
    import torch
    buf = torch.zeros((T, cot.shape[0]), dtype=torch.float32,
                      device=cot.device)
    ids, rows = idx.long(), cot.T
    return cuda_ms(lambda: buf.index_add_(0, ids, rows), 20)


def short_name(kernel):
    """A device kernel's name without namespaces, template and call
    arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name)[0].split("::")[-1].split()[-1]


def k3_breakdown(name, idx, cot, T):
    """Device time of one K3 call by kernel, from ``torch.profiler``."""
    from pbrpathtracer_tpu_torch.kernels.packgather import gather_rows_t_bwd
    per = device_kernels(lambda: gather_rows_t_bwd(idx, cot, T))
    print(f"K3 {name} by kernel, us: "
          + ", ".join(f"{short_name(k)} x{c} {us:.1f}"
                      for k, (c, us) in per.items())
          + f"; sum {sum(us for _, us in per.values()):.1f}", flush=True)


def torch_ops(fn):
    """The ATen operators that one call of ``fn`` dispatches, by name: every
    eager torch kernel comes from one, a kernel launched through ctypes from
    none."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] = self.ops.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.ops


def bound_ms(n_bytes, n_ops):
    """The least time the card could take: the bytes (every input read once,
    every output written once) at HBM_BYTES_S against the operations at
    FP32_OPS_S. Returns (ms, "bytes" or "operations")."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / FP32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def peak_mb(fn):
    """Peak device memory of one call, in MB."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def gradcheck_phase(cornell, camera):
    """AD against central FD on the card (tests/test_diff.py's case)."""
    import torch
    from pbrpathtracer_tpu_torch import (RenderConfig, get_params,
                                         grad_render, l2_image_loss, render)
    from pbrpathtracer_tpu_torch.diff.loss import finite_difference_grad
    cfg = RenderConfig(width=64, height=64, max_depth=2, spp=2, seed=3)
    target = render(cornell, camera, cfg) * 0.8
    params = get_params(cornell, camera)
    ad = grad_render(cornell, camera, cfg, target)[1]["mat.diffuse"]
    ad = ad.reshape(-1).cpu()
    fd = finite_difference_grad(
        lambda p: l2_image_loss(p, cornell, camera, cfg, target), params,
        "mat.diffuse", eps=2e-3, indices=[4, 5]).reshape(-1)
    for i in (4, 5):
        a, f = float(ad[i]), float(fd[i])
        ok = abs(a - f) <= 5e-3 * max(abs(a), abs(f)) + 1e-5
        print(f"gradcheck mat.diffuse[{i}]: AD={a:.6g} FD={f:.6g} "
              f"ok={ok}", flush=True)
        require(ok, f"gradcheck mat.diffuse[{i}]: AD {a} vs FD {f}")


def fit_phase(cornell, camera):
    """Recovery of a perturbed albedo, then a bit-exact 3+3 resume under
    deterministic algorithms."""
    import torch
    from pbrpathtracer_tpu_torch import RenderConfig, fit, render, set_params
    cfg = RenderConfig(width=64, height=64, max_depth=2, spp=2, seed=3)
    target = render(cornell, camera, cfg)
    perturbed = cornell.materials.diffuse.clone()
    perturbed[1] = torch.tensor([0.4, 0.5, 0.5])
    scene_p, _ = set_params(cornell, camera, {"mat.diffuse": perturbed})
    t0 = time.time()
    res = fit(scene_p, camera, cfg, target, steps=40, lr=4e-2,
              sample_offset_per_step=False)
    torch.cuda.synchronize()
    rec = res.params["mat.diffuse"][1].tolist()
    print(f"fit: 64x64 40 steps in {time.time() - t0:.2f} s, loss "
          f"{res.losses[0]:.6g} -> {res.losses[-1]:.6g} "
          f"(ratio {res.losses[-1] / res.losses[0]:.4f}), red wall "
          f"{[round(x, 4) for x in rec]} (true [0.75, 0.25, 0.25])",
          flush=True)
    require(res.losses[-1] < 0.15 * res.losses[0], "fit did not converge")

    cfg = RenderConfig(width=64, height=64, max_depth=2, spp=1, seed=7)
    zero = torch.zeros((64, 64, 3), device=cornell.device)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "fit.npz")
            full = fit(cornell, camera, cfg, zero, steps=6, lr=3e-2)
            fit(cornell, camera, cfg, zero, steps=3, lr=3e-2,
                checkpoint_path=ckpt, checkpoint_every=3)
            resumed = fit(cornell, camera, cfg, zero, steps=6, lr=3e-2,
                          checkpoint_path=ckpt, resume=True)
    finally:
        torch.use_deterministic_algorithms(False)
    same = resumed.losses == full.losses and all(
        torch.equal(full.params[k], resumed.params[k]) for k in full.params)
    print(f"fit resume 3+3 vs 6 (deterministic algorithms): "
          f"bit-identical={same}", flush=True)
    require(same, "the resumed fit differs from the uninterrupted one")


def texture_grad_phase(camera, dev):
    """Texture gradients through the advanced-index read of ops/texture.py:
    bit-identical across two calls with deterministic algorithms on."""
    import numpy as np
    import torch
    from pbrpathtracer_tpu_torch import RenderConfig, builders, grad_render
    from pbrpathtracer_tpu_torch.scene.scene import (finalize_scene,
                                                     pack_textures)
    from pbrpathtracer_tpu_torch.utils.constants import TEX_DIFFUSE
    base = builders.cornell_box()
    tex_index = base.materials.tex_index.clone()
    tex_index[:, TEX_DIFFUSE] = 0
    image = np.random.RandomState(0).uniform(size=(64, 64, 4))
    scene = finalize_scene(
        base.geom, dataclasses.replace(base.materials, tex_index=tex_index),
        pack_textures([image.astype(np.float32)])).to(dev)
    cfg = RenderConfig(width=256, height=256, max_depth=3, spp=1, seed=1)
    zero = torch.zeros((256, 256, 3), device=dev)

    def twice():
        a = grad_render(scene, camera, cfg, zero, materials=False,
                        textures=True)[1]["tex.data"]
        b = grad_render(scene, camera, cfg, zero, materials=False,
                        textures=True)[1]["tex.data"]
        return torch.equal(a, b), float((a - b).abs().max())

    plain_same, plain_d = twice()
    torch.use_deterministic_algorithms(True)
    try:
        det_same, det_d = twice()
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"texture grads 256x256 depth 3: bit-identical repeat "
          f"deterministic-off={plain_same} (max|d|={plain_d:.3g}), "
          f"deterministic-on={det_same} (max|d|={det_d:.3g})", flush=True)
    require(det_same, "texture gradients differ under deterministic "
            "algorithms")


def all_counters():
    """Every launch counter of the port's kernel wrappers and their plain
    versions."""
    from pbrpathtracer_tpu_torch.kernels import intersect as KI
    from pbrpathtracer_tpu_torch.kernels import intersect_list as KL
    from pbrpathtracer_tpu_torch.kernels import packgather as KP
    return (KI.intersect_dense, KI.intersect_dense_plain, KL.intersect_list,
            KL.intersect_list_plain, KP.gather_rows_t, KP.gather_rows_t_plain,
            KP.gather_rows_t_bwd, KP.gather_rows_t_bwd_plain)


def large_run(what, fn):
    """Run ``fn`` with every launch counter at 0; it must launch K4, never
    K1 and no plain version. Returns (fn's result, counts)."""
    import torch
    for f in all_counters():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {f.__name__: f.launches for f in all_counters()}
    print(f"  {what} launches: {counts}", flush=True)
    require(counts["intersect_list"] > 0, f"{what}: K4 was not launched")
    require(counts["intersect_dense"] == 0,
            f"{what}: the dense kernel ran on a scene over 2048 triangles")
    require(all(v == 0 for k, v in counts.items() if k.endswith("_plain")),
            f"{what}: a CUDA tensor reached a plain version")
    return out, counts


def compare_k4(name, scene, ro, rd, t_lower, alive):
    """K4 against its plain version at K1's tolerance; returns the max
    |dt, du, dv| where the winners agree."""
    import torch
    from pbrpathtracer_tpu_torch.kernels.intersect_list import (
        intersect_list, intersect_list_plain)
    accel = scene.accel
    kh, ki, kt, ku, kv = intersect_list(scene.geom, ro, rd, t_lower, alive,
                                        accel=accel)
    ph, pi, pt, pu, pv = intersect_list_plain(
        scene.geom, ro, rd, t_lower, alive,
        None if accel is None else accel.perm)
    torch.cuda.synchronize()
    mism = (kh != ph) | (ki != pi)
    n_mism = int(mism.sum())
    agree = ~mism
    err = max(float((a - b)[agree].abs().max()) if bool(agree.any())
              else 0.0 for a, b in ((kt, pt), (ku, pu), (kv, pv)))
    dead_ok = bool((~kh[~alive]).all() and (ki[~alive] == 0).all()
                   and (kt[~alive] == 0).all())
    print(f"K4 {name}: T={scene.num_triangles} lanes={ro.shape[0]} "
          f"hits={int(kh.sum())} hit/idx mismatches={n_mism} "
          f"max|dt,du,dv|={err:.3g} dead-lanes-clean={dead_ok}", flush=True)
    require(n_mism <= K1_TOL * ro.shape[0], f"K4 {name}: {n_mism} mismatches")
    require(err <= K1_TOL, f"K4 {name}: max error {err}")
    require(dead_ok, f"K4 {name}: dead lanes not a clean miss")
    return err, (kh, ki, kt)


def flat_plane_scene(n_side=37, quad=True):
    """A tessellated plane at y = 0, with ``quad`` a quad at y = 1 above it,
    all exactly flat, without a BVH of its own (tests/test_pallas_list.py's
    scene)."""
    import numpy as np
    from pbrpathtracer_tpu_torch.scene.scene import (
        MaterialSpec, finalize_scene, pack_geometry, pack_materials)
    xs = np.linspace(-4.0, 4.0, n_side + 1, dtype=np.float32)
    v0, v1, v2 = [], [], []
    for i in range(n_side):
        for k in range(n_side):
            a, b = (xs[i], 0, xs[k]), (xs[i + 1], 0, xs[k])
            c, d = (xs[i + 1], 0, xs[k + 1]), (xs[i], 0, xs[k + 1])
            v0 += [a, a]
            v1 += [b, c]
            v2 += [c, d]
    if quad:
        v0 += [(-4, 1, -4), (-4, 1, -4)]
        v1 += [(4, 1, -4), (4, 1, 4)]
        v2 += [(4, 1, 4), (-4, 1, 4)]
    tris = {k: np.asarray(x, np.float32)
            for k, x in (("v0", v0), ("v1", v1), ("v2", v2))}
    return finalize_scene(pack_geometry(tris),
                          pack_materials([MaterialSpec()]), accel="none")


def scene_rays(rs, n, device):
    """Rays over the mesh_scene terrain: random origins above it, random
    directions, 30% with a random t_lower, 20% dead."""
    import numpy as np
    import torch
    ro = rs.uniform([-7, -1, 0], [7, 3, 16], (n, 3))
    d = rs.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_lower = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0, 2, n), 0.0)
    alive = rs.uniform(size=n) < 0.8

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return (f32(ro), f32(rd), f32(t_lower),
            torch.tensor(alive, dtype=torch.bool, device=device))


def k4_phase(big, million, dev, rs):
    """Phase 13; returns (max error, the primary rays and their hits)."""
    import numpy as np
    import torch
    from pbrpathtracer_tpu_torch.ops.camera import generate_rays
    from pbrpathtracer_tpu_torch.scene.big_scenes import mesh_scene_camera
    cam = mesh_scene_camera().to(dev)
    ro, rd = generate_rays(cam, RUNG3_SIZE, RUNG3_SIZE, 0, 0)
    n = ro.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    err, (hit, idx, _) = compare_k4("50k/primary", big, ro, rd, zeros, ones)
    require(float(hit.float().mean()) > 0.3, "K4 50k/primary: too few hits")
    err = max(err, compare_k4("50k/random", big,
                              *scene_rays(rs, n, dev))[0])

    plane = flat_plane_scene().to(dev)
    n = PLANE_RAYS
    pro = np.stack([rs.uniform(-3, 3, n), np.full(n, 3.0),
                    rs.uniform(-3, 3, n)], axis=1)
    prd = np.tile([[0.0, -1.0, 0.0]], (n, 1))
    pro[1::2, 1] = 1.0               # origins on the quad's plane
    prd[1::4] = [0.6, 0.0, 0.8]      # parallel to both planes
    f32 = dict(dtype=torch.float32, device=dev)
    pro, prd = torch.tensor(pro, **f32), torch.tensor(prd, **f32)
    palive = torch.ones(n, dtype=torch.bool, device=dev)
    perr, (ph, _, pt) = compare_k4("flat/first", plane, pro, prd,
                                   torch.zeros(n, **f32), palive)
    down = torch.arange(n, device=dev) % 2 == 0
    require(bool(ph[down].all()) and bool(
        ((pt[down] - 2.0).abs() < 1e-4).all()), "K4 flat: quad not hit")
    perr2, (ph2, _, pt2) = compare_k4("flat/re-trace", plane, pro, prd, pt,
                                      palive)
    require(bool(((pt2[down] - 3.0).abs() < 1e-4).all()),
            "K4 flat: the re-trace missed the plane")
    err = max(err, perr, perr2)

    err = max(err, compare_k4("1M/random", million,
                              *scene_rays(rs, MILLION_RAYS, dev))[0])
    side = int(round(MILLION_RAYS ** 0.5))
    mro, mrd = generate_rays(cam, side, side, 0, 0)
    m = side * side
    err = max(err, compare_k4("1M/primary", million, mro, mrd,
                              torch.zeros(m, **f32),
                              torch.ones(m, dtype=torch.bool, device=dev))[0])
    return err, ro, rd, zeros, ones, idx


def rung3_phase(big, dev):
    """Phase 14: BASELINE config 3 at spec. Returns (K4 launches of the
    64 spp forward, its seconds)."""
    import numpy as np
    import torch
    from pbrpathtracer_tpu_torch import (RenderConfig, get_params,
                                         grad_render, l2_image_loss, render)
    from pbrpathtracer_tpu_torch.diff.loss import finite_difference_grad
    from pbrpathtracer_tpu_torch.scene.big_scenes import mesh_scene_camera
    cam = mesh_scene_camera().to(dev)
    size, spp = RUNG3_SIZE, RUNG3_SPP
    cfg = RenderConfig(width=size, height=size, max_depth=3, spp=spp)
    t0 = time.time()
    img, counts = large_run(f"rung 3 forward {size}x{size} {spp} spp",
                            lambda: render(big, cam, cfg))
    fwd_s = time.time() - t0
    finite = bool(torch.isfinite(img).all())
    peak = float(img.max())
    print(f"rung 3 forward: {size}x{size} depth 3 spp {spp} in {fwd_s:.3f} s "
          f"({fwd_s / spp * 1e3:.3f} ms per spp) finite={finite} "
          f"max={peak:.4f} mean={float(img.mean()):.6f}", flush=True)
    require(finite and peak > 0.05, "rung 3 image is wrong")

    zero = torch.zeros((size, size, 3), device=dev)
    gcfg = cfg.replace(spp=1)
    t0 = time.time()
    (loss, g), _ = large_run("rung 3 texture grad", lambda: grad_render(
        big, cam, gcfg, zero, materials=False, textures=True))
    tex_s = time.time() - t0
    gt = g["tex.data"]
    ok = bool(torch.isfinite(gt).all()) and float(gt.abs().max()) > 0
    tex_ms = cuda_ms(lambda: grad_render(big, cam, gcfg, zero, materials=False,
                                         textures=True), 2)
    tex_mb = peak_mb(lambda: grad_render(big, cam, gcfg, zero,
                                         materials=False, textures=True))
    print(f"rung 3 texture grad: {size}x{size} depth 3 spp 1 in {tex_s:.3f} s "
          f"(first call), then {tex_ms:.3f} ms, peak {tex_mb:.0f} MB; "
          f"loss={float(loss):.6f} finite and nonzero={ok} "
          f"|d tex|={float(gt.norm()):.6g}", flush=True)
    require(ok, "rung 3 texture gradients not finite or all zero")

    t0 = time.time()
    (loss, g), mcounts = large_run("rung 3 material grad",
                                   lambda: grad_render(big, cam, gcfg, zero))
    mat_s = time.time() - t0
    finite = all(bool(torch.isfinite(v).all()) for v in g.values())
    mat_ms = cuda_ms(lambda: grad_render(big, cam, gcfg, zero), 2)
    mat_mb = peak_mb(lambda: grad_render(big, cam, gcfg, zero))
    print(f"rung 3 material grad: {size}x{size} depth 3 spp 1 in {mat_s:.3f} s "
          f"(first call), then {mat_ms:.3f} ms, peak {mat_mb:.0f} MB; "
          f"loss={float(loss):.6f} finite={finite} "
          f"|d diffuse|={float(g['mat.diffuse'].norm()):.6g}", flush=True)
    require(finite, "rung 3 material gradients not finite")
    require(mcounts["gather_rows_t_bwd"] > 0,
            "rung 3 material grad: K3 was not launched")

    fcfg = RenderConfig(width=64, height=64, max_depth=2, spp=1, seed=5)
    ftarget = torch.zeros((64, 64, 3), device=dev)
    params = get_params(big, cam, materials=False, textures=True)
    ad = grad_render(big, cam, fcfg, ftarget, materials=False,
                     textures=True)[1]["tex.data"].reshape(-1).cpu().numpy()
    top = np.argsort(np.abs(ad))[-3:].tolist()
    fd = finite_difference_grad(
        lambda p: l2_image_loss(p, big, cam, fcfg, ftarget), params,
        "tex.data", eps=5e-3, indices=top).reshape(-1)
    for i in top:
        a, f = float(ad[i]), float(fd[i])
        rel = abs(a - f) / max(abs(f), 1e-12)
        print(f"rung 3 FD probe texel {i}: AD={a:.6g} FD={f:.6g} "
              f"rel={rel:.3%}", flush=True)
        require(a != 0.0 and rel < 0.01, f"texel {i}: AD {a} vs FD {f}")

    fsize = size // 2
    fault = RenderConfig(width=fsize, height=fsize, max_depth=3, spp=1)
    (loss, g), _ = large_run("textured backward", lambda: grad_render(
        big, cam, fault, torch.zeros((fsize, fsize, 3), device=dev),
        materials=False, textures=True))
    finite = bool(torch.isfinite(g["tex.data"]).all()) and bool(
        torch.isfinite(loss))
    print(f"textured 50k backward at {fsize}x{fsize} (the TPU faulted at "
          f"256x256): "
          f"loss={float(loss):.6f} finite={finite}", flush=True)
    require(finite, "the 256x256 textured backward is not finite")
    return counts["intersect_list"], fwd_s


def large_scene_phases(dev, rs, smi_line):
    """Phases 12-17 at BASELINE config 3's spec. Returns K4's numbers for
    the kernels line and the max K2 and K3 errors at the 50k and 1M tri
    packs."""
    import numpy as np
    import torch
    from pbrpathtracer_tpu_torch import RenderConfig, render
    from pbrpathtracer_tpu_torch.kernels.packgather import (
        bwd_plan, gather_rows_t, gather_rows_t_bwd, gather_rows_t_bwd_plain,
        gather_rows_t_plain)
    from pbrpathtracer_tpu_torch.ops import shadepack as sp
    from pbrpathtracer_tpu_torch.ops.camera import generate_rays
    from pbrpathtracer_tpu_torch.utils.goldens import GOLDEN_DIR, compare
    # ---- 12. big scenes ----
    from pbrpathtracer_tpu_torch.kernels.intersect_list import (
        intersect_list, intersect_list_plain)
    from pbrpathtracer_tpu_torch.scene.big_scenes import (
        mesh_scene, mesh_scene_camera, million_tri_scene)
    scenes = {}
    for name, make in (("50k", lambda: mesh_scene(50_000)),
                       ("200k", lambda: mesh_scene(200_000, accel="always")),
                       ("1M", million_tri_scene)):
        t0 = time.time()
        sc = make()
        host_s = time.time() - t0
        scenes[name] = sc.to(dev)
        print(f"scene {name}: {sc.num_triangles} triangles, "
              f"{sc.accel.num_nodes} BVH nodes, built on the host in "
              f"{host_s:.2f} s", flush=True)
    big, million = scenes["50k"], scenes["1M"]
    mcam = mesh_scene_camera().to(dev)

    # ---- 13. K4 vs plain, then K2 vs plain at the 50k and 1M tri packs
    # on the 512^2 primary hit ids and on random ids ----
    k4_err, mro, mrd, mzeros, mones, midx = k4_phase(big, million, dev, rs)
    pack50k = sp.build_tri_pack(big)
    pack1m = sp.build_tri_pack(million)
    idx1m = intersect_list(million.geom, mro, mrd, mzeros, mones,
                           accel=million.accel)[1]
    k2_err = 0.0
    for pname, table, prim in (("50k tri pack", pack50k, midx),
                               ("1M tri pack", pack1m, idx1m)):
        k2_err = max(k2_err,
                     compare_k2(f"{pname}/primary", table, prim),
                     compare_k2(f"{pname}/random", table,
                                random_ids(rs, table.shape[0], dev)))

    # ---- 14. rung 3 at spec ----
    k4_launches, rung3_s = rung3_phase(big, dev)

    # ---- 15. goldens of the large scenes ----
    for name, sc, kw in (
            ("rung3_mesh50k", big,
             dict(width=128, height=128, max_depth=3, spp=16)),
            ("rung5_million", scenes.pop("200k"),
             dict(width=128, height=128, max_depth=3, spp=8))):
        (mean, var), _ = large_run(f"golden {name}", lambda: render_mean_var(
            sc, mcam, RenderConfig(**kw)))
        rep = compare(mean, var, np.load(os.path.join(GOLDEN_DIR,
                                                      f"{name}.npz")))
        print(f"golden {name}: {json.dumps(rep)}", flush=True)
        require(rep["ok"], f"golden {name} failed")
    del sc

    # ---- 16. 1M forward ----
    size = RUNG3_SIZE
    mcfg = RenderConfig(width=size, height=size, max_depth=3, spp=1)
    torch.cuda.synchronize()
    held_mb = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img, _ = large_run("1M forward", lambda: render(million, mcam, mcfg))
    first_s = time.time() - t0
    peak_1m = torch.cuda.max_memory_allocated() / 2 ** 20
    finite = bool(torch.isfinite(img).all())
    m_ms = cuda_ms(lambda: render(million, mcam, mcfg), 2)
    print(f"1M forward: {million.num_triangles} triangles, {size}x{size} "
          f"depth 3 "
          f"spp 1: first call {first_s:.3f} s, then {m_ms:.3f} ms; "
          f"finite={finite} max={float(img.max()):.4f}; peak {peak_1m:.0f} "
          f"MB ({peak_1m - held_mb:.0f} MB above the {held_mb:.0f} MB held "
          f"before)", flush=True)
    require(finite and float(img.max()) > 0.05, "1M image is wrong")

    # ---- 17. timing ----
    k4_ms = cuda_ms(lambda: intersect_list(big.geom, mro, mrd, mzeros, mones,
                                           accel=big.accel), 20)
    k4_plain_ms = cuda_ms(lambda: intersect_list_plain(
        big.geom, mro, mrd, mzeros, mones, big.accel.perm), 1)
    k4_ms_2 = cuda_ms(lambda: intersect_list(big.geom, mro, mrd, mzeros,
                                             mones, accel=big.accel), 20)
    side = int(round(MILLION_RAYS ** 0.5))
    sro, srd = generate_rays(mcam, side, side, 0, 0)
    m = side * side
    m4_ms = cuda_ms(lambda: intersect_list(million.geom, sro, srd,
                                           mzeros[:m], mones[:m],
                                           accel=million.accel), 20)
    print(f"timing K4 ({smi_line}): 50k scene, {mro.shape[0]} primary rays: "
          f"{k4_ms:.4f} / {k4_ms_2:.4f} ms vs plain {k4_plain_ms:.3f} ms | "
          f"1M scene, {m} primary rays ({side}x{side}): {m4_ms:.4f} ms",
          flush=True)
    per_spp = {}
    for mode, order in (("off", "scan"), ("sort", "block"), ("sort", "block"),
                        ("off", "scan"), ("gather", "scan")):
        c = mcfg.replace(compact_wavefront=mode, pixel_order=order)
        per_spp.setdefault(f"{mode}/{order}", []).append(
            cuda_ms(lambda: render(big, mcam, c), 3))
    print(f"timing 50k render {size}x{size} depth 3, ms per spp "
          f"({smi_line}): "
          + " | ".join(f"{k}: {', '.join(f'{x:.3f}' for x in v)}"
                       for k, v in per_spp.items())
          + f" | {RUNG3_SPP}-spp run {rung3_s / RUNG3_SPP * 1e3:.3f}",
          flush=True)
    k2_ms = {}
    for pname, table, prim in (("50k", pack50k, midx), ("1M", pack1m, idx1m)):
        table_t = table.T
        k2_ms[pname] = (cuda_ms(lambda: gather_rows_t(table, prim), 20),
                        cuda_ms(lambda: gather_rows_t_plain(table, prim), 20),
                        cuda_ms(lambda: torch.index_select(table_t, 1, prim),
                                20),
                        cuda_ms(lambda: gather_rows_t(table, prim), 20))
    print(f"timing K2 ({smi_line}), 512^2 primary hit ids: "
          + " | ".join(f"{p} tri pack: {k:.4f} / {k2:.4f} ms vs plain "
                       f"{pl:.4f} ms, index_select {lib:.4f} ms"
                       for p, (k, pl, lib, k2) in k2_ms.items()),
          flush=True)

    # K3 at the 50k and 1M tri packs: the 512^2 primary hit ids (coherent
    # runs; row 0 of the 1M pack collects every miss) and random ids, then
    # the edge cases on the tall table; the scratch of the 1M case
    k3_err, k3_ms = 0.0, {}
    W = pack50k.shape[1]
    cot = torch.tensor(rs.normal(size=(W, midx.shape[0])),
                       dtype=torch.float32, device=dev)
    for pname, T, prim in (("50k", pack50k.shape[0], midx),
                           ("1M", pack1m.shape[0], idx1m)):
        heavy = int(torch.bincount(prim.long()).max())
        print(f"K3 {pname} tri pack, primary hit ids: the heaviest row owns "
              f"{heavy} of {prim.shape[0]} lanes", flush=True)
        k3_err = max(k3_err,
                     compare_k3(f"{pname} tri pack/primary", T, W, prim, rs),
                     compare_k3(f"{pname} tri pack/random", T, W,
                                random_ids(rs, T, dev), rs))
        k3_ms[pname] = (
            cuda_ms(lambda: gather_rows_t_bwd(prim, cot, T), 20),
            cuda_ms(lambda: gather_rows_t_bwd_plain(prim, cot, T), 20),
            index_add_ms(prim, cot, T),
            cuda_ms(lambda: gather_rows_t_bwd(prim, cot, T), 20))
    k3_err = max(k3_err, k3_edge_cases(pack50k.shape[0], W, rs, dev))
    T1m = pack1m.shape[0]
    del pack1m
    plan = bwd_plan(idx1m.shape[0], T1m, W)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = gather_rows_t_bwd(idx1m, cot, T1m)
    torch.cuda.synchronize()
    extra_mb = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    out_mb = out.numel() * 4 / 2 ** 20
    print(f"K3 1M tri pack scratch: planned {plan.scratch_bytes / 2 ** 20:.2f}"
          f" MB ({plan.passes} sort passes, {plan.chunks} chunks; 16 N + "
          f"N W / 32 bytes and change, nothing per row), measured peak "
          f"{extra_mb:.1f} MB above what was held = the {out_mb:.1f} MB "
          f"output + {extra_mb - out_mb:.2f} MB", flush=True)
    require(extra_mb - out_mb <= plan.scratch_bytes / 2 ** 20 + 4.0,
            "K3 allocated more than its planned scratch")
    del out, idx1m
    n = midx.shape[0]
    k3_bounds = {"50k": bound_ms(4 * n + 4 * n * W + 4 * pack50k.shape[0] * W,
                                 n * W)[0],
                 "1M": bound_ms(4 * n + 4 * n * W + 4 * T1m * W, n * W)[0]}
    print(f"timing K3 ({smi_line}), 512^2 primary hit ids: "
          + " | ".join(f"{p} tri pack: {k:.4f} / {k2:.4f} ms vs plain "
                       f"{pl:.4f} ms, index_add_ alone {lib:.4f} ms, bound "
                       f"{k3_bounds[p]:.4f} ms by bytes"
                       for p, (k, pl, lib, k2) in k3_ms.items()),
          flush=True)
    require(k3_ms["50k"][0] <= k3_ms["50k"][2],
            "K3 at the 50k tri pack is slower than index_add_")

    # K4's bound: every input and output once against the least walk: one
    # slab test per BVH level for a live ray, one leaf of pair tests for a hit
    n_rays = mro.shape[0]
    levels = max(1, (big.accel.num_nodes + 1).bit_length() - 1)
    hits = int(intersect_list(big.geom, mro, mrd, mzeros, mones,
                              accel=big.accel)[0].sum())
    k4_bound = bound_ms(
        n_rays * (24 + 4 + 1 + 17) + big.accel.num_nodes * 48
        + big.num_triangles * 44,
        n_rays * levels * SLAB_OPS + hits * big.accel.leaf_size * PAIR_OPS)
    print(f"bound K4 50k primary: {k4_bound[0]:.4f} ms by {k4_bound[1]} "
          f"({levels} levels, {hits} hits, leaves of "
          f"{big.accel.leaf_size})", flush=True)
    return {"launches": k4_launches, "err": k4_err, "ms": k4_ms,
            "plain_ms": k4_plain_ms, "bound": k4_bound, "k2_err": k2_err,
            "k3_err": k3_err, "scene": big, "camera": mcam, "cfg": mcfg,
            "primary_ids": midx, "cot": cot, "rows": pack50k.shape[0]}


def main():
    import numpy as np
    import torch

    t_start = time.time()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the "
                         "card and does not run on the CPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    print(f"device: {kind} x{torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {smi_line}",
          flush=True)

    # ---- 2. build ----
    from pbrpathtracer_tpu_torch import (Camera, RenderConfig, builders,
                                         grad_render, render)
    from pbrpathtracer_tpu_torch.kernels import native
    from pbrpathtracer_tpu_torch.kernels.intersect import (
        intersect_dense, intersect_dense_plain)
    from pbrpathtracer_tpu_torch.kernels.packgather import (
        gather_rows_t, gather_rows_t_bwd, gather_rows_t_bwd_plain,
        gather_rows_t_plain)
    from pbrpathtracer_tpu_torch.ops import shadepack as sp
    from pbrpathtracer_tpu_torch.ops.camera import generate_rays

    t0 = time.time()
    log = native.build()
    native.load()
    print(f"build: {time.time() - t0:.1f} s -> "
          f"{os.path.relpath(native.LIB_PATH, REPO)}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # ---- 3. K1 vs plain ----
    cornell = builders.cornell_box().to(dev)
    spheres = builders.cornell_spheres_scene().to(dev)
    camera = Camera.make(**CAM_POSE).to(dev)
    ro, rd = generate_rays(camera, 512, 512, 0, 0)
    zeros = torch.zeros(N_RAYS, dtype=torch.float32, device=dev)
    ones = torch.ones(N_RAYS, dtype=torch.bool, device=dev)
    rs = np.random.RandomState(0)
    k1_err = 0.0
    rays = random_rays(rs, N_RAYS, dev)
    for sname, scene in (("cornell", cornell), ("spheres", spheres)):
        k1_err = max(k1_err, compare_k1(f"{sname}/primary", scene.geom,
                                        ro, rd, zeros, ones))
        k1_err = max(k1_err, compare_k1(f"{sname}/random", scene.geom, *rays))
    # no t_lower and no alive, without and with a triangle order; then the
    # spheres queried between two queries of Cornell: each geometry keeps
    # its own prepared rows, whatever was queried last
    for sname, scene in (("cornell", cornell), ("spheres", spheres)):
        perm = torch.tensor(rs.permutation(scene.num_triangles),
                            dtype=torch.int32, device=dev)
        for pname, p in (("no perm", None), ("perm", perm)):
            k1_err = max(
                k1_err,
                compare_k1(f"{sname}/primary, t_lower=None alive=None, "
                           f"{pname}", scene.geom, ro, rd, None, None, p),
                compare_k1(f"{sname}/random, {pname}", scene.geom, *rays, p))
    first = intersect_dense(cornell.geom, *rays)
    k1_err = max(k1_err, compare_k1("spheres between two Cornell queries",
                                    spheres.geom, *rays))
    again = intersect_dense(cornell.geom, *rays)
    require(all(torch.equal(a, b) for a, b in zip(first, again)),
            "K1: a query of another scene changed Cornell's answers")
    k1_err = max(k1_err, compare_k1("cornell after the spheres",
                                    cornell.geom, *rays))
    del first, again, rays, perm   # not held through the peak-memory phases

    # ---- 4. K2 vs plain ----
    k2_err = 0.0
    for pname, table in (("cornell tri pack", sp.build_tri_pack(cornell)),
                         ("spheres tri pack", sp.build_tri_pack(spheres)),
                         ("light pack", sp.build_light_pack(cornell))):
        k2_err = max(k2_err, compare_k2(
            pname, table, random_ids(rs, table.shape[0], dev)))

    # ---- 5. flagship ----
    cfg = RenderConfig(width=512, height=512, max_depth=4, spp=1, seed=0)
    counters = all_counters()
    for fn in counters:
        fn.launches = 0
    img = render(cornell, camera, cfg)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    finite = bool(torch.isfinite(img).all())
    nonneg = bool((img >= 0).all())
    peak = float(img.max())
    print(f"flagship: 512x512 depth 4 spp 1 finite={finite} nonneg={nonneg} "
          f"max={peak:.4f} mean={float(img.mean()):.6f} "
          f"launches={launches}", flush=True)
    require(finite and nonneg and peak > 0.5, "flagship image is wrong")
    require(launches["intersect_dense"] > 0
            and launches["gather_rows_t"] > 0,
            "the render did not go through both kernels")
    require(launches["intersect_dense_plain"] == 0
            and launches["gather_rows_t_plain"] == 0,
            "a CUDA tensor reached a plain version")
    require(launches["gather_rows_t_bwd"] == 0,
            "a forward-only render ran the backward kernel")

    render_ms = cuda_ms(lambda: render(cornell, camera, cfg), 5)
    # kernel shapes of the render: primary rays, their hit ids into the
    # tri pack
    hit, idx, _, _, _ = intersect_dense(cornell.geom, ro, rd, zeros, ones)
    tri_pack = sp.build_tri_pack(cornell)
    k1_ms = cuda_ms(lambda: intersect_dense(cornell.geom, ro, rd, zeros,
                                            ones), 20)
    k1_plain_ms = cuda_ms(lambda: intersect_dense_plain(
        cornell.geom, ro, rd, zeros, ones), 5)
    k2_ms = cuda_ms(lambda: gather_rows_t(tri_pack, idx), 20)
    k2_plain_ms = cuda_ms(lambda: gather_rows_t_plain(tri_pack, idx), 20)
    pack_t = tri_pack.T
    k2_lib_ms = cuda_ms(lambda: torch.index_select(pack_t, 1, idx), 20)
    k1_none_ms = cuda_ms(lambda: intersect_dense(cornell.geom, ro, rd), 20)
    print(f"timing ({smi_line}): render {render_ms:.3f} ms | "
          f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms | "
          f"K2 {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms, "
          f"index_select {k2_lib_ms:.4f} ms", flush=True)
    # ---- 6. goldens ----
    from pbrpathtracer_tpu_torch.utils.goldens import GOLDEN_DIR, compare
    goldens = {
        "rung1_cornell": (builders.cornell_box, {},
                          dict(width=128, height=128, max_depth=3, spp=16)),
        "rung2_spheres": (builders.cornell_spheres_scene, {},
                          dict(width=128, height=128, max_depth=3, spp=16)),
        "rung4_translucent": (builders.translucent_scene,
                              dict(focal_dist=2.2, aperture=0.04),
                              dict(width=128, height=128, max_depth=4,
                                   spp=16)),
    }
    for name, (build, lens, kw) in goldens.items():
        mean, var = render_mean_var(build().to(dev),
                                    Camera.make(**CAM_POSE, **lens),
                                    RenderConfig(**kw))
        rep = compare(mean, var, np.load(os.path.join(GOLDEN_DIR,
                                                      f"{name}.npz")))
        print(f"golden {name}: {json.dumps(rep)}", flush=True)
        require(rep["ok"], f"golden {name} failed")

    # ---- 7. K3 vs f64 ----
    k3_err = 0.0
    for pname, table in (("cornell tri pack", sp.build_tri_pack(cornell)),
                         ("spheres tri pack", sp.build_tri_pack(spheres)),
                         ("light pack", sp.build_light_pack(cornell))):
        T, W = table.shape
        k3_err = max(k3_err, compare_k3(pname, T, W, random_ids(rs, T, dev),
                                        rs))
    # the flagship's own ids (coherent runs), then the shapes no random draw
    # gives, on the 36-row pack, the 2-row light pack and a 1-row table
    k3_err = max(k3_err,
                 compare_k3("cornell tri pack/primary", *tri_pack.shape, idx,
                            rs),
                 k3_edge_cases(*tri_pack.shape, rs, dev),
                 k3_edge_cases(*sp.build_light_pack(cornell).shape, rs, dev),
                 k3_edge_cases(1, 7, rs, dev))

    # ---- 8. flagship fwd+bwd ----
    zero = torch.zeros((512, 512, 3), device=dev)
    for fn in counters:
        fn.launches = 0
    loss, grads = grad_render(cornell, camera, cfg, zero)
    torch.cuda.synchronize()
    bwd_launches = {fn.__name__: fn.launches for fn in counters}
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    print(f"flagship fwd+bwd: 512x512 depth 4 spp 1 loss={float(loss):.6f} "
          f"finite={finite} |d diffuse|={float(grads['mat.diffuse'].norm()):.6g} "
          f"launches={bwd_launches}", flush=True)
    require(finite, "flagship loss or gradients not finite")
    require(all(bwd_launches[f.__name__] > 0 for f in (
        intersect_dense, gather_rows_t, gather_rows_t_bwd)),
        "the fwd+bwd did not go through K1, K2 and K3")
    require(all(bwd_launches[f.__name__] == 0 for f in (
        intersect_dense_plain, gather_rows_t_plain, gather_rows_t_bwd_plain)),
        "a CUDA tensor reached a plain version")

    remat_ms, remat_mb = {}, {}
    for mode in ("hits", "off", "all", "off", "hits"):
        c = cfg.replace(remat_segments=mode)
        ms = cuda_ms(lambda: grad_render(cornell, camera, c, zero), 3)
        remat_ms.setdefault(mode, []).append(ms)
        remat_mb[mode] = peak_mb(lambda: grad_render(cornell, camera, c,
                                                     zero))
    fwd_ms = cuda_ms(lambda: render(cornell, camera, cfg), 5)
    print(f"timing fwd+bwd ({smi_line}): forward {fwd_ms:.3f} ms | "
          + " | ".join(f"{m}: {', '.join(f'{x:.3f}' for x in v)} ms, peak "
                       f"{remat_mb[m]:.0f} MB" for m, v in remat_ms.items()),
          flush=True)
    fwd_mb = peak_mb(lambda: render(cornell, camera, cfg))
    print(f"peak memory forward render: {fwd_mb:.0f} MB", flush=True)

    cot = torch.tensor(rs.normal(size=(tri_pack.shape[1], N_RAYS)),
                       dtype=torch.float32, device=dev)
    k3_ms = cuda_ms(lambda: gather_rows_t_bwd(idx, cot, tri_pack.shape[0]),
                    20)
    k3_plain_ms = cuda_ms(lambda: gather_rows_t_bwd_plain(
        idx, cot, tri_pack.shape[0]), 20)
    k3_ms_2 = cuda_ms(lambda: gather_rows_t_bwd(idx, cot, tri_pack.shape[0]),
                      20)
    k3_lib_ms = index_add_ms(idx, cot, tri_pack.shape[0])
    print(f"timing K3 ({smi_line}): Cornell tri pack, flagship primary hit "
          f"ids: {k3_ms:.4f} / {k3_ms_2:.4f} ms vs plain {k3_plain_ms:.4f} ms, "
          f"index_add_ alone {k3_lib_ms:.4f} ms", flush=True)

    # ---- 9-11. gradcheck, fit, texture gradients ----
    gradcheck_phase(cornell, camera)
    fit_phase(cornell, camera)
    texture_grad_phase(camera, dev)

    # ---- 12-17. the large-scene path ----
    k4 = large_scene_phases(dev, rs, smi_line)
    k2_err = max(k2_err, k4["k2_err"])
    k3_err = max(k3_err, k4["k3_err"])
    # ---- 18. what a query, a render and a gradient launch ----
    # (last, so that the profiler cannot weigh on any time above)
    from pbrpathtracer_tpu_torch.kernels.packgather import gather_rows_t_bwd
    perm = None if cornell.accel is None else cornell.accel.perm

    def query():
        return intersect_dense(cornell.geom, ro, rd, zeros, ones, perm=perm)
    before = intersect_dense.launches
    ops = torch_ops(query)
    print(f"K1 query: {intersect_dense.launches - before} kernel launch, "
          f"ATen operators dispatched: {ops}", flush=True)
    require(intersect_dense.launches == before + 1
            and all(k.startswith("aten.empty") for k in ops),
            "a K1 query ran an eager torch kernel beside its allocations")

    def ten_queries():
        for _ in range(10):
            query()
    per_query = device_kernels(ten_queries)
    n_query_kernels = sum(c for c, _ in per_query.values())
    k1_raw = (f"{sum(us for _, us in per_query.values()) / 1e4:.4f} ms"
              if n_query_kernels else "not measured (no device events)")
    print(f"timing K1 per query ({smi_line}): wrapper {k1_ms:.4f} ms "
          f"({k1_none_ms:.4f} ms with t_lower=None, alive=None), its kernel "
          f"{k1_raw}; device kernels of ten queries: "
          f"{ {short_name(k): c for k, (c, _) in per_query.items()} }",
          flush=True)
    require(n_query_kernels in (0, 10) and len(per_query) <= 1,
            "ten K1 queries launched more than ten device kernels")
    k3_breakdown("Cornell tri pack, primary hit ids", idx, cot,
                 tri_pack.shape[0])
    k3_breakdown("50k tri pack, primary hit ids", k4["primary_ids"],
                 k4["cot"], k4["rows"])
    per_render = device_kernels(lambda: render(cornell, camera, cfg))
    n_kernels = sum(c for c, _ in per_render.values())
    k1_kernels = sum(c for k, (c, _) in per_render.items()
                     if "intersect_dense_kernel" in k)
    print(f"flagship render: {n_kernels} device kernels, "
          f"{sum(us for _, us in per_render.values()) / 1e3:.3f} ms of device "
          f"time; {k1_kernels} of them K1 for {launches['intersect_dense']} "
          f"queries", flush=True)
    big_zero = torch.zeros((RUNG3_SIZE, RUNG3_SIZE, 3), device=dev)
    per_grad = device_kernels(lambda: grad_render(
        k4["scene"], k4["camera"], k4["cfg"], big_zero))
    total_us = sum(us for _, us in per_grad.values())
    k3_us = sum(us for k, (_, us) in per_grad.items() if "::bwd_" in k)
    top = sorted(per_grad.items(), key=lambda kv: -kv[1][1])[:4]
    print(f"50k material gradient {RUNG3_SIZE}x{RUNG3_SIZE} depth 3 spp 1: "
          f"{sum(c for c, _ in per_grad.values())} device kernels, "
          f"{total_us / 1e3:.1f} ms of device time, K3's kernels "
          f"{k3_us / 1e3:.3f} ms; the largest: "
          + "; ".join(f"{short_name(k)} x{c} {us / 1e3:.1f} ms"
                      for k, (c, us) in top), flush=True)

    print(f"chip_smoke: all phases ok in {time.time() - t_start:.1f} s",
          flush=True)

    # bounds at the shapes timed above (N_RAYS flagship primary rays, the
    # Cornell tri pack): every input read once, every output written once,
    # against the operations these inputs need
    n, (T, W) = N_RAYS, tri_pack.shape
    k1_bound = bound_ms(n * (24 + 4 + 1 + 17) + T * 36 + 24,
                        n * (SLAB_OPS + T * PAIR_OPS))
    k2_bound = bound_ms(n * 4 + T * W * 4 + n * W * 4, 0)
    k3_bound = bound_ms(n * 4 + n * W * 4 + T * W * 4, n * W)
    k4_bound = k4["bound"]
    print(f"bounds ({smi_line}): K1 {k1_bound[0]:.4f} ms by {k1_bound[1]}, "
          f"K2 {k2_bound[0]:.4f} ms by {k2_bound[1]}, K3 {k3_bound[0]:.4f} ms "
          f"by {k3_bound[1]}, K4 {k4_bound[0]:.4f} ms by {k4_bound[1]}",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": "intersect_dense", "route": "cuda",
         "source": "pbrpathtracer_tpu_torch/csrc/intersect.cu",
         "replaces": "pbrpathtracer_tpu/kernels/intersect_pallas.py:216",
         "launches": launches["intersect_dense"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "gather_rows_t", "route": "cuda",
         "source": "pbrpathtracer_tpu_torch/csrc/packgather.cu",
         "replaces": "pbrpathtracer_tpu/kernels/packgather_pallas.py:91",
         "launches": launches["gather_rows_t"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib_ms},
        {"name": "gather_rows_t_bwd", "route": "cuda",
         "source": "pbrpathtracer_tpu_torch/csrc/packgather.cu",
         "replaces": "pbrpathtracer_tpu/kernels/packgather_pallas.py:111",
         "launches": bwd_launches["gather_rows_t_bwd"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": k3_lib_ms},
        {"name": "intersect_list", "route": "cuda",
         "source": "pbrpathtracer_tpu_torch/csrc/bvh_intersect.cu",
         "replaces": "pbrpathtracer_tpu/kernels/intersect_pallas_list.py:357",
         "launches": k4["launches"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": None},
    ]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
