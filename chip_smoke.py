#!/usr/bin/env python
"""Drive the PyTorch port's render and gradient paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, any failure ends the run with a non-zero exit:

1. device   -- a CUDA card must be present (no CPU carry-on); prints
               ``nvidia-smi --query-gpu=name,power.limit``.
2. build    -- nvcc builds the kernels from ``pbrpathtracer_tpu_torch/csrc``.
3. K1       -- the closest-hit kernel against its plain torch version, on the
               card: Cornell (1 chunk) and cornell_spheres (588 triangles,
               2 chunks), flagship primary rays and random rays with random
               t_lower and alive, N = 262,144. Tolerance: hit/idx mismatches
               on at most 1e-5 of lanes, |dt|, |du|, |dv| <= 1e-5 where the
               winners agree (both are built to agree bit for bit).
4. K2       -- the pack-gather kernel against its plain version: the Cornell
               and spheres tri packs and the light pack, N = 262,144, with
               out-of-range ids. Must be bit-equal.
5. flagship -- ``render`` of 512x512 Cornell, depth 4, 1 spp: finite, >= 0,
               lit (max > 0.5); both kernels launched on that run and neither
               plain version. Then CUDA-event times of the render and of each
               kernel beside its plain version at the render's shapes.
6. goldens  -- rung1_cornell, rung2_spheres and rung4_translucent (128x128,
               16 spp) against ``tests/goldens`` by ``benchmarks.goldens.compare``.
7. K3       -- the pack-gather backward kernel against an f64 ``index_add_``
               reference at rtol 1e-6, atol 1e-5 (tests/test_packgather.py's
               tolerance): the Cornell and spheres tri packs and the light
               pack, N = 262,144, a random cotangent, out-of-range ids. Two
               calls must be bit-identical. Its plain version (f32
               ``index_add_``, atomics on the card) is reported beside it.
8. flagship fwd+bwd -- ``grad_render`` of 512x512 Cornell, depth 4, 1 spp,
               materials, zero target: finite loss and gradients; K1, K2 and
               K3 launched on that run and no plain version. Then CUDA-event
               times of the forward render and of fwd+bwd with
               ``remat_segments`` "hits", "off" and "all", the peak device
               memory of each, and K3 beside its plain version at the
               backward's shapes.
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

Then one JSON line of per-kernel results, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}`` last.
"""

import dataclasses
import json
import os
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
K3_RTOL, K3_ATOL = 1e-6, 1e-5


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


def compare_k1(name, geom, ro, rd, t_lower, alive):
    import torch
    from pbrpathtracer_tpu_torch.kernels.intersect import (
        intersect_dense, intersect_dense_plain)
    kh, ki, kt, ku, kv = intersect_dense(geom, ro, rd, t_lower, alive)
    ph, pi, pt, pu, pv = intersect_dense_plain(geom, ro, rd, t_lower, alive)
    torch.cuda.synchronize()
    mism = (kh != ph) | (ki != pi)
    n_mism = int(mism.sum())
    agree = ~mism
    err = max(float((a - b)[agree].abs().max())
              for a, b in ((kt, pt), (ku, pu), (kv, pv)))
    dead_ok = bool((~kh[~alive]).all() and (ki[~alive] == 0).all()
                   and (kt[~alive] == 0).all())
    print(f"K1 {name}: lanes={ro.shape[0]} hits={int(kh.sum())} "
          f"hit/idx mismatches={n_mism} max|dt,du,dv|={err:.3g} "
          f"dead-lanes-clean={dead_ok}", flush=True)
    require(n_mism <= K1_TOL * ro.shape[0], f"K1 {name}: {n_mism} mismatches")
    require(err <= K1_TOL, f"K1 {name}: max error {err}")
    require(dead_ok, f"K1 {name}: dead lanes not a clean miss")
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


def compare_k3(name, table, rs, dev):
    """K3 on N_RAYS lanes with out-of-range ids against f64; two calls
    bit-identical. Returns (max |kernel - f64|, max |plain - f64|)."""
    import torch
    from pbrpathtracer_tpu_torch.kernels.packgather import (
        gather_rows_t_bwd, gather_rows_t_bwd_plain)
    T, W = table.shape
    idx = rs.randint(0, T, N_RAYS)
    idx[rs.uniform(size=N_RAYS) < 0.01] = -1
    idx[rs.uniform(size=N_RAYS) < 0.01] = T + 3
    idx_t = torch.tensor(idx, dtype=torch.int32, device=dev)
    cot = torch.tensor(rs.normal(size=(W, N_RAYS)), dtype=torch.float32,
                       device=dev)
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
    print(f"K3 {name}: T={T} W={W} N={N_RAYS} max|k-f64|={err:.3g} "
          f"max|plain-f64|={plain_err:.3g} within tol={close} "
          f"bit-identical repeat={same}", flush=True)
    require(close, f"K3 {name}: off the f64 reference by {err}")
    require(same, f"K3 {name}: two calls differ")
    return err


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


def main():
    import numpy as np
    import torch

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
    for sname, scene in (("cornell", cornell), ("spheres", spheres)):
        k1_err = max(k1_err, compare_k1(f"{sname}/primary", scene.geom,
                                        ro, rd, zeros, ones))
        k1_err = max(k1_err, compare_k1(f"{sname}/random", scene.geom,
                                        *random_rays(rs, N_RAYS, dev)))

    # ---- 4. K2 vs plain ----
    k2_err = 0.0
    for pname, table in (("cornell tri pack", sp.build_tri_pack(cornell)),
                         ("spheres tri pack", sp.build_tri_pack(spheres)),
                         ("light pack", sp.build_light_pack(cornell))):
        T = table.shape[0]
        idx = rs.randint(0, T, N_RAYS)
        idx[rs.uniform(size=N_RAYS) < 0.01] = -1
        idx[rs.uniform(size=N_RAYS) < 0.01] = T + 3
        idx_t = torch.tensor(idx, dtype=torch.int32, device=dev)
        k = gather_rows_t(table, idx_t)
        p = gather_rows_t_plain(table, idx_t)
        torch.cuda.synchronize()
        equal = torch.equal(k, p)
        err = float((k - p).abs().max())
        k2_err = max(k2_err, err)
        print(f"K2 {pname}: T={T} W={table.shape[1]} N={N_RAYS} "
              f"bit-equal={equal} max|d|={err:.3g}", flush=True)
        require(equal, f"K2 {pname}: not bit-equal")

    # ---- 5. flagship ----
    cfg = RenderConfig(width=512, height=512, max_depth=4, spp=1, seed=0)
    counters = (intersect_dense, intersect_dense_plain, gather_rows_t,
                gather_rows_t_plain, gather_rows_t_bwd,
                gather_rows_t_bwd_plain)
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
    print(f"timing ({smi_line}): render {render_ms:.3f} ms | "
          f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms | "
          f"K2 {k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms", flush=True)

    # ---- 6. goldens ----
    from benchmarks.goldens import GOLDEN_DIR, compare
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
        k3_err = max(k3_err, compare_k3(pname, table, rs, dev))

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
    print(f"timing K3 ({smi_line}): Cornell tri pack, flagship primary hit "
          f"ids: {k3_ms:.4f} / {k3_ms_2:.4f} ms vs plain {k3_plain_ms:.4f} ms",
          flush=True)

    # ---- 9-11. gradcheck, fit, texture gradients ----
    gradcheck_phase(cornell, camera)
    fit_phase(cornell, camera)
    texture_grad_phase(camera, dev)

    print(json.dumps({"kernels": [
        {"name": "intersect_dense", "route": "cuda",
         "source": "pbrpathtracer_tpu_torch/csrc/intersect.cu",
         "replaces": "pbrpathtracer_tpu/kernels/intersect_pallas.py:216",
         "launches": launches["intersect_dense"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "gather_rows_t", "route": "cuda",
         "source": "pbrpathtracer_tpu_torch/csrc/packgather.cu",
         "replaces": "pbrpathtracer_tpu/kernels/packgather_pallas.py:91",
         "launches": launches["gather_rows_t"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "gather_rows_t_bwd", "route": "cuda",
         "source": "pbrpathtracer_tpu_torch/csrc/packgather.cu",
         "replaces": "pbrpathtracer_tpu/kernels/packgather_pallas.py:111",
         "launches": bwd_launches["gather_rows_t_bwd"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
