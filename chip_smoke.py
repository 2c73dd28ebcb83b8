#!/usr/bin/env python
"""Drive the PyTorch port's forward render path once on one CUDA card.

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

Then one JSON line of per-kernel results, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}`` last.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_RAYS = 262_144
CAM_POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1.0),
                up=(0.0, 1.0, 0.0), fovy=61.0)
K1_TOL = 1e-5


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
    from pbrpathtracer_tpu_torch import Camera, RenderConfig, builders, render
    from pbrpathtracer_tpu_torch.kernels import native
    from pbrpathtracer_tpu_torch.kernels.intersect import (
        intersect_dense, intersect_dense_plain)
    from pbrpathtracer_tpu_torch.kernels.packgather import (
        gather_rows_t, gather_rows_t_plain)
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
                gather_rows_t_plain)
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
    ]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
