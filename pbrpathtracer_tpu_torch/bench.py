"""Benchmark: forward+backward rays/s per card on the flagship workload, as
``pbrpathtracer_tpu.bench``.

    python -m pbrpathtracer_tpu_torch bench

BASELINE.json metric: "rays/s/chip fwd+bwd at 1spp bounce-4", on the 512²
Cornell box with the off-axis camera, depth 4, 1 spp; the forward is
``render_sample``, the fwd+bwd ``diff.loss.loss_and_grad`` over the
material parameters against a zero target. It runs on the CUDA card only:
without one it raises torch's own error before any work. The counting
(``count_rays``, ``roofline_costs``) takes any device, so that it can be
checked on the CPU.

Timing: a QUEUED host loop, as the JAX package's: R back-to-back steps and
one final ``torch.cuda.synchronize()``, at R and 2R, differenced, so that
fixed costs (the first launch, the queue's ramp) cancel. In JAX that slope
is device throughput, because a whole step queues on the device. The
port's forward steps replay the sample captured in CUDA graphs
(``engine/compiled.py``), as the JAX bench runs ``fwd_jit``: a graph per
segment, the seed a device value, and between two segments one flag read
back from the card (``ops/integrator.drive``), so the forward slope is the
card's time plus one graph launch and one read-back per segment. The
fwd+bwd steps replay the fwd+bwd captured in one CUDA graph
(``engine.compiled.GRADS``), as the JAX bench runs ``fb_jit``: the
parameters, target and seed copied in, one graph launch, and one flag read
back after it (whether the captured segments were enough), so its slope is
the card's time plus that one read-back per step. Beside them,
``device_ms_fwd`` and
``device_ms_fwdbwd`` are the card's busy time in one step: the sum of its
kernels' durations in a ``torch.profiler`` trace (or, where the profiler
delivers no device events, CUDA events around one step, idle time
included; ``device_ms_source`` says which).

Speed of light: ``utils/roofline.py`` counts what one step moves and
computes, the eager program's operators by a ``TorchDispatchMode`` and the
hand-written kernels from their recorded launch shapes, and prices them at
the H100's published peaks; ``fraction_of_roofline`` is that bound over the
measured slope. As in the JAX package the count is taken on a canonical
schedule: the measured number of LIVE segments only (the render skips the
all-dead tail), and for fwd+bwd ``remat_segments="hits"``, so that every
closest-hit query runs once (its shading is recomputed in the backward,
which the timed default schedule, "off", does not do: the fwd+bwd bound
prices a little more work than the timed step issues).

``vs_baseline``: OUR forward paths/s on the flagship against the reference
binary's paths/s in ``REF_BASELINE.json`` at the repository's root (a
measured run of the compiled C++ reference on a CPU), projected to a
16-core desktop (13 worker threads, the reference's own heuristic); the
~5e6 rays/s estimate only where that file is absent, marked
``vs_baseline_is_estimate``.

Ray accounting: per sample and segment one bounce closest-hit query and one
NEE shadow query per LIVE lane; dead lanes are not credited.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extras"}.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from .diff.loss import eager_loss_and_grad, loss_and_grad
from .diff.params import get_params
from .engine.compiled import SAMPLES
from .engine.config import RenderConfig
from .ops.integrator import render_sample
from .scene.big_scenes import mesh_scene, mesh_scene_camera, million_tri_scene
from .scene.builders import cornell_box, translucent_scene
from .scene.scene import Camera
from .utils import observability
from .utils.observability import rays_per_sample, wavefront_occupancy
from .utils.roofline import count_program

REFERENCE_CPU_RAYS_PER_S = 5.0e6  # fallback estimate, see module docstring

WIDTH = HEIGHT = 512
DEPTH = 4
SPP = 1
# Steps per timing loop (R; the loop also runs 2R), as the JAX bench's
FWD_REPS, FWDBWD_REPS, DEEP_REPS, BIG_REPS = 24, 12, 12, 3
CAMERA_POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                   up=(0, 1, 0), fovy=61)


def reference_baseline():
    """Measured reference-binary throughput from REF_BASELINE.json.

    Returns (paths/s projected to a 16-core desktop, info dict) or (None,
    {...}) when no measurement exists. The reference reserves 3 threads for
    its UI, so a 16-core desktop runs 13 workers; the recorded measurement
    is scaled per core accordingly."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "REF_BASELINE.json")
    estimate = {"vs_baseline_is_estimate": True,
                "baseline_assumption": "ref CPU ~5e6 rays/s (16-core OpenMP)"}
    if not os.path.exists(path):
        return None, estimate
    with open(path) as f:
        data = json.load(f)
    cfg = data.get("configs", {}).get("cornell")
    if not cfg:
        return None, estimate
    ref = cfg["ref"]
    threads = ref.get("threads") or data["host"]["ref_threads"]
    per_core = ref["paths_per_s"] / max(threads, 1)
    ref_16core = per_core * 13  # 16-core desktop -> 13 worker threads
    return ref_16core, {
        "vs_baseline_is_estimate": False,
        "baseline_source": "REF_BASELINE.json (compiled reference core, "
                           "benchmarks/refbench)",
        "ref_measured_paths_per_s": ref["paths_per_s"],
        "ref_measured_threads": threads,
        "ref_paths_per_s_16core_proj": round(ref_16core, 1),
        "ref_workload": cfg.get("workload"),
        "ref_parity_ok": cfg.get("parity", {}).get("parity_ok"),
    }


def flagship(device="cuda", width=WIDTH, height=HEIGHT):
    """The flagship workload on ``device``: (scene, camera, cfg)."""
    cfg = RenderConfig(width=width, height=height, max_depth=DEPTH, spp=SPP,
                       seed=0)
    return (cornell_box(device=device), Camera.make(**CAMERA_POSE).to(device),
            cfg)


def fwd_step(scene, camera, cfg):
    """step(seed): one forward sample, reduced to a scalar. On the card it
    goes through the captured sample with the seed as a device value (the
    first step of a scene is eager, the second captures, the later ones
    replay)."""
    if scene.device.type != "cuda":
        return lambda s: torch.sum(render_sample(scene, camera, cfg, 0,
                                                 seed=s))

    def step(s):
        seed = torch.full((), s, dtype=torch.int64, device=scene.device)
        return SAMPLES.sample(scene, camera, cfg, 0, seed, consume=torch.sum)
    return step


def fwdbwd_step(scene, camera, cfg, params, target):
    """step(seed): the loss and its gradients w.r.t. ``params``. On the
    card it replays the captured fwd+bwd with the seed as a device value
    (the first step of a scene is eager, the second captures, the later
    ones replay)."""
    return lambda s: loss_and_grad(params, scene, camera, cfg, target, seed=s)


def count_rays(scene, camera, cfg):
    """(live lanes per segment, rays per sample, live segments) of sample 0,
    on the scene's device."""
    live = wavefront_occupancy(scene, camera, cfg)
    return live, rays_per_sample(live), int((live > 0).sum())


def roofline_costs(scene, camera, cfg, live_segments):
    """``utils.roofline.StepCost`` of the forward and of the fwd+bwd on the
    canonical schedule (module docstring), on the scene's device."""
    canon = cfg.replace(skip_dead_segments=False,
                        max_segments=max(live_segments, 1))
    # the eager forward: a replay dispatches no operator to count
    _, fwd = count_program(
        lambda: torch.sum(render_sample(scene, camera, canon, 0, seed=0)))
    params = get_params(scene, camera, materials=True)
    target = torch.zeros((cfg.height, cfg.width, 3), device=scene.device)
    # and the eager fwd+bwd
    _, fwdbwd = count_program(lambda: eager_loss_and_grad(
        params, scene, camera, canon.replace(remat_segments="hits"), target,
        seed=0))
    return fwd, fwdbwd


def _require_card() -> torch.device:
    """The current CUDA device; torch's own error where there is none."""
    if not torch.cuda.is_available():
        torch.cuda.init()   # raises: no CUDA build of torch, or no card
        raise RuntimeError("bench measures the CUDA card; none is available")
    return torch.device("cuda", torch.cuda.current_device())


def step_counts(step) -> dict:
    """Run ``step(0)`` once (the timing's warm-up) and return what it
    counted (``utils.observability.counted``): its kernel launches by
    wrapper, graph launches, host reads and segments."""
    _, counts = observability.counted(lambda: step(0))
    torch.cuda.synchronize()
    return counts


def queued_slope(step, reps: int) -> float:
    """Seconds per step: the R-vs-2R slope of a queued loop of ``step``."""
    def run(n):
        step(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    t1 = run(reps)
    t2 = run(2 * reps)
    return (t2 - t1) / reps


def device_ms(step) -> tuple[float, int, str]:
    """(milliseconds, kernels, source) of the card's work in one
    ``step(0)``: the sum of its kernels' durations in a ``torch.profiler``
    trace and their number, or CUDA events around the step (kernels 0)
    where the profiler delivers no device events."""
    from torch.profiler import ProfilerActivity, profile
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(0)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == cuda]
    if us:
        return sum(us) / 1e3, len(us), "torch.profiler kernel time"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(0)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), 0, "cuda events (idle time included)"


def _power_limit() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    return line.rsplit(",", 1)[-1].strip()


def measure_flagship(extra_workloads=True, big_scenes=None):
    """Run the flagship measurement on the card; returns the result dict.
    ``big_scenes`` may hold already-built scenes {"50k": ..., "1M": ...}
    for the big-scene workloads; the missing ones are built here."""
    dev = _require_card()
    scene, camera, cfg = flagship(dev)
    n_pix = WIDTH * HEIGHT

    live, rays_per_sample, live_segments = count_rays(scene, camera, cfg)
    params = get_params(scene, camera, materials=True)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    fwd = fwd_step(scene, camera, cfg)
    fwdbwd = fwdbwd_step(scene, camera, cfg, params, target)
    launches = {"fwd": step_counts(fwd), "fwdbwd": step_counts(fwdbwd)}
    t_fwd = queued_slope(fwd, FWD_REPS)
    t_fwdbwd = queued_slope(fwdbwd, FWDBWD_REPS)

    cost_fwd, cost_fb = roofline_costs(scene, camera, cfg, live_segments)
    roof_fwd, roof_fb = ({
        **cost.roofline().as_dict(t), "launches": cost.launches,
        "kernel_bytes_GB": round(cost.kernel_bytes / 1e9, 3),
        "operator_calls": cost.operator_calls}
        for cost, t in ((cost_fwd, t_fwd), (cost_fb, t_fwdbwd)))

    deep, bigscene = {}, {}
    if extra_workloads:
        # the deep translucent workload: depth 8, 18 segments, occupancy
        # decaying to ~1%; one forward measurement, same timing
        dscene = translucent_scene(device=dev)
        dcam = Camera.make(**CAMERA_POSE, focal_dist=2.2,
                           aperture=0.04).to(dev)
        dcfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=8, spp=1,
                            seed=0)
        dfwd = fwd_step(dscene, dcam, dcfg)
        launches["deep_fwd"] = step_counts(dfwd)
        t_deep = queued_slope(dfwd, DEEP_REPS)
        occ = wavefront_occupancy(dscene, dcam, dcfg)
        deep = {
            "deep_t_fwd_ms": round(t_deep * 1e3, 3),
            "deep_rays_per_s": round(2 * int(occ.sum()) / t_deep, 1),
            "deep_config": f"{WIDTH}x{HEIGHT}@1spp depth8 translucent "
                           f"({dcfg.resolved_max_segments()} segments)",
        }
        # big-scene throughput: the 50k and 1M meshes with their BVHs (K4),
        # depth 3; a failure fails the run
        mcam = mesh_scene_camera().to(dev)
        bcfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3, spp=1)
        given = big_scenes or {}
        for label, make in (("50k", lambda: mesh_scene(50_000, device=dev)),
                            ("1M", lambda: million_tri_scene(device=dev))):
            bscene = given[label] if label in given else make()
            bstep = fwd_step(bscene, mcam, bcfg)
            launches[f"{label}_fwd"] = step_counts(bstep)
            t_b = queued_slope(bstep, BIG_REPS)
            bigscene[f"paths_per_s_{label}tris"] = round(n_pix / t_b, 1)
            bigscene[f"t_sample_{label}tris_ms"] = round(t_b * 1e3, 1)
            del bscene, bstep

    # the card's own time per step, after every timing loop: no profiler
    # session precedes a slope
    dev_fwd, kernels_fwd, source = device_ms(fwd)
    dev_fwdbwd, kernels_fwdbwd, _ = device_ms(fwdbwd)

    rays_fwd = rays_per_sample / t_fwd
    value = rays_per_sample / t_fwdbwd
    ref_paths, ref_info = reference_baseline()
    if ref_paths is not None:
        vs_baseline = (n_pix * SPP / t_fwd) / ref_paths
    else:
        vs_baseline = value / REFERENCE_CPU_RAYS_PER_S

    return {
        "metric": "rays_per_s_per_chip_fwd_bwd",
        "value": round(value, 1),
        "unit": "rays/s",
        "vs_baseline": round(vs_baseline, 3),
        "extras": {
            "rays_per_s_fwd": round(rays_fwd, 1),
            "paths_per_s_fwd": round(n_pix * SPP / t_fwd, 1),
            "t_fwd_ms": round(t_fwd * 1e3, 3),
            "t_fwdbwd_ms": round(t_fwdbwd * 1e3, 3),
            "device_ms_fwd": round(dev_fwd, 3),
            "device_ms_fwdbwd": round(dev_fwdbwd, 3),
            "device_ms_source": source,
            "device_kernels_fwd": kernels_fwd,
            "device_kernels_fwdbwd": kernels_fwdbwd,
            "timing": "queued-loop R-vs-2R slope of host wall time (fixed "
                      "costs cancelled); the forward steps replay the "
                      "sample captured in CUDA graphs (one graph and one "
                      "flag read back per segment, the seed a device "
                      "value); the fwd+bwd steps replay the fwd+bwd "
                      "captured in one CUDA graph (one flag read back per "
                      "step)",
            "roofline_graph": "canonical: the live segments only, "
                              "remat-hits for fwd+bwd; eager operators by "
                              "TorchDispatchMode, K1-K4 from their launch "
                              "shapes (see module docstring)",
            "roofline_fwd": roof_fwd,
            "roofline_fwdbwd": roof_fb,
            "live_per_segment": live.tolist(),
            "launches_per_step": launches,
            "config": f"{WIDTH}x{HEIGHT}@{SPP}spp depth{DEPTH} cornell",
            "device": torch.cuda.get_device_name(dev),
            "power_limit": _power_limit(),
            **ref_info,
            **bigscene,
            **deep,
        },
    }


def main():
    print(json.dumps(measure_flagship()))


if __name__ == "__main__":
    main()
