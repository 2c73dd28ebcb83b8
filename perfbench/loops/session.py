"""``"loop": "session"``: progressive passes, ``RenderSession.step(1)`` in a
closed loop, accumulated over the run (``engine/session.RenderSession``).

The check: the accumulated radiance of every pass of the run (the warm-up's
and the window's) at ``check_pixels`` pixels drawn from the seed, against
the reference's sum of the same passes at those pixels. ``px_off_share`` is
the share of those pixels that differ by more than ``PIXEL_TOL`` of (1 +
the reference's value) in a channel. The traced passes are traced again by
the reference over the whole image, to count their work.
"""

from __future__ import annotations

import time

import torch

from perfbench.harness import check, program
from perfbench.harness.window import Run, Schedule, check_pixels, peak
from perfbench.reference import pathtracer as ref

PIXEL_TOL = 1e-5
FAULTS = ()


def run(ctx) -> Run:
    t = ctx.traffic
    dev = ctx.device
    scene = program.scene(ctx.arrays, dev)
    cam = program.camera(ctx.config["camera"], dev)
    cfg = program.config(ctx.render, ctx.seed)
    marks = {"scene": time.perf_counter() - ctx.t_start}
    s = program.session(scene, cam, cfg)
    for i in range(t["warmup_calls"]):
        s.step(1)
        marks[f"warm-up call {i}"] = time.perf_counter() - ctx.t_start
    before = program.counters()
    sched = Schedule(t, ctx.trace, ctx.seconds)
    stretch = sched.stretch(t["trace_calls"])
    stretch_calls, call_s = [], []
    t_win = time.perf_counter()
    setup_s = t_win - ctx.t_start
    k = 0
    while True:
        if stretch is not None and k == sched.first - 1:
            stretch.start()
        if stretch is not None and k == sched.first:
            stretch.begin()
        if stretch is not None and sched.first <= k < sched.last:
            stretch_calls.append({"sample": s.samples})
        a = time.perf_counter()
        s.step(1)
        b = time.perf_counter()
        call_s.append(b - a)
        sched.timed(k, b - a)
        k += 1
        if stretch is not None and k == sched.last:
            stretch.end()
        if sched.closes(k, b - t_win):
            break
    elapsed = b - t_win
    after = program.counters()
    pixels = check_pixels(ctx.seed, cfg.width * cfg.height, t["check_pixels"])
    rows = s.accum[pixels.to(s.accum.device).long()].cpu()
    outputs = {"passes": s.samples, "pixels": pixels, "accum": rows}
    memory = peak(dev)
    del s, scene, cam
    program.release()
    return Run(setup_s=setup_s, call_s=call_s, elapsed_s=elapsed,
               lanes=cfg.width * cfg.height, stretch=stretch,
               stretch_calls=stretch_calls, untraced_s=sched.untraced,
               outputs=outputs, memory_peak_bytes=memory,
               counters={"set-up": before, "window": after},
               setup_marks=marks)


def numbers(ctx, outputs, prec="fp32", log=None) -> dict:
    scene, cam = check.reference_scene(ctx)
    pixels = outputs["pixels"].to(ctx.device)
    acc = ref.accumulate_passes(scene, cam, check.ref_config(ctx, prec),
                                pixels, outputs["passes"]).cpu()
    off = ((outputs["accum"] - acc).abs()
           > PIXEL_TOL * (1.0 + acc.abs())).any(-1)
    if log is not None and bool(off.any()):
        at = off.nonzero().flatten()[:8]
        print(f"pixels off: {outputs['pixels'][at].tolist()}; program "
              f"{outputs['accum'][at].tolist()}; reference "
              f"{acc[at].tolist()}", file=log)
    return {"px_off_share": float(off.float().mean())}


def evaluate(ctx, run, log=None):
    """(the numbers compared, the reference's ``Work`` of each traced
    pass)."""
    result = numbers(ctx, run.outputs, log=log)
    scene, cam = check.reference_scene(ctx)
    base = check.ref_config(ctx)
    works = []
    with torch.no_grad():
        for call in run.stretch_calls:
            works.append(ref.Work())
            ref.render_image(scene, cam, base, call["sample"],
                             counter=works[-1],
                             block=base.width * base.height)
    return result, works


def stand_in(ctx, prec, fault=None, passes=0) -> dict:
    """The numbers with the reference, in ``prec``, in the program's place
    for ``passes`` passes (the control)."""
    t = ctx.traffic
    cfg = check.ref_config(ctx, prec)
    pixels = check_pixels(ctx.seed, cfg.width * cfg.height,
                          t["check_pixels"])
    scene, cam = check.reference_scene(ctx)
    acc = ref.accumulate_passes(scene, cam, cfg, pixels.to(ctx.device),
                                passes).cpu()
    return numbers(ctx, {"passes": passes, "pixels": pixels, "accum": acc})
