"""``"loop": "fit"``: the steps of ``diff.fit.fit`` in a closed loop (Adam at
``lr``, the clip after each step, step s seeded ``cfg.seed + s``), against
a target made from the seed. A step's callback marks its end; the loss is
read to the host inside the step.

The check holds the window's own steps: the first ``reference_steps``
steps after the ``warmup_calls`` warm-up steps (an eager step, a capture,
a first replay), which replay the captured fwd+bwd as every later step of
the window does. The reference follows the fit from the same scene,
target and seeds through those steps. ``loss_gap`` is the widest relative
gap of a step's loss, over every step up to the last compared;
``grad_gap`` the worst leaf's gap between the norms of the gradient that
the optimizer got at the first window step, and ``step_gap`` that of the
change of the parameters over the compared window steps (each side from
its own parameters before them), each over the larger of the reference's
norm of that leaf and the median leaf's. Leaves whose reference gradient
is under a thousandth of the median leaf's (no gradient reaches them) are
left out; the median is over the leaves with a gradient.

Faults that ``stand_in`` plants in the reference put in the program's
place, from the first window step on: ``half`` (the loss over half the
pixels, their mean), ``altered`` (each loss read 1% high).
"""

from __future__ import annotations

import time

from perfbench.harness import check, program
from perfbench.harness.window import Run, Schedule, peak, target_image
from perfbench.reference import pathtracer as ref

FAULTS = ("half", "altered")


class WindowClosed(Exception):
    """Raised from the fit's callback once the window has closed."""


def _clone(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def run(ctx) -> Run:
    t = ctx.traffic
    dev = ctx.device
    scene = program.scene(ctx.arrays, dev)
    cam = program.camera(ctx.config["camera"], dev)
    cfg = program.config(ctx.render, ctx.seed)
    target = target_image(ctx.seed, t["target"], cfg.height, cfg.width, dev)
    marks = {"scene": time.perf_counter() - ctx.t_start}
    which = ctx.config["fit"]
    warm, n_ref = t["warmup_calls"], t["reference_steps"]
    compared = warm + n_ref - 1          # the last step compared
    sched = Schedule(t, ctx.trace, ctx.seconds)
    first, last = warm + sched.first, warm + sched.last
    stretch = sched.stretch(t["trace_calls"])
    st = {"losses": [], "call_s": [], "stretch_calls": []}

    def callback(step, loss, params):
        now = time.perf_counter()
        if step < warm:
            marks[f"warm-up call {step}"] = now - ctx.t_start
        if step <= compared:
            st["losses"].append(loss)
        if step == warm - 1:
            st["before"] = _clone(params)
        if step == warm:
            st["grad"] = {k: p.grad.detach().clone()
                          for k, p in params.items()}
        if step == compared:
            st["after"] = _clone(params)
        if stretch is not None and first <= step < last:
            st["stretch_calls"].append({"step": step})
        if step == warm - 1:
            st["t_win"] = now
            st["before_counts"] = program.counters()
        elif step >= warm:
            st["call_s"].append(now - st["last"])
            sched.timed(step - warm, now - st["last"])
        st["last"] = now
        if stretch is not None and step == first - 2:
            stretch.start()
        if stretch is not None and step == first - 1:
            stretch.begin()
        if stretch is not None and step == last - 1:
            stretch.end()
        if step >= warm and sched.closes(step - warm + 1, now - st["t_win"],
                                         more=n_ref):
            raise WindowClosed
        if step == warm - 1:
            st["t_win"] = st["last"] = time.perf_counter()

    try:
        program.fit(scene, cam, cfg, target, t["lr"], which["materials"],
                    which["textures"], callback)
    except WindowClosed:
        pass
    elapsed = st["last"] - st["t_win"]
    after = program.counters()
    memory = peak(dev)
    outputs = {"losses": st["losses"], "grad": st["grad"],
               "before": st["before"], "after": st["after"],
               "target": target}
    del scene, cam
    program.release()
    return Run(setup_s=st["t_win"] - ctx.t_start, call_s=st["call_s"],
               elapsed_s=elapsed, lanes=cfg.width * cfg.height * cfg.spp,
               stretch=stretch, stretch_calls=st["stretch_calls"],
               untraced_s=sched.untraced, outputs=outputs,
               memory_peak_bytes=memory,
               counters={"set-up": st["before_counts"], "window": after},
               setup_marks=marks)


def planted(fault, base_seed, from_step):
    """The reference's ``loss_and_grad`` with ``fault`` planted in the
    steps from ``from_step`` on (a step's seed is ``base_seed + step``)."""
    plain = ref.loss_and_grad
    if fault is None:
        return plain

    def loss_and_grad(scene, camera, cfg, target, params, **kw):
        if cfg.seed - base_seed < from_step:
            return plain(scene, camera, cfg, target, params, **kw)
        if fault == "half":
            n = cfg.width * cfg.height
            return plain(scene, camera, cfg, target, params,
                         keep=slice(0, n // 2), **kw)
        if fault == "altered":
            loss, grads = plain(scene, camera, cfg, target, params, **kw)
            return loss * 1.01, grads
        raise ValueError(f"no fault {fault!r}")
    return loss_and_grad


def reference(ctx, target, prec="fp32", counters=None, fault=None):
    """The reference's fit through the compared steps and on through the
    steps of ``counters`` ({step: Work}), whose forwards it counts: its
    outputs, keyed as the run's."""
    scene, cam = check.reference_scene(ctx)
    which = ctx.config["fit"]
    params = ref.fit_params(scene, which["materials"], which["textures"])
    t = ctx.traffic
    warm, n_ref = t["warmup_calls"], t["reference_steps"]
    steps = max([warm + n_ref] + [s + 1 for s in counters or {}])
    losses, grads, kept = ref.fit_steps(
        scene, cam, check.ref_config(ctx, prec), target.to(ctx.device),
        params, steps, t["lr"], ctx.seed, keep_grads=(warm,),
        keep_params=(warm, warm + n_ref), counters=counters,
        count_backward=which["materials"],
        loss_fn=planted(fault, ctx.seed, warm))
    return {"losses": losses[:warm + n_ref], "grad": grads[warm],
            "before": kept[warm], "after": kept[warm + n_ref]}


def numbers(ctx, got, want, log=None) -> dict:
    """The compared numbers of the outputs ``got`` against the reference's
    ``want``."""
    g_ref, g_got = check.norms(want["grad"]), check.norms(got["grad"])
    kept = check.leaves_with_gradient(g_ref)
    if log is not None:
        print(f"leaves compared: {kept}; left out: "
              f"{sorted(set(g_ref) - set(kept))}", file=log)

    def change(o):
        return check.norms({k: o["after"][k].to(ctx.device)
                            - o["before"][k].to(ctx.device)
                            for k in o["after"]})
    d_ref, d_got = change(want), change(got)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got["losses"], want["losses"]))
    if len(got["losses"]) < len(want["losses"]):
        loss_gap = float("inf")
    return {"loss_gap": loss_gap,
            "grad_gap": check.worst_leaf_gap(g_got, g_ref, kept),
            "step_gap": check.worst_leaf_gap(d_got, d_ref, kept)}


def evaluate(ctx, run, log=None):
    """(the numbers compared, the reference's ``Work`` of each traced
    step: the reference's own step of the same index)."""
    counters = {c["step"]: ref.Work() for c in run.stretch_calls}
    want = reference(ctx, run.outputs["target"], counters=counters)
    result = numbers(ctx, run.outputs, want, log)
    return result, [counters[c["step"]] for c in run.stretch_calls]


def stand_in(ctx, prec, fault=None, passes=0) -> dict:
    """The numbers with the reference, in ``prec`` and with ``fault``
    planted, in the program's place."""
    t = ctx.traffic
    r = ctx.render
    target = target_image(ctx.seed, t["target"], r["height"], r["width"],
                          ctx.device)
    got = reference(ctx, target, prec, fault=fault)
    return numbers(ctx, got, reference(ctx, target))
