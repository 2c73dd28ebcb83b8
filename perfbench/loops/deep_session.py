"""``"loop": "deep_session"``: the session loop (``session.py``: passes of
``RenderSession.step(1)`` in a closed loop, accumulated over the run) over
a deep wavefront, whose render keys include ``max_segments``, a cap that
the shared reference refuses. The check and the control are
``session.py``'s, with the reference of ``reference/deep.py``, which
follows the cap: the accumulated radiance of every pass of the run at
``check_pixels`` pixels drawn from the seed, ``px_off_share`` the share of
them off by more than ``session.PIXEL_TOL`` of (1 + the reference's value)
in a channel.
"""

from __future__ import annotations

from perfbench.harness import check
from perfbench.harness.window import check_pixels
from perfbench.loops import session
from perfbench.reference import deep, pathtracer as ref

FAULTS = ()
run = session.run


def _config(ctx, prec="fp32"):
    return deep.Config.of(ctx.render, ctx.seed, prec)


def numbers(ctx, outputs, prec="fp32", log=None) -> dict:
    scene, cam = check.reference_scene(ctx)
    pixels = outputs["pixels"].to(ctx.device)
    acc = ref.accumulate_passes(scene, cam, _config(ctx, prec), pixels,
                                outputs["passes"]).cpu()
    off = ((outputs["accum"] - acc).abs()
           > session.PIXEL_TOL * (1.0 + acc.abs())).any(-1)
    if log is not None and bool(off.any()):
        at = off.nonzero().flatten()[:8]
        print(f"pixels off: {outputs['pixels'][at].tolist()}; program "
              f"{outputs['accum'][at].tolist()}; reference "
              f"{acc[at].tolist()}", file=log)
    return {"px_off_share": float(off.float().mean())}


def evaluate(ctx, run, log=None):
    """(the numbers compared, no ``Work``): no metric of this cell reads the
    reference's work of the traced passes, and re-tracing them at the cap
    would cost a traced run a minute or more."""
    return numbers(ctx, run.outputs, log=log), []


def stand_in(ctx, prec, fault=None, passes=0) -> dict:
    """The numbers with the reference, in ``prec``, in the program's place
    for ``passes`` passes (the control)."""
    cfg = _config(ctx, prec)
    pixels = check_pixels(ctx.seed, cfg.width * cfg.height,
                          ctx.traffic["check_pixels"])
    scene, cam = check.reference_scene(ctx)
    acc = ref.accumulate_passes(scene, cam, cfg, pixels.to(ctx.device),
                                passes).cpu()
    return numbers(ctx, {"passes": passes, "pixels": pixels, "accum": acc})
