"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a small size (the harness's look for a card skipped):
a sound run is correct; the control (the reference with its tables and
state stored in bfloat16, in the program's place) and each fault that a
cell can have, planted under the timed path, come out not correct: in a
fit, from its first step on, and from its first window step on (the
steps that replay the captured fwd+bwd on the card)."""

import os
import types

import pytest
import torch

from perfbench.harness import cell, specs
import pbrpathtracer_tpu_torch.diff.fit as fit_mod
import pbrpathtracer_tpu_torch.diff.loss as loss_mod
import pbrpathtracer_tpu_torch.engine.session as session_mod

SMALL = {"render": dict(width=32, height=24), "check_pixels": 128}
CELLS = ["cornell.fit", "mesh50k.fit", "cornell.session", "mesh50k.session"]
FITS = [w for w in CELLS if w.endswith(".fit")]


def _run(workload, seed=2 ** 31 + 9):
    return cell.run(workload, seed, 0.3, 0, "cpu", 0.0, overrides=SMALL,
                    log=open(os.devnull, "w"))[0]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The bf16-storage reference in the program's place."""
    ctx = cell.context(workload, 77, 0.0, False, "cpu", 0.0, SMALL)
    loop = specs.loop(ctx.traffic["loop"])
    numbers = loop.stand_in(ctx, "bf16", None, 20)
    limits = specs.limits(workload)
    assert any(numbers[k] > limits[k] for k in numbers), numbers


def _warmup_calls(workload):
    return specs.traffic(specs.workload(workload)["traffic"])["warmup_calls"]


def _fit_faults(monkeypatch, fault, from_step=0):
    """``fault`` planted in the program's fit from step ``from_step`` on
    (a step's seed is ``cfg.seed + step``)."""
    if fault == "unchanged":
        adam = torch.optim.Adam

        class Frozen(adam):
            """Adam that leaves the parameters as they are from the
            ``from_step``-th step on."""
            steps = 0

            def step(self, closure=None):
                Frozen.steps += 1
                if Frozen.steps <= from_step:
                    return super().step(closure)
                return None
        monkeypatch.setattr(fit_mod, "torch", types.SimpleNamespace(
            optim=types.SimpleNamespace(Adam=Frozen), no_grad=torch.no_grad))
    elif fault == "half":
        plain = loss_mod.sampled_loss

        def half(scene, camera, cfg, target, seed=None, counts=None,
                 pixel_idx=None, divisor=None):
            if seed is None or seed - cfg.seed < from_step:
                return plain(scene, camera, cfg, target, seed, counts,
                             pixel_idx, divisor)
            n = cfg.width * cfg.height
            idx = torch.arange(n // 2, dtype=torch.int32)
            return plain(scene, camera, cfg, target.reshape(-1, 3)[:n // 2],
                         seed, counts, idx, None)
        monkeypatch.setattr(loss_mod, "sampled_loss", half)
    else:
        plain = fit_mod.loss_and_grad

        def altered(params, scene, camera, cfg, target, seed=None, **kw):
            loss, grads = plain(params, scene, camera, cfg, target,
                                seed=seed, **kw)
            if seed is not None and seed - cfg.seed >= from_step:
                loss = loss * 1.01
            return loss, grads
        monkeypatch.setattr(fit_mod, "loss_and_grad", altered)


def _session_faults(monkeypatch, fault):
    plain = session_mod.render_accumulate

    def planted(scene, camera, cfg, accum, start, n, seed=None):
        new = plain(scene, camera, cfg, accum, start, n, seed)
        if fault == "unchanged":
            return accum
        if fault == "half":
            half = accum.shape[0] // 2
            return torch.cat([new[:half], accum[half:]])
        return accum + (new - accum) * 1.001
    monkeypatch.setattr(session_mod, "render_accumulate", planted)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_is_not_correct(monkeypatch, workload, fault):
    if workload.endswith(".fit"):
        _fit_faults(monkeypatch, fault)
    else:
        _session_faults(monkeypatch, fault)
    result = _run(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", FITS)
def test_a_fault_from_the_first_window_step_is_not_correct(
        monkeypatch, workload, fault):
    _fit_faults(monkeypatch, fault, from_step=_warmup_calls(workload))
    result = _run(workload)
    assert not result["correct"], result["checks"]
