"""The benchmark's translucent deep session cell (``perfbench/``), on the
CPU at small sizes: the frozen glass scene is the port's
``translucent_scene``, its 128-segment cap is the one the port sizes for
it, a session over it equals the deep reference
(``perfbench/reference/deep.py``) while the bfloat16 control does not, the
segment counters equal ``wavefront_occupancy``, and the per-layer readers
read them.

This file imports no JAX."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from perfbench.harness import cell, program, specs
from pbrpathtracer_tpu_torch import Camera, RenderConfig
from pbrpathtracer_tpu_torch.engine.config import suggest_max_segments
from pbrpathtracer_tpu_torch.ops.integrator import render_sample
from pbrpathtracer_tpu_torch.scene import builders
from pbrpathtracer_tpu_torch.utils import observability as obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 9
DEEP = "translucent.deep_session"
DEEP_SMALL = {"render": dict(width=32, height=32), "check_pixels": 128,
              "warmup_calls": 3}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Each test starts with no record and tracing off."""
    monkeypatch.setattr(obs, "_record", None)
    monkeypatch.setattr(obs, "_active", False)
    monkeypatch.setattr(obs, "_forced", 0)
    monkeypatch.setattr(obs, "_pending", [])


def _run(workload, overrides, seconds=0.3):
    return cell.run(workload, SEED, seconds, 0, "cpu", 0.0,
                    overrides=overrides, log=open(os.devnull, "w"))[0]


def _translucent():
    spec, builder = specs.config("translucent")
    scene = program.scene(builder.build(spec, SEED), "cpu")
    return spec, scene, program.camera(spec["camera"], "cpu")


def test_translucent_equals_the_program_builder():
    spec, ours, _ = _translucent()
    theirs = builders.translucent_scene(device="cpu")
    for part in ("geom", "materials", "textures"):
        a, b = getattr(ours, part), getattr(theirs, part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                (part, f.name)
    assert torch.equal(ours.lights, theirs.lights)
    assert ours.has_translucent and theirs.has_translucent
    assert ours.num_triangles == spec["triangles"] == 24


def test_the_cap_is_the_one_the_port_sizes_for_glass():
    spec, scene, _ = _translucent()
    mix = specs.traffic(specs.workload(DEEP)["traffic"])
    render = specs.render(spec, mix)
    assert render["max_depth"] == 8
    assert render["max_segments"] == suggest_max_segments(scene, 8) == 128
    assert 2 * render["max_depth"] + 2 < render["max_segments"]


def test_the_deep_session_equals_the_deep_reference():
    result = _run(DEEP, DEEP_SMALL)
    assert result["correct"], result["checks"]
    assert result["checks"]["px_off_share"]["value"] == 0.0


def test_the_deep_control_is_not_correct():
    ctx = cell.context(DEEP, 77, 0.0, False, "cpu", 0.0, DEEP_SMALL)
    numbers = specs.loop(ctx.traffic["loop"]).stand_in(ctx, "bf16", None, 4)
    limits = specs.limits(DEEP)
    assert any(numbers[k] > limits[k] for k in numbers), numbers


def test_a_traced_deep_run_is_correct_and_its_check_traces_no_work():
    """A traced run of the cell at 32²: the record holds the segment
    counters of its profiled passes, and the check re-traces no pass for
    the roofline readers, which this cell does not list."""
    small = {**DEEP_SMALL, "trace_skip_calls": 1, "trace_calls": 2,
             "untraced_seconds": 0.0}
    ctx = cell.context(DEEP, SEED, 0.05, True, "cpu", 0.0, small)
    loop = specs.loop(ctx.traffic["loop"])
    run = loop.run(ctx)
    run.stretch.read()
    rec = obs.last_record()
    assert rec["calls"] == 3
    assert rec["counts"]["segments"] > 3 * (2 * 8 + 2)
    numbers, works = loop.evaluate(ctx, run)
    assert numbers == {"px_off_share": 0.0} and works == []
    listed = {m["name"]: m.get("workloads", ()) for m in
              specs.benchmark()["per_layer"]}
    assert DEEP not in listed["k1_roofline_pct"]
    assert DEEP not in listed["k2_roofline_pct"]


@pytest.mark.parametrize("samples", [(0,), (3, 4)])
def test_segment_counters_match_wavefront_occupancy(samples):
    """Eager samples of the glass scene at its cap under tracing: one
    segment run per live segment, the lanes alive on entering each and the
    lanes each ran over, as ``wavefront_occupancy`` counts them."""
    _, scene, cam = _translucent()
    cfg = RenderConfig(width=12, height=10, max_depth=8, max_segments=128,
                       seed=5)
    with obs.tracing(), torch.inference_mode():
        for k in samples:
            render_sample(scene, cam, cfg, k)
    counts = obs.last_record()["counts"]
    occ = [obs.wavefront_occupancy(scene, cam, cfg, k) for k in samples]
    runs = [int((o > 0).sum()) for o in occ]
    assert all((o[:r] > 0).all() and not o[r:].any()
               for o, r in zip(occ, runs))
    assert counts["segments"] == sum(runs)
    assert counts["live_lanes"] == sum(int(o.sum()) for o in occ)
    assert counts["segment_lanes"] == sum(runs) * cfg.num_pixels
    assert counts["host_reads"] == sum(runs) + len(samples)
    assert obs.last_record()["tail_ms"] == 0.0   # no graph on the CPU


def test_the_readers_read_the_counters_and_nothing_without_them():
    readers = {m: specs.metric_reader(m) for m in
               ("occupancy_pct", "segments_per_call", "tail_ms_per_call")}
    assert all(read(None) is None for read in readers.values())
    _, scene, cam = _translucent()
    cfg = RenderConfig(width=12, height=10, max_depth=8, max_segments=128,
                       seed=5)
    s = program.session(scene, cam, cfg)
    with obs.tracing():
        s.step(2)
    counts = obs.last_record()["counts"]
    assert readers["segments_per_call"](None) == counts["segments"] / 2
    assert readers["occupancy_pct"](None) == pytest.approx(
        100.0 * counts["live_lanes"] / counts["segment_lanes"])
    assert 0 < readers["occupancy_pct"](None) < 100
    assert readers["tail_ms_per_call"](None) == 0.0


def test_the_camera_has_the_lens():
    spec, _, cam = _translucent()
    assert float(cam.aperture) == pytest.approx(0.04)
    assert float(cam.focal_dist) == pytest.approx(2.2)
    want = Camera.make(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1),
                       up=(0, 1, 0), fovy=61, focal_dist=2.2, aperture=0.04)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(cam, f.name), getattr(want, f.name)), \
            f.name


def test_the_deep_reference_loads_nothing_of_jax_or_the_program():
    probe = ("import sys; sys.path.insert(0, {!r}); "
             "import perfbench.reference.deep; "
             "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
             "{{'jax', 'jaxlib', 'pbrpathtracer_tpu', "
             "'pbrpathtracer_tpu_torch'}}))").format(ROOT)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
