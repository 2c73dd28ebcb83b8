"""The harness finds a configuration, a traffic mix, a cell's limits and a
per-layer metric by name, from files of their own: a later PR adds a cell
by adding files, without editing one."""

import json
import os
import shutil

from perfbench.harness import cell, specs


TWICE = """
from perfbench.harness import program
from perfbench.loops import session

FAULTS = ()
evaluate, stand_in = session.evaluate, session.stand_in


def run(ctx):
    plain = program.session

    def twice(*args):
        s = plain(*args)
        step = s.step
        s.step = lambda n=1: step(2 * n)
        return s
    program.session = twice
    try:
        r = session.run(ctx)
    finally:
        program.session = plain
    r.lanes *= 2
    with open(ctx.traffic["marker"], "w") as f:
        f.write(str(r.outputs["passes"]))
    return r
"""


def _bench_with_new_files(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(specs.BENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = specs.benchmark()
    # a new configuration: the box, its camera moved
    spec = json.loads((base / "configs" / "cornell.json").read_text())
    spec.update(name="cornell_low", builder="cornell.py")
    spec["camera"]["pos"] = [0.0, -0.3, 0.3]
    (base / "configs" / "cornell_low.json").write_text(json.dumps(spec))
    # a new traffic mix: shorter passes, on a new loop that renders two
    # passes a call
    mix = json.loads((base / "traffic" / "session.json").read_text())
    mix.update(loop="twice", check_pixels=16, trace_skip_calls=0,
               trace_calls=1, marker=str(tmp_path / "passes"))
    mix["render"].update(width=16, height=8)
    (base / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (base / "loops" / "twice.py").write_text(TWICE)
    (base / "limits" / "cornell_low.tiny.json").write_text(
        json.dumps({"px_off_share": {"limit": 0.0}}))
    # a new per-layer metric
    (base / "metrics" / "calls_in_stretch.py").write_text(
        "def read(ctx):\n    return float(ctx.reading.calls)\n")
    bench["configs"].append({"name": "cornell_low", "source": "test",
                             "file": "perfbench/configs/cornell_low.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "cornell_low.tiny",
                               "config": "cornell_low", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_in_stretch", "unit": "calls",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "paths_per_s",
                               "workloads": ["cornell_low.tiny"]})
    return bench, str(base)


def test_new_files_make_a_new_cell(tmp_path):
    bench, base = _bench_with_new_files(tmp_path)
    result, compared = cell.run("cornell_low.tiny", 5, 0.2, 0, "cpu", 0.0,
                                bench=bench, base=base,
                                log=open(os.devnull, "w"))
    assert result["correct"] and compared["px_off_share"]["value"] == 0.0
    # the new loop ran: each call rendered two passes
    passes = int((tmp_path / "passes").read_text())
    warm = json.loads((tmp_path / "perfbench" / "traffic" /
                       "tiny.json").read_text())["warmup_calls"]
    assert passes == 2 * (warm + result["attempted"])
    # pass_ms_p95 lists the cells it is read in; this one is not among them
    assert set(result["metrics"]) == {"paths_per_s", "setup_s"}
    reader = specs.metric_reader("calls_in_stretch", base)
    assert reader(type("Ctx", (), {"reading": type(
        "R", (), {"calls": 3})()})()) == 3.0
    per_layer = [m["name"] for m in specs.metrics_of(
        specs.workload("cornell_low.tiny", bench), bench, "per_layer")]
    assert "calls_in_stretch" in per_layer and "k4_roofline_pct" not in \
        per_layer


def test_every_cell_has_its_parts():
    bench = specs.benchmark()
    for w in bench["workloads"]:
        spec, builder = specs.config(w["config"])
        assert callable(builder.build)
        loop = specs.loop(specs.traffic(w["traffic"])["loop"])
        assert callable(loop.run) and callable(loop.evaluate)
        assert callable(loop.stand_in)
        assert specs.limits(w["name"])
        for m in specs.metrics_of(w, bench, "per_layer"):
            assert callable(specs.metric_reader(m["name"]))


def test_device_idle_holds_busy_time_against_untraced_calls():
    """The busy time per traced call over the mean untraced call; a stretch
    slowed by the profiler does not count."""
    reader = specs.metric_reader("device_idle_pct")
    reading = type("R", (), {"calls": 2, "busy_s": 0.030, "window_s": 0.09})
    ctx = type("Ctx", (), {"reading": reading,
                           "untraced_s": [0.02, 0.02, 0.02]})
    assert abs(reader(ctx) - 25.0) < 1e-9
    ctx.untraced_s = []
    assert reader(ctx) is None
