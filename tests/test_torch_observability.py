"""The port's own trace (``utils/observability.py``): host spans, device
spans and counters of a session pass and a fit step.

On the CPU: with tracing off no span opens a profiler range and no record
is made; under ``torch.profiler`` the ``pbr.*`` spans of an eager pass and
an eager fit step appear, none over a whole call; tracing changes no result
bit; the counters equal the eager loop's own reads and calls; ``settle``
keeps exclusive times and the tail segments' graph time; the segment
counters count what the flags read; a count noted in a graph being captured
reaches the table at each replay, never at the capture. On the card (``gpu``, skipped without
one): the captured graphs carry their spans' events, a replay still equals
the eager program bit for bit and in launches, the device spans sum to no
more than the device's own time, a regrown fwd+bwd counts its capture, its
regrowth and its dead segments, replayed passes count the segments and
live lanes that eager ones do, and a Cornell or 50k pass launches and reads
what it did before the segment counters.

This file imports no JAX; on the card:

    python -m pytest --noconftest tests/test_torch_observability.py -q
"""

import collections
import time
import types

import numpy as np
import pytest
import torch

from _torch_common import watchdog  # noqa: F401  (autouse)
from pbrpathtracer_tpu_torch import Camera, RenderConfig, builders, fit
from pbrpathtracer_tpu_torch.engine.session import RenderSession
from pbrpathtracer_tpu_torch.ops.integrator import SamplePlan, run_segments
from pbrpathtracer_tpu_torch.utils import observability as obs

POSE = dict(pos=(0.013, 0.021, 0.217), dir=(0.02, -0.03, 1), up=(0, 1, 0),
            fovy=61)
PASS_CFG = RenderConfig(width=10, height=8, max_depth=3, seed=5)
FIT_CFG = RenderConfig(width=8, height=8, max_depth=2, spp=2, seed=3)
LAYERS = ("pbr.hit", "pbr.pack", "pbr.fetch", "pbr.shade")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Each test starts with no record and tracing off."""
    monkeypatch.setattr(obs, "_record", None)
    monkeypatch.setattr(obs, "_active", False)
    monkeypatch.setattr(obs, "_forced", 0)
    monkeypatch.setattr(obs, "_pending", [])


def _cornell(device="cpu"):
    return builders.cornell_box(device=device), Camera.make(**POSE).to(device)


def _session(device="cpu", cfg=PASS_CFG):
    scene, cam = _cornell(device)
    s = RenderSession(scene=scene, camera=cam, cfg=cfg, device=device)
    s.start()
    return s


def _fit(steps, device="cpu", cfg=FIT_CFG):
    scene, cam = _cornell(device)
    target = torch.full((cfg.height, cfg.width, 3), 0.2, device=device)
    return fit(scene, cam, cfg, target, steps=steps, lr=3e-2)


def _reads(runs, n_segments):
    """The eager loop's flag reads of samples that ran ``runs`` segments:
    one before each segment run, and the one that stopped it."""
    return sum(min(r + 1, n_segments) for r in runs)


def _launches(counts):
    """The kernel launches among ``counts``, by wrapper."""
    return {k: n for k, n in counts.items()
            if k.startswith(("intersect", "gather"))}


def _eager_runs(cfg, sample_indices, seed=None):
    scene, cam = _cornell()
    with torch.inference_mode():
        return [run_segments(SamplePlan(scene, cam, cfg, k, seed))[1]
                for k in sample_indices]


# ---- off --------------------------------------------------------------------

def test_off_opens_no_range_and_makes_no_record(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range opened while off: {name}")
    monkeypatch.setattr(obs, "_profiler", types.SimpleNamespace(
        _is_profiler_enabled=False, record_function=refuse))
    assert not obs.on()
    _session().step(1)
    _fit(1)
    assert obs.last_record() is None


@pytest.mark.parametrize("name", ["pbr.replay.segment", "pbr.read.flag"])
def test_off_spans_are_the_shared_null_context(name):
    assert obs.span(name) is obs.span("pbr.load")
    assert obs.host_read(name) is obs.span(name)
    assert obs.device_span(name, False) is obs.span(name)
    assert obs.segment_run(3, 10) is obs.span(name)


# ---- under the profiler -----------------------------------------------------

def _profiled(call):
    """(every event of the profiler over ``call()`` inside a range of its
    own, that range)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.call"):
            call()
    events = prof.events()
    whole = next(e for e in events if e.name == "test.call")
    return [e for e in events if e.name.startswith("pbr.")], whole


@pytest.mark.parametrize("what, want", [
    ("pass", {"pbr.read.flag", "pbr.epilogue"}),
    ("step", {"pbr.read.flag", "pbr.epilogue", "pbr.backward",
              "pbr.update", "pbr.read.loss"}),
])
def test_profiler_shows_the_spans_and_none_spans_a_call(what, want):
    if what == "pass":
        s = _session()
        spans, whole = _profiled(lambda: s.step(1))
    else:
        spans, whole = _profiled(lambda: _fit(1))
    names = {e.name for e in spans}
    assert set(LAYERS) | want <= names, names
    a, b = whole.time_range.start, whole.time_range.end
    for e in spans:
        assert not (e.time_range.start <= a and e.time_range.end >= b), \
            e.name
    rec = obs.last_record()
    assert rec["calls"] == 1
    assert set(LAYERS) | want <= set(rec["host_ms"])


@pytest.mark.parametrize("remat", ["off", "hits", "all"])
def test_no_span_opens_inside_the_backward(remat):
    """The backward's recompute of the segments (``remat_segments``) opens
    no span: the fit step's shading spans are its forward segments', one
    each, and no span overlaps the backward's."""
    cfg = FIT_CFG.replace(remat_segments=remat)
    spans, _ = _profiled(lambda: _fit(1, cfg=cfg))
    shades = sum(e.name == "pbr.shade" for e in spans)
    backward = sum(e.name == "pbr.backward" for e in spans)
    runs = _eager_runs(cfg, range(cfg.spp))
    assert backward == 1 and shades == sum(runs)
    assert all(e.time_range.end <= b.time_range.start
               or e.time_range.start >= b.time_range.end
               for e in spans for b in spans
               if b.name == "pbr.backward" and e.name != b.name)


# ---- results and counters ---------------------------------------------------

def test_tracing_changes_no_bit():
    def run():
        s = _session()
        s.step(2)
        f = _fit(2)
        return s.accum, f.losses, f.params
    off = run()
    with obs.tracing():
        on = run()
    assert torch.equal(off[0], on[0]) and off[1] == on[1]
    assert all(torch.equal(off[2][k], on[2][k]) for k in off[2])
    assert obs.last_record()["calls"] == 4


@pytest.mark.parametrize("passes", [1, 2])
def test_counts_of_session_passes(passes):
    s = _session()
    with obs.tracing():
        s.step(passes)
    rec = obs.last_record()
    runs = _eager_runs(PASS_CFG, range(passes))
    scene, cam = _cornell()
    live = sum(int(obs.wavefront_occupancy(scene, cam, PASS_CFG, k)[:r].sum())
               for k, r in enumerate(runs))
    assert rec["calls"] == passes
    assert rec["counts"] == {
        "graph_launches": 0, "dead_segments": 0, "captures": 0,
        "regrowths": 0,
        "host_reads": _reads(runs, PASS_CFG.resolved_max_segments()),
        "segments": sum(runs), "live_lanes": live,
        "segment_lanes": sum(runs) * PASS_CFG.num_pixels,
        "pack_builds": 2 * passes, "fused_shades": 0}


def test_counts_of_fit_steps():
    with obs.tracing():
        _fit(2)
    rec = obs.last_record()
    n = FIT_CFG.resolved_max_segments()
    reads = sum(_reads(_eager_runs(FIT_CFG, range(FIT_CFG.spp),
                                   FIT_CFG.seed + step), n) + 1
                for step in range(2))
    assert rec["calls"] == 2
    assert rec["counts"]["host_reads"] == reads
    assert rec["counts"]["graph_launches"] == 0
    assert rec["host_ms"]["pbr.update"] > 0


def test_a_new_tracing_starts_a_new_record():
    s = _session()
    with obs.tracing():
        s.step(2)
    first = obs.last_record()
    with obs.tracing():
        s.step(1)
    assert first["calls"] == 2 and obs.last_record()["calls"] == 1
    s.step(1)                       # off: the record stays as it was
    assert obs.last_record()["calls"] == 1


# ---- settle -----------------------------------------------------------------

def _graph(t0, spans, entered=None):
    """A graph's group whose stamps read ``t0`` + the spans' (start, end),
    in ms, as ns."""
    g = obs._Group(graph=True)
    times = []
    for name, parent, a, b in spans:
        g.spans.append([name, parent, len(times), len(times) + 1])
        times += [round((t0 + a) * 1e6), round((t0 + b) * 1e6)]
    g.read = lambda: np.asarray(times, dtype=np.int64)
    g.entered = entered
    return g


NESTED = [("pbr.graph", -1, 0, 10), ("pbr.shade", 0, 1, 8),
          ("pbr.hit", 1, 2, 4), ("pbr.fetch", 1, 5, 6),
          ("pbr.pack", 3, 5.25, 5.5)]


def test_settle_keeps_exclusive_times_and_gaps():
    first = _graph(0, NESTED)
    second = _graph(13, [("pbr.graph", -1, 0, 2), ("pbr.hit", 0, 0.5, 1.5)],
                    entered=torch.tensor([True, False, False]))
    with obs.tracing():
        obs.replaying(first)
        obs.replaying(second)
        obs.call_done()
    rec = obs.last_record()
    want = {"pbr.graph": 10 - 7 + 2 - 1, "pbr.shade": 7 - 2 - 1,
            "pbr.hit": 2 + 1, "pbr.fetch": 1 - 0.25, "pbr.pack": 0.25}
    assert rec["device_ms"] == pytest.approx(want)
    assert rec["graph_gap_ms"] == pytest.approx(3.0)
    assert rec["counts"]["graph_launches"] == 2
    assert rec["counts"]["dead_segments"] == 2
    assert rec["calls"] == 1


def test_settle_takes_a_graph_replayed_twice_at_its_last_times():
    g = _graph(0, NESTED[:2])
    other = _graph(20, [("pbr.graph", -1, 0, 1)])
    with obs.tracing():
        for _ in range(2):
            obs.replaying(g)
            obs.replaying(other)
        obs.call_done()
    rec = obs.last_record()
    assert rec["device_ms"] == pytest.approx({"pbr.graph": 2 * 3 + 2 * 1,
                                              "pbr.shade": 2 * 7})
    # only the last pair is known to be consecutive
    assert rec["graph_gap_ms"] == pytest.approx(10.0)


def test_settle_sums_the_tail_segments_graphs():
    """Replays inside segment runs: a graph entered with under a tenth of
    its lanes alive adds its whole time (``pbr.graph``'s, nested spans
    in) to ``tail_ms``; one entered with a tenth or more, or replayed
    outside a segment run, adds nothing. A captured fwd+bwd's entering
    flags are live-lane counts, 0 where a segment's lanes were all dead."""
    busy = _graph(0, NESTED)
    edge = _graph(11, [("pbr.graph", -1, 0, 2)])
    tail = _graph(14, [("pbr.graph", -1, 0, 4), ("pbr.hit", 0, 1, 2)])
    fwdbwd = _graph(20, [("pbr.graph", -1, 0, 1)],
                    entered=torch.tensor([7, 0, 3, 0]))
    with obs.tracing():
        for live, g in ((100, busy), (10, edge), (9, tail)):
            with obs.segment_run(live, 100):
                obs.replaying(g)
        obs.replaying(fwdbwd)
        obs.call_done()
    rec = obs.last_record()
    assert rec["tail_ms"] == pytest.approx(4.0)
    assert {k: rec["counts"][k] for k in ("segments", "live_lanes",
                                          "segment_lanes", "dead_segments",
                                          "graph_launches")} == {
        "segments": 3, "live_lanes": 119, "segment_lanes": 300,
        "dead_segments": 2, "graph_launches": 4}


def test_a_count_in_a_captured_graph_reaches_the_table_at_each_replay():
    """With tracing off, what is counted while a graph is captured goes to
    the graph and never to the table, and reaches the table once at each of
    the graph's replays, beside one graph launch; nothing is recorded."""
    g = obs._Group(graph=True)
    g.stamp = lambda: 0               # no card: the stamps are not taken

    def capture():
        with obs.graph_spans(g):
            obs.count("pack_builds", 2)
            obs.count("intersect_dense")
    _, at_capture = obs.counted(capture)
    assert at_capture == {}
    assert g.counts == {"pack_builds": 2, "intersect_dense": 1}
    _, replays = obs.counted(lambda: [obs.replaying(g) for _ in range(3)])
    assert replays == {"graph_launches": 3, "pack_builds": 6,
                       "intersect_dense": 3}
    _, after = obs.counted(lambda: obs.count("intersect_dense"))
    assert after == {"intersect_dense": 1}   # the capture is over
    assert not obs.on() and obs.last_record() is None


def test_replays_while_off_queue_nothing_and_disarm_the_stamps():
    g = _graph(0, NESTED)
    obs.replaying(g)
    assert g.replays == 0 and not g.armed and obs.last_record() is None
    with obs.tracing():
        obs.replaying(g)
    assert g.replays == 1 and g.armed


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_captured_graphs_carry_their_spans(dev, monkeypatch):
    """Passes of a 64x48 Cornell session, captured and replayed: every
    segment graph holds pbr.graph and the layers' events, the prologue
    graph pbr.graph and the pack builds' (once a sample); with tracing on
    the replays give device ms per layer, one launch per graph run and one
    read per flag and per pass, and the accumulation and the kernels'
    launches equal the eager passes' bit for bit."""
    from pbrpathtracer_tpu_torch.engine import compiled
    from pbrpathtracer_tpu_torch.ops.integrator import render_sample
    cfg = RenderConfig(width=64, height=48, max_depth=3, seed=11)
    s = _session(dev, cfg)
    s.step(2)                        # eager, then captured
    scene, cam = s._scene, s._camera.to(dev)
    entry = compiled.SAMPLES.entry(scene, cam, cfg)
    assert entry is not None
    assert {x[0] for x in entry.spans[0].spans} == {"pbr.graph",
                                                      "pbr.pack"}
    for spans in entry.spans[1:]:
        names = {x[0] for x in spans.spans}
        assert {"pbr.graph", "pbr.hit", "pbr.fetch", "pbr.shade"} <= names
        assert "pbr.pack" not in names
    runs = []

    def counted(plan, count=None):
        out = run_segments(plan, count)
        runs.append(out[1])
        return out
    monkeypatch.setattr(compiled, "run_segments", counted)
    with obs.tracing():
        _, replay = obs.counted(lambda: s.step(3))
    rec = obs.last_record()
    assert rec["calls"] == 3 and len(runs) == 3
    got = {k: rec["counts"][k] for k in ("graph_launches", "host_reads",
                                          "dead_segments", "pack_builds",
                                          "fused_shades")}
    # a flag read before each segment run and one that stopped each pass;
    # one sync after the three passes of the step; the prologue graph's
    # two pack builds (tri and light) a pass; every segment run fused
    assert got == {"graph_launches": sum(runs) + 3,
                   "host_reads": _reads(runs, cfg.resolved_max_segments())
                   + 1, "dead_segments": 0, "pack_builds": 6,
                   "fused_shades": sum(runs)}, (runs, rec)
    assert all(rec["device_ms"][k] > 0 for k in LAYERS + ("pbr.graph",))
    assert rec["graph_gap_ms"] > 0
    # the same samples eagerly, tracing on: the same sum and launches
    eager_counts = collections.Counter()
    with torch.inference_mode():
        eager = torch.zeros_like(s.accum)
        for k in range(5):
            with obs.tracing():
                radiance, moved = obs.counted(
                    lambda: render_sample(scene, cam, cfg, k))
            eager = eager + radiance
            if k >= 2:
                eager_counts.update(moved)
    assert torch.equal(eager, s.accum)
    assert _launches(replay) and _launches(replay) == _launches(eager_counts)


@pytest.mark.gpu
@pytest.mark.parametrize("profiled", [False, True])
def test_device_spans_lie_between_the_kernels_and_the_wall(dev, profiled):
    """Over replayed passes and fit steps, with tracing on alone or under
    the profiler: the spans' device ms (the graphs' wall time on the card,
    ``pbr.graph`` included) are at least 0.8 of the kernels' own time that
    the profiler reads over like calls (the rest runs outside the graphs:
    the epilogue, Adam) and, with the gaps between graphs, at most the
    calls' wall time on the host."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    s = _session(dev, RenderConfig(width=256, height=192, max_depth=3,
                                   seed=2))
    scene, cam = _cornell(dev)
    cfg = RenderConfig(width=128, height=128, max_depth=3, spp=1, seed=4)
    target = torch.full((128, 128, 3), 0.2, device=dev)
    for call in (lambda: s.step(2),
                 lambda: fit(scene, cam, cfg, target, steps=5)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        spans = {e.name for e in prof.events() if e.device_type != cuda}
        kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == cuda and e.name not in spans
                        and not getattr(e, "is_user_annotation", False)
                        and not e.name.startswith("Memcpy")) / 1e3
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if profiled \
            else obs.tracing()
        t0 = time.perf_counter()
        with ctx:
            call()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        rec = obs.last_record()
        graphs_ms = sum(rec["device_ms"].values())
        assert 0.8 * kernel_ms <= graphs_ms, (rec, kernel_ms)
        assert graphs_ms + rec["graph_gap_ms"] <= wall_ms, (rec, wall_ms)


@pytest.mark.gpu
def test_a_regrown_fwd_bwd_counts_its_capture_and_dead_segments(dev):
    """The translucent scene's key captured at the seed that runs fewer
    segments, then traced over a replay at a seed that needs more (the
    regrowth) and a replay at the first seed: one capture, one regrowth,
    two launches, and the segments that ran over dead lanes."""
    from pbrpathtracer_tpu_torch import get_params, grad_render
    from pbrpathtracer_tpu_torch.diff.loss import fwd_bwd
    from pbrpathtracer_tpu_torch.engine.compiled import GRADS
    scene = builders.translucent_scene()
    cam = Camera.make(**POSE, focal_dist=2.2, aperture=0.04).to(dev)
    cfg = RenderConfig(width=12, height=10, max_depth=3, spp=2,
                       max_segments=16)
    target = torch.zeros((10, 12, 3), device=dev)
    params = get_params(scene, cam)
    runs = {}
    for seed in range(6):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        runs[seed] = fwd_bwd(leaves, scene, cam, cfg, target, seed)[2]
    lo, hi = next((a, b) for a in runs for b in runs
                  if any(x > y for x, y in zip(runs[b], runs[a])))
    grad_render(scene, cam, cfg, target, seed=lo)
    grad_render(scene, cam, cfg, target, seed=lo)      # captured here
    with obs.tracing():
        grad_render(scene, cam, cfg, target, seed=hi)  # regrown
        grad_render(scene, cam, cfg, target, seed=lo)  # through dead ones
    rec = obs.last_record()
    grown = [max(a, b) for a, b in zip(runs[lo], runs[hi])]
    assert GRADS.entry(params, scene, cam, cfg, target).counts == grown
    dead = (sum(max(0, a - b) for a, b in zip(runs[lo], runs[hi]))
            + sum(g - a for g, a in zip(grown, runs[lo])))
    assert rec["counts"]["captures"] == 1
    assert rec["counts"]["regrowths"] == 1
    assert rec["counts"]["graph_launches"] == 2
    # the two tail flags, and the flags that the regrowth's eager warm-up
    # reads as the eager loop does
    warm_up = _reads(runs[hi], cfg.resolved_max_segments())
    assert rec["counts"]["host_reads"] == 2 + warm_up
    assert rec["counts"]["dead_segments"] == dead
    assert rec["device_ms"]["pbr.backward"] > 0


@pytest.mark.gpu
def test_replayed_segment_counters_equal_the_eager_ones(dev):
    """Passes of the deep glass session (DOF, depth 8, the 128-segment
    cap), replayed under tracing, count the segments, live lanes and lanes
    that the same samples count eagerly; the replays' tail segments have a
    device time, which is part of the graphs' own."""
    scene = builders.translucent_scene(device=dev)
    cam = Camera.make(**POSE, focal_dist=2.2, aperture=0.04).to(dev)
    cfg = RenderConfig(width=64, height=64, max_depth=8, max_segments=128,
                       seed=6)
    s = RenderSession(scene=scene, camera=cam, cfg=cfg, device=dev)
    s.start()
    s.step(2)                        # eager, then captured
    with obs.tracing():
        s.step(3)
    replayed = obs.last_record()
    keys = ("segments", "live_lanes", "segment_lanes")
    from pbrpathtracer_tpu_torch.ops.integrator import render_sample
    with obs.tracing(), torch.inference_mode():
        for k in range(2, 5):
            render_sample(scene, cam, cfg, k)
    eager = obs.last_record()
    assert {k: replayed["counts"][k] for k in keys} == \
        {k: eager["counts"][k] for k in keys}
    assert replayed["counts"]["graph_launches"] == \
        replayed["counts"]["segments"] + 3
    assert 0 < replayed["tail_ms"] <= sum(replayed["device_ms"].values())
    assert eager["tail_ms"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("scene_name, launches, reads", [
    ("cornell", 5, 6), ("mesh50k", 9, 9)])
def test_launches_and_reads_per_pass_are_unchanged(dev, scene_name,
                                                   launches, reads):
    """A 1024x768 depth-3 session pass of the Cornell box and of the 50k
    scene, replayed under tracing, launches and reads what the benchmark's
    sessions did before the segment counters (a prologue and one graph a
    segment; a flag read before each segment and the one that stops the
    loop, and the pass's sync): the count the flag now carries adds no
    launch and no read."""
    from pbrpathtracer_tpu_torch.scene.big_scenes import (mesh_scene,
                                                          mesh_scene_camera)
    if scene_name == "cornell":
        scene, cam = _cornell(dev)
    else:
        scene, cam = mesh_scene(50_000, device=dev), \
            mesh_scene_camera().to(dev)
    cfg = RenderConfig(width=1024, height=768, max_depth=3, seed=11)
    s = RenderSession(scene=scene, camera=cam, cfg=cfg, device=dev)
    s.start()
    s.step(1)
    s.step(1)                        # eager, then captured
    with obs.tracing():
        for _ in range(3):
            s.step(1)
    counts = obs.last_record()["counts"]
    segments = counts["segments"]
    cap = cfg.resolved_max_segments()
    stops = 0 if segments == 3 * cap else 3
    assert counts["graph_launches"] == segments + 3 == 3 * launches
    assert counts["host_reads"] == segments + stops + 3 == 3 * reads
