"""One run of one cell: its parts found by name, the loop that its traffic
mix names over the program, the comparison with the reference, and the
metrics of the run's kind (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, read from the traced stretch)."""

from __future__ import annotations

import dataclasses
import math
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import specs, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "pbrpathtracer_tpu")


@dataclasses.dataclass
class Context:
    workload: str
    config: dict
    traffic: dict
    render: dict           # the run's RenderConfig keys, less the seed
    arrays: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


def context(workload, seed, seconds, trace, device, t_start, overrides=None,
            bench=None, base=specs.BENCH) -> Context:
    """A run's context: the cell's configuration, its traffic mix (with
    ``overrides``, the tests' small sizes) and the scene's arrays."""
    bench = bench or specs.benchmark()
    cell = specs.workload(workload, bench)
    config, builder = specs.config(cell["config"], base)
    traffic = specs.traffic(cell["traffic"], base, overrides)
    return Context(workload=workload, config=config, traffic=traffic,
                   render=specs.render(config, traffic),
                   arrays=builder.build(config, seed), seed=int(seed),
                   seconds=seconds, trace=bool(trace),
                   device=torch.device(device), t_start=t_start)


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader gets."""
    reading: object        # trace.Reading of the traced stretch
    untraced_s: list       # wall seconds of the untraced calls after it
    works: list            # the reference's Work of each traced call
    n_tris: int
    yardstick: object      # harness.yardstick

    def roofline_share(self, kernel, bounds_ms):
        """The least time of a kernel's launches (``bounds_ms``, one per
        launch the reference counted) over its device time in the stretch,
        in %; None where either is nought."""
        seconds = self.reading.op_seconds(
            lambda n: yardstick.kernel_of(n) == kernel)
        least = sum(bounds_ms)
        if seconds <= 0 or least <= 0:
            return None
        return 100.0 * least / (seconds * 1e3)


def end_to_end(name, run):
    """The end-to-end metrics, all on the host's clock."""
    if name == "setup_s":
        return run.setup_s
    if name == "paths_per_s":
        return run.lanes * len(run.call_s) / run.elapsed_s
    if name == "pass_ms_p95":
        return float(np.percentile(np.asarray(run.call_s) * 1e3, 95))
    raise KeyError(f"no end-to-end metric {name!r}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(workload, seed, seconds, trace, device, t_start, overrides=None,
        bench=None, base=specs.BENCH, log=sys.stderr):
    """(the result line's object, the numbers compared with their limits).
    ``overrides`` replace traffic parameters (the tests' small sizes)."""
    bench = bench or specs.benchmark()
    cell = specs.workload(workload, bench)
    ctx = context(workload, seed, seconds, trace, device, t_start, overrides,
                  bench, base)
    loop = specs.loop(ctx.traffic["loop"], base)
    r = loop.run(ctx)
    calls = r.call_s
    marks = {k: round(v, 3) for k, v in r.setup_marks.items()}
    print(f"set-up, seconds from process start: {marks}", file=log)
    print(f"window: {len(calls)} calls in {r.elapsed_s:.6f} s; first and "
          f"last fifth of the calls {_fifths(calls)} s; compiled caches "
          f"{r.counters}", file=log)
    reading = r.stretch.read() if r.stretch is not None else None
    numbers, works = loop.evaluate(ctx, r, log=log)
    if works:
        rays = sum(live for w in works for live, _ in w.queries)
        per_path = rays / len(works) / r.lanes
        print(f"reference work of the traced calls: {per_path!r} "
              f"closest-hit rays per path", file=log)
    limits = specs.limits(workload, base)
    compared = {k: {"value": v, "limit": limits[k]} for k, v in
                numbers.items()}
    correct = all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    metrics = {}
    if not trace:
        for m in specs.metrics_of(cell, bench, "end_to_end"):
            metrics[m["name"]] = {"value": end_to_end(m["name"], r),
                                  "unit": m["unit"]}
    elif reading is not None:
        mctx = MetricContext(reading=reading, untraced_s=r.untraced_s,
                             works=works,
                             n_tris=int(ctx.arrays["tris"]["v0"].shape[0]),
                             yardstick=yardstick)
        for m in specs.metrics_of(cell, bench, "per_layer"):
            value = specs.metric_reader(m["name"], base)(mctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = ctx.device
    on_card = dev.type == "cuda"
    info = {"platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": r.memory_peak_bytes}
    result = {"correct": correct, "attempted": len(calls), "failed": 0,
              "metrics": metrics, "device": info}
    if trace and reading is not None:
        info["busy_s"] = reading.busy_s
        info["window_s"] = reading.window_s
        result["breakdown"] = reading.breakdown()
    if on_card:
        info["power"] = power_limit()
    result["checks"] = compared
    return result, compared


def _fifths(calls):
    n = max(1, len(calls) // 5)
    if len(calls) < 2:
        return "n/a"
    return (f"{statistics.mean(calls[:n]):.6f} / "
            f"{statistics.mean(calls[-n:]):.6f}")
