"""Finding a cell's parts by name: the workload in ``BENCHMARK.json``, its
configuration (``configs/<name>.json`` and the scene builder it names),
its traffic mix (``traffic/<name>.json``) and the loop that the mix names
(``loops/<name>.py``), its limits (``limits/<workload>.json``) and the
per-layer metric readers (``metrics/<name>.py``). A later PR adds any of
them as new files.

A run's render keys (``render``: fields of the program's ``RenderConfig``,
such as ``width``, ``height``, ``max_depth``, ``spp``) are the
configuration's, overridden by the traffic mix's."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(name, bench=None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name, base=BENCH):
    """(the configuration's JSON, its scene builder module)."""
    spec = _json(os.path.join(base, "configs", f"{name}.json"))
    builder = _module(os.path.join(base, "configs", spec["builder"]),
                      f"perfbench_config_{name}")
    return spec, builder


def traffic(name, base=BENCH, overrides=None) -> dict:
    """The mix's parameters; ``overrides`` replace some (its ``render``
    keys one by one)."""
    mix = _json(os.path.join(base, "traffic", f"{name}.json"))
    overrides = dict(overrides or {})
    render = {**mix.get("render", {}), **overrides.pop("render", {})}
    return {**mix, **overrides, "render": render}


def render(config_spec: dict, traffic_spec: dict) -> dict:
    """The run's render keys: the configuration's, then the mix's."""
    return {**config_spec.get("render", {}), **traffic_spec["render"]}


def loop(name, base=BENCH):
    """The module ``loops/<name>.py``: ``run(ctx)``, ``evaluate(ctx, run,
    log)``, ``stand_in(ctx, prec, fault, passes)`` and ``FAULTS``."""
    return _module(os.path.join(base, "loops", f"{name}.py"),
                   f"perfbench_loop_{name}")


def limits(workload_name, base=BENCH) -> dict:
    """{number: limit} of the cell's comparison."""
    data = _json(os.path.join(base, "limits", f"{workload_name}.json"))
    return {k: v["limit"] for k, v in data.items()}


def metric_reader(name, base=BENCH):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    return _module(os.path.join(base, "metrics", f"{name}.py"),
                   f"perfbench_metric_{name.replace('.', '_')}").read


def metrics_of(cell: dict, bench: dict, kind: str) -> list:
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): those
    that list it under ``workloads``, or list none."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]
