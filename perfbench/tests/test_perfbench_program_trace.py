"""The per-layer metrics read from the program's own record
(``perfbench/harness/record.py``): each gives its number over the record's
calls, and nothing without a record, without a call, or from a program
that keeps no record; and a traced CPU run of a cell leaves the record
that they read."""

import pytest

from perfbench.harness import cell, record, specs

RECORD = {"calls": 4,
          "counts": {"graph_launches": 20, "host_reads": 20,
                     "dead_segments": 6, "captures": 0, "regrowths": 0},
          "device_ms": {"pbr.hit": 4.0, "pbr.pack": 2.0, "pbr.fetch": 1.0,
                        "pbr.shade": 30.0, "pbr.backward": 50.0,
                        "pbr.graph": 3.0},
          "host_ms": {"pbr.replay.segment": 0.5},
          "graph_gap_ms": 1.0}

PER_CALL = {"hit_ms_per_call": 1.0, "pack_ms_per_call": 0.5,
            "fetch_ms_per_call": 0.25, "shade_ms_per_call": 7.5,
            "backward_ms_per_call": 12.5, "graph_launches_per_call": 5.0,
            "host_reads_per_call": 5.0, "dead_segments_per_call": 1.5}


@pytest.mark.parametrize("name", sorted(PER_CALL))
def test_a_reader_gives_its_number_per_call(name, monkeypatch):
    reader = specs.metric_reader(name)
    monkeypatch.setattr(record, "last_record", lambda: RECORD)
    assert reader(None) == PER_CALL[name]
    monkeypatch.setattr(record, "last_record", lambda: None)
    assert reader(None) is None
    monkeypatch.setattr(record, "last_record",
                        lambda: dict(RECORD, calls=0))
    assert reader(None) is None


def test_a_span_the_record_lacks_reads_nothing(monkeypatch):
    monkeypatch.setattr(record, "last_record",
                        lambda: dict(RECORD, device_ms={}))
    assert specs.metric_reader("hit_ms_per_call")(None) is None
    assert specs.metric_reader("host_reads_per_call")(None) == 5.0


def test_a_program_without_a_record_reads_nothing(monkeypatch):
    from pbrpathtracer_tpu_torch.utils import observability
    monkeypatch.delattr(observability, "last_record")
    assert record.last_record() is None
    assert specs.metric_reader("pack_ms_per_call")(None) is None


def test_every_new_metric_is_listed_with_its_cells():
    bench = specs.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in PER_CALL:
        m = listed[name]
        assert m["moves"] == "paths_per_s" and m["workloads"]
        for w in m["workloads"]:
            specs.workload(w, bench)


def test_a_traced_cpu_run_leaves_the_record_of_its_calls():
    """A tiny traced session on the CPU: the profiler's calls (the stretch
    and the one before it) are the record's, with a flag read before each
    segment and none on the card."""
    cell.run("cornell.session", 7, 0.05, 1, "cpu", 0.0,
             overrides={"render": dict(width=8, height=8),
                        "trace_skip_calls": 1, "trace_calls": 2,
                        "untraced_seconds": 0.0, "check_pixels": 8},
             log=open("/dev/null", "w"))
    rec = record.last_record()
    assert rec["calls"] == 3
    assert rec["counts"]["graph_launches"] == 0
    assert rec["counts"]["host_reads"] >= 3
    assert {"pbr.hit", "pbr.shade", "pbr.read.flag"} <= set(rec["host_ms"])
