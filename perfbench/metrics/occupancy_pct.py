"""occupancy_pct: the share of the lanes that the segments ran over that
were alive on entering them, in %: 100 x the program's ``live_lanes``
counter over its ``segment_lanes`` (each segment's lanes, summed), both
taken from the live-lane count that the flag read between segments
already brings. Read from the program's own record of the traced calls;
a program without the counters gives nothing."""

from perfbench.harness import record


def read(ctx):
    rec = record.last_record()
    if not rec or not rec.get("calls"):
        return None
    counts = rec.get("counts", {})
    live, lanes = counts.get("live_lanes"), counts.get("segment_lanes")
    if live is None or not lanes:
        return None
    return 100.0 * live / lanes
