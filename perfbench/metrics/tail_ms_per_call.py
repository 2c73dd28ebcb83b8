"""tail_ms_per_call: the device milliseconds per call of the segment
graphs entered with under a tenth of their lanes alive, each graph's time
from its first timestamp to its last (the program's ``pbr.graph`` stamps,
nested spans included): the deep tail that compaction and a loop kept on
the card would shorten. Read from the program's own record of the traced
calls (``tail_ms``); a program without it gives nothing."""

from perfbench.harness import record


def read(ctx):
    rec = record.last_record()
    if not rec or not rec.get("calls") or "tail_ms" not in rec:
        return None
    return rec["tail_ms"] / rec["calls"]
