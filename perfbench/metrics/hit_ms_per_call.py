"""hit_ms_per_call: the device milliseconds of the program's ``pbr.hit``
spans per call, exclusive of the spans nested in them: the closest-hit
queries (bounce, NEE shadow and the opacity re-trace: K1 or K4 and the
torch operations around them), less the fetches and pack builds in them.
Read from the program's own record of the traced calls (timestamps that
the program writes on the card around the span, captured into its
graphs)."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("device_ms", "pbr.hit")
