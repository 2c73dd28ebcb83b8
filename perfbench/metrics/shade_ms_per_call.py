"""shade_ms_per_call: the device milliseconds of the program's
``pbr.shade`` spans per call, exclusive of the spans nested in them:
shading a segment, less the shadow queries, pack builds and fetches in
it. Read from the program's own record of the traced calls (timestamps
that the program writes on the card around the span, captured into its
graphs)."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("device_ms", "pbr.shade")
