"""fetch_ms_per_call: the device milliseconds of the program's
``pbr.fetch`` spans per call, exclusive of the spans nested in them: the
field fetches' forward (K2 and the views of its block). Read from the
program's own record of the traced calls (timestamps that the program
writes on the card around the span, captured into its graphs)."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("device_ms", "pbr.fetch")
