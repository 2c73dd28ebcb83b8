"""dead_segments_per_call: the program's ``dead_segments`` counter per
call: segments that a captured fwd+bwd ran over lanes that were all
dead, from the flags its graph keeps. Read from the program's own record
of the traced calls."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("counts", "dead_segments")
