"""graph_launches_per_call: the program's ``graph_launches`` counter per
call: the captured graphs replayed (a session pass: the prologue and
each segment run; a fit step: the fwd+bwd). Read from the program's own
record of the traced calls."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("counts", "graph_launches")
