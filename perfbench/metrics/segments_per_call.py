"""segments_per_call: the program's ``segments`` counter per call: the
bounce segments that its segment loop ran, one graph launch and one flag
read each on the card. Read from the program's own record of the traced
calls; a program without the counter gives nothing."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("counts", "segments")
