"""host_reads_per_call: the program's ``host_reads`` counter per call: the
program's blocking reads of the card (pbr.read.flag, pbr.read.tail,
pbr.read.loss, pbr.sync.pass). Read from the program's own record of the
traced calls."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("counts", "host_reads")
