"""fused_shades_per_call: the program's ``fused_shades`` counter per call:
the bounce segments shaded by the fused forward kernels (``csrc/shade.cu``)
rather than by the torch chain, a replayed graph counting those captured
into it. It equals ``segments_per_call`` in a session and reads 0 in a fit,
whose fwd+bwd records a graph. Read from the program's own record of the
traced calls; a program without the counter gives nothing."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("counts", "fused_shades")
