"""device_ms_per_call: the summed durations of every device operation of
the traced stretch (kernels, copies and sets, replayed graphs' kernels
among them) over its calls, in ms."""


def read(ctx):
    r = ctx.reading
    return 1e3 * r.op_seconds() / r.calls
