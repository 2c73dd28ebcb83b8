"""device_idle_pct: the share of a call's untraced wall time in which no
operation ran on the card, in %: 1 - (the union of the device operations'
intervals in the traced stretch, per call) / (the mean wall time of the
untraced calls that follow the stretch in the same run).

The device's busy time is read from the trace, whose kernel durations the
profiler does not inflate; the wall time is read without the profiler,
which slows every replayed graph's launch (a traced Cornell pass takes
about 1.7 times an untraced one), so the share is not the traced
stretch's own (``device.busy_s`` / ``device.window_s``). Calls differ in
their device time from seed to seed, so a cell whose card is busy
throughout reads within about a percent of 0 on either side."""

import statistics


def read(ctx):
    r = ctx.reading
    if r.calls <= 0 or not ctx.untraced_s:
        return None
    wall = statistics.fmean(ctx.untraced_s)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - (r.busy_s / r.calls) / wall)
