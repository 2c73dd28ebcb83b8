"""k2_roofline_pct: K2 (the pack-gather forward, ``fwd_staged_kernel`` and
``fwd_in_place_kernel``) against its roofline. Each of the reference's
table fetches is one launch: its ids, the distinct rows they name read
once, the [W, N] block written (``k2_work``)."""


def read(ctx):
    ys = ctx.yardstick
    bounds = [ys.bound_ms(*ys.k2_work(n, width, rows))
              for w in ctx.works for n, width, rows, _ in w.fetches]
    return ctx.roofline_share("k2", bounds)
