"""k3_roofline_pct: K3 (the pack-gather backward, the ``bwd_*_kernel``
family) against its roofline. Each fetch from a table that carries the
fit's gradient is one backward: its ids and cotangent read, the table
written (``k3_work``)."""


def read(ctx):
    ys = ctx.yardstick
    bounds = [ys.bound_ms(*ys.k3_work(n, rows, width))
              for w in ctx.works for n, rows, width in w.fetch_bwd]
    return ctx.roofline_share("k3", bounds)
