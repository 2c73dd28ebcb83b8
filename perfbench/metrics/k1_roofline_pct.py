"""k1_roofline_pct: K1 (the dense closest hit, ``intersect_dense_kernel``)
against its roofline. Each of the reference's closest-hit queries is one
launch: its live rays against every triangle (``k1_work``)."""


def read(ctx):
    ys = ctx.yardstick
    bounds = [ys.bound_ms(*ys.k1_work(live, ctx.n_tris))
              for w in ctx.works for live, _ in w.queries]
    return ctx.roofline_share("k1", bounds)
