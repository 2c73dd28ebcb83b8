"""k4_roofline_pct: K4 (the BVH closest hit, ``bvh_intersect_kernel``)
against its roofline, priced at its least walk: each of the reference's
queries over a binary BVH of the scene's triangle count at the frozen leaf
size, every node read once, a slab test per level for each live ray and a
leaf of pair tests for each hit (``k4_work``)."""


def read(ctx):
    ys = ctx.yardstick
    nodes = ys.binary_bvh_nodes(ctx.n_tris)
    bounds = [ys.bound_ms(*ys.k4_work(live, nodes, ctx.n_tris, hits,
                                      ys.LEAF_SIZE))
              for w in ctx.works for live, hits in w.queries]
    return ctx.roofline_share("k4", bounds)
