"""torch_kernels_ms_per_call: device time of the kernels that are not one
of the hand-written K1-K4 (torch's shading, RNG, autograd and optimizer
kernels; copies and sets left out), by kernel name, over the stretch's
calls, in ms."""


def read(ctx):
    ys = ctx.yardstick

    def torch_kernel(name):
        return (ys.kernel_of(name) is None
                and not name.startswith(("Memcpy", "Memset")))
    r = ctx.reading
    return 1e3 * r.op_seconds(torch_kernel) / r.calls
