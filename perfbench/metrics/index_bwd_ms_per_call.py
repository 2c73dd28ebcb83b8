"""index_bwd_ms_per_call: device time of torch's index backwards (the
texture read's and the material gathers' ``index_put`` with accumulation:
the indexing-backward kernels, the radix sorts that order their ids, the
index-add kernels), by kernel name, over the stretch's calls, in ms."""

import re

INDEX_BWD = re.compile(r"indexing_backward|index_put|RadixSort|radixSort"
                       r"|index_add|indexFunc")


def read(ctx):
    ys = ctx.yardstick

    def index_bwd(name):
        return ys.kernel_of(name) is None and bool(INDEX_BWD.search(name))
    r = ctx.reading
    return 1e3 * r.op_seconds(index_bwd) / r.calls
