"""hub_loop_roofline.rlc (%): the bound of the condensed build's coverage
products (``bounds.hub_loop_bound_s``: per hub batch the two (C, n, n)
entry stacks and the (C, n, B) operands at one bit an entry over
3.35 TB/s, or 2 C n^2 B operations a product at 1,979 TOP/s where that
is longer) over the summed device time of every kernel inside the
builds, per build."""
from rlcbench import bounds, tracing


def read(ctx):
    builds = ctx.trace.builds()
    kernel_s = tracing.seconds_in_builds(ctx.trace, ("kernel",))
    if not builds or kernel_s <= 0:
        return None
    bound, _ = bounds.hub_loop_bound_s(len(ctx.mr_lengths), ctx.n,
                                       ctx.hub_batch)
    return 100.0 * bound * len(builds) / kernel_s
