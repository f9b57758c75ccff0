"""reach_roofline.etc (%): the bound of the all-MR reach's products
(``bounds.reach_bound_s``: 2 n^3 operations a product, (m - 1) chain and
ceil(log2 n) doubling products an MR, at 1,979 TOP/s) over the summed
device time of every kernel inside the builds, per build."""
from rlcbench import bounds, tracing


def read(ctx):
    builds = ctx.trace.builds()
    kernel_s = tracing.seconds_in_builds(ctx.trace, ("kernel",))
    if not builds or kernel_s <= 0:
        return None
    bound = bounds.reach_bound_s(ctx.mr_lengths, ctx.n)
    return 100.0 * bound * len(builds) / kernel_s
