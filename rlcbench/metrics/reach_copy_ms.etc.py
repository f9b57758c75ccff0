"""reach_copy_ms.etc (ms): device time of the copies in one build (the
reach stack leaving the card), averaged over the traced builds."""
from rlcbench import tracing


def read(ctx):
    builds = ctx.trace.builds()
    copy_s = tracing.seconds_in_builds(ctx.trace, ("memcpy",))
    if not builds or copy_s <= 0:
        return None
    return 1e3 * copy_s / len(builds)
