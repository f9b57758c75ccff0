"""host_tail_ms.rlc (ms): per build, the time from the end of its last
device operation to the build's return (the host's extraction of the
entries into the RLCIndex), averaged over the traced builds."""
from rlcbench import tracing


def read(ctx):
    tails = tracing.host_tails(ctx.trace)
    if not tails:
        return None
    return 1e3 * sum(tails) / len(tails)
