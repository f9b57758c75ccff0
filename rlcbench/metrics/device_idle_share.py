"""device_idle_share.<cells> (%): the share of the traced window in which
no kernel, copy or fill ran on the card. One reader for every name
``device_idle_share.*`` (the harness falls back to the name's stem)."""
from rlcbench import tracing


def read(ctx):
    window = ctx.trace.window()
    if window is None or window[1] <= window[0] or not ctx.trace.device:
        return None
    busy = tracing.busy_s(ctx.trace, *window)
    return 100.0 * (1.0 - busy / (window[1] - window[0]))
