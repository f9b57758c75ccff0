"""hub_loop_idle_ms.rlc (ms): per build, the time with nothing on the
card inside the program's ``repro_torch.condensed.hub_loop`` span (the
card waiting on the host's launches), averaged over the traced builds."""
from rlcbench import program_spans


def read(ctx):
    return program_spans.idle_ms_per_build(ctx.trace,
                                           program_spans.HUB_LOOP)
