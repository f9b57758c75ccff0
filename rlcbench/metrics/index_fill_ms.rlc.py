"""index_fill_ms.rlc (ms): per build, the time in the program's
``repro_torch.condensed.index_fill`` spans (the ``RLCIndex`` made and
filled one entry at a time, both sides), averaged over the traced
builds."""
from rlcbench import program_spans


def read(ctx):
    return program_spans.ms_per_build(ctx.trace, program_spans.INDEX_FILL)
