"""prepare_ms.rlc (ms): per build, the time in the program's
``repro_torch.condensed.prepare`` span (access order, the reach up to the
card as float32, the entry stacks), averaged over the traced builds."""
from rlcbench import program_spans


def read(ctx):
    return program_spans.ms_per_build(ctx.trace, program_spans.PREPARE)
