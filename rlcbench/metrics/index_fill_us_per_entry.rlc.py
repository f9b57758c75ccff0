"""index_fill_us_per_entry.rlc (us/entry): the time in the program's
``repro_torch.condensed.index_fill`` spans a build (``index_fill_ms.rlc``)
over the entries a build hands to the ``RLCIndex`` (the program's
``rlc_build_entries``, both sides, over its ``rlc_build_runs``, backend
``device_condensed``): the host's fill cost an entry."""
from rlcbench import program_spans


def read(ctx):
    return program_spans.fill_us_per_entry(ctx.trace)
