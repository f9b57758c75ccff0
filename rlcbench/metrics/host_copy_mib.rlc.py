"""host_copy_mib.rlc (MiB): per build, the bytes the program's condensed
builds copied between host and card, both directions (its
``rlc_build_host_bytes``: ``up`` the reach handed over as a host array,
``down`` the entries' coordinates), over the builds it counted
(``rlc_build_runs``), backend ``device_condensed``: every build of the
process, the set-up's among them, as ``program_spans.entries_per_build``
counts. Nothing (``None``) where the window's builds ran no device work or
the program has no such counter (a program older than it); ``0.0`` where
it counted no build."""
from rlcbench import program_spans


def read(ctx):
    if program_spans.builds_with_device_work(ctx.trace) is None:
        return None
    registry = program_spans.program_obs().registry
    copied = registry.get("rlc_build_host_bytes")
    if copied is None:
        return None
    runs = registry.get("rlc_build_runs")
    n = runs.value(context="full", backend=program_spans.BACKEND) \
        if runs else 0.0
    if not n:
        return 0.0
    return sum(copied.value(backend=program_spans.BACKEND, direction=d)
               for d in ("up", "down")) / n / 2 ** 20
