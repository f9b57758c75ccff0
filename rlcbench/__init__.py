"""The benchmark of ``repro_torch`` on one NVIDIA H100: device builds of
the RLC index and of its transitive closure (see ``README.md``)."""
