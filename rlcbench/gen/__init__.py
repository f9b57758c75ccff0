"""A frozen copy of the workload generator."""
