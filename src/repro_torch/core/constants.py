"""Shared constants for the padded index layouts.

``PAD`` fills unused slots in every padded per-vertex row (DeviceIndex
arrays, CUDA kernel inputs, scheduler batch padding). It is a vertex /
MR id that can never occur (ids are non-negative), so padded slots never
match a real hub, query vertex or constraint.
"""

PAD = -1
