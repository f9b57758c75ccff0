"""Device selection for the port's entry points.

Entry points take an explicit ``device`` (default ``"cuda"``). Asking for
a CUDA device where none is present raises here, before any state is
built, instead of quietly serving from the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
