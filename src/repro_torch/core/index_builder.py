"""Back-compat shim — Algorithm 2 lives in :mod:`repro_torch.build`.

The historical surface (``IndexBuilder``, ``build_rlc_index``,
``build_rlc_index_with_stats``, ``BuildStats``) is re-exported unchanged;
``build_rlc_index(g, k)`` resolves ``backend="auto"`` (the vectorized
numpy pipeline, bit-identical to the python reference). The faithful
sequential implementation is
:class:`repro_torch.build.reference.PythonBackend`.
"""
from __future__ import annotations

from repro_torch.build import (BuildStats, IndexBuilder, build_rlc_index,
                               build_rlc_index_with_stats)

__all__ = ["BuildStats", "IndexBuilder", "build_rlc_index",
           "build_rlc_index_with_stats"]
