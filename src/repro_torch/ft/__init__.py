"""Fault tolerance (port of :mod:`repro.ft`): the straggler monitor, the
elastic mesh manager and the checkpoint/restart training loop."""
from .elastic import (ElasticMeshManager, LoopReport, StragglerMonitor,
                      resilient_loop)

__all__ = ["StragglerMonitor", "ElasticMeshManager", "LoopReport",
           "resilient_loop"]
