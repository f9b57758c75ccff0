"""Fault tolerance (port of :mod:`repro.ft`, so far the straggler
monitor the RPC shard cluster watches its workers with)."""
from .elastic import StragglerMonitor

__all__ = ["StragglerMonitor"]
