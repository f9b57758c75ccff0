"""Synthetic LM data (port of :mod:`repro.data`)."""
from .pipeline import DataConfig, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData"]
