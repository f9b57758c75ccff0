"""Roofline analysis of traced dry-run steps (port of
:mod:`repro.roofline`): the card's constants, the reference's terms and
ring formulas, and an op tracer in place of the HLO walk."""
from .analysis import (HW, active_params, collective_bytes_from_trace,
                       model_flops, ring_wire_bytes, roofline_terms)
from .trace_tools import (StepTrace, buffer_histogram, dot_flops_histogram,
                          op_bytes_by_kind, trace_totals)

__all__ = ["HW", "collective_bytes_from_trace", "roofline_terms",
           "model_flops", "active_params", "ring_wire_bytes", "StepTrace",
           "trace_totals", "dot_flops_histogram", "buffer_histogram",
           "op_bytes_by_kind"]
