"""Logical-axis sharding rules (port of :mod:`repro.sharding`)."""
from .partition import (ACT_RULES, PARAM_RULES, NamedSharding, constrain,
                        logical_to_sharding, logical_to_spec, mesh_context,
                        place_tree, tree_shardings)

__all__ = ["PARAM_RULES", "ACT_RULES", "logical_to_spec",
           "logical_to_sharding", "constrain", "NamedSharding",
           "mesh_context", "place_tree", "tree_shardings"]
