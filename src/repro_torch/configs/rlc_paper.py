"""The paper's own workload configs: RLC index build + query serving cells.

Not an LM architecture — these parameterize the dense semiring engine
(core/dense.py) for the dry-run/roofline of the paper's technique itself:
``rlc-index`` cells lower the hub-batched build step and the batched
query join on the production mesh.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class RLCCell:
    name: str
    num_vertices: int
    num_labels: int
    k: int
    hub_batch: int
    query_batch: int
    row_len: int  # padded index row length for the query join


RLC_CELLS = {
    # pod-scale dense engine: 64k-vertex partition per pod, |L|=8, k=2
    "rlc-build-64k": RLCCell("rlc-build-64k", 65_536, 8, 2,
                             hub_batch=256, query_batch=0, row_len=0),
    # serving: 1M queries/batch against a 1M-vertex frozen index
    "rlc-query-1m": RLCCell("rlc-query-1m", 1_048_576, 8, 2,
                            hub_batch=0, query_batch=1_048_576,
                            row_len=128),
    # §Perf iteration 1: sorted-key searchsorted join (same workload)
    "rlc-query-1m-sorted": RLCCell("rlc-query-1m-sorted", 1_048_576, 8, 2,
                                   hub_batch=0, query_batch=1_048_576,
                                   row_len=128),
}
