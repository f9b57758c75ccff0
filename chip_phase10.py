"""Phase 10 of one tree's ``chip_smoke.py`` alone: sharded and RPC
serving of the AD-size index, to compare two trees in one call on one
card.

    python3 chip_phase10.py TREE    # TREE holds chip_smoke.py and src/

Builds TREE's kernels, the AD graph, its index (``numpy`` build), the
step-4 query stream and the single host's answers on the card, then runs
TREE's ``run_sharded``, which prints its lines and raises if a check
fails. Run each tree in its own process (parent, change, change,
parent), for example each unpacked with ``git archive`` under
``.trees/``.
"""
import importlib
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_phase10: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    cs = importlib.import_module("chip_smoke")
    from repro_torch.build import build_rlc_index_with_stats
    from repro_torch.core.queries import biased_true_queries
    from repro_torch.graphgen import barabasi_albert
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.service import RLCService, ServiceConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["mergejoin", "label_frontier", "bool_semiring"])
    print(f"tree {tree.name}: kernel build "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    g = barabasi_albert(**cs.AD)
    index, _ = build_rlc_index_with_stats(g, cs.K, backend="numpy")
    qs = biased_true_queries(g, cs.K, 2000, seed=cs.SEED)
    queries = list(dict.fromkeys(qs.true_queries + qs.false_queries))
    svc = RLCService(g, index, ServiceConfig(k=cs.K, device="cuda"))
    want = [a.value for a in svc.query_batch(queries)]
    svc.close()
    out = cs.run_sharded(torch, card, g, index, queries, want, KERNELS,
                         np.random.default_rng(cs.SEED))
    print(f"tree {tree.name}: merge launches {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
