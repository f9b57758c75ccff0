"""Phase 11 of one tree's ``chip_smoke.py`` alone: the parallel build and
the distributed dense engine at AD size, to compare two trees in one
call on one card.

    python3 chip_phase11.py TREE    # TREE holds chip_smoke.py and src/

Builds TREE's kernels, the AD graph, its ``numpy`` build, step 3's
``cuda`` service build and step 4's answers, phase 7's
``DenseEngine.reach``, condensed index and 3,767,616 queries, then runs
TREE's ``run_parallel_build`` and ``run_distributed``, which print their
lines and raise if a check fails. Run each tree in its own process, for
example each unpacked with ``git archive`` under ``.trees/``.
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
        print("chip_phase11: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    cs = importlib.import_module("chip_smoke")
    from repro_torch.build import build_rlc_index_with_stats
    from repro_torch.core import dense
    from repro_torch.core.queries import biased_true_queries
    from repro_torch.graphgen import barabasi_albert
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.service import RLCService, ServiceConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree.name}: torch {torch.__version__} ({card})",
          flush=True)
    _build.build(["mergejoin", "label_frontier", "bool_semiring"])
    g = barabasi_albert(**cs.AD)
    t0 = time.perf_counter()
    numpy_build = build_rlc_index_with_stats(g, cs.K, backend="numpy")
    print(f"tree {tree.name}: numpy build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    svc = RLCService.build(g, ServiceConfig(k=cs.K, device="cuda"))
    qs = biased_true_queries(g, cs.K, 2000, seed=cs.SEED)
    queries = list(dict.fromkeys(qs.true_queries + qs.false_queries))
    want = [a.value for a in svc.query_batch(queries)]
    eng = dense.DenseEngine.build(g, cs.K, device="cuda")
    condensed, _ = dense.build_condensed_device(
        g, cs.K, hub_batch=cs.HUB_BATCH, reach=eng.reach, device="cuda")
    rng = np.random.default_rng(cs.SEED)
    src = np.sort(rng.choice(g.num_vertices, 64, replace=False))
    big_q = tuple(a.ravel() for a in np.meshgrid(
        src, np.arange(g.num_vertices), np.arange(len(eng.mrs)),
        indexing="ij"))
    t0 = time.perf_counter()
    par = cs.run_parallel_build(torch, card, g, svc, numpy_build, queries,
                                want, KERNELS)
    dist = cs.run_distributed(torch, card, g, eng.reach, condensed, big_q,
                              KERNELS, rng)
    print(f"tree {tree.name}: phase 11 {time.perf_counter() - t0:.1f} s; "
          f"launches {par} {dist}", flush=True)
    svc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
