"""Live graph mutations through the incremental delta-build engine
(``examples/delta_updates.py`` of the JAX package).

Stands up an :class:`RLCService` over a generated graph, then streams
edge insert/delete batches through :meth:`RLCService.apply_delta`: each
delta incrementally re-derives only the affected ``(hub, direction)``
phases (bit-identical to a full rebuild), re-freezes only the dirty row
ranges, and evicts only the cached answers whose ``(s, t)`` rows went
dirty. Every answer is cross-checked against the BiBFS oracle on the
mutated graph, and the replay/re-run accounting is printed per delta.

The build and the delta's traced bootstrap and re-runs go through the
``cuda`` backend (the frontier kernel on the card, its plain version on
the CPU) and answers through the device layout (the merge-join kernel on
the card); the reference serves this example from the host with its
``numpy`` build.

    PYTHONPATH=src python -m repro_torch.examples.delta_updates [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.baselines import bibfs_rlc
from repro_torch.core.devices import resolve_device
from repro_torch.core.minimum_repeat import enumerate_mrs
from repro_torch.examples._cli import parser
from repro_torch.graphgen import erdos_renyi, random_delta
from repro_torch.service import RLCService, ServiceConfig


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    g = erdos_renyi(num_vertices=300, avg_degree=2.2, num_labels=4,
                    seed=42)
    print(f"graph: {g.summary()}")
    out = {"deltas": [], "answers": []}

    with RLCService.build(
            g, ServiceConfig(k=2, device=str(dev), build_backend="cuda",
                             cache_capacity=2048,
                             delta_fallback_frac=0.5)) as svc:
        queries = [(int(rng.integers(300)), int(rng.integers(300)), mr)
                   for mr in enumerate_mrs(4, 2) for _ in range(4)]
        svc.query_batch(queries)          # warm the cache
        out["entries"] = svc.index.num_entries()
        print(f"index: {svc.index.num_entries()} entries; "
              f"cache primed with {len(svc.cache)} answers")

        for step in range(5):
            delta = random_delta(svc.graph, 2, 2, rng)
            t0 = time.perf_counter()
            summary = svc.apply_delta(delta)
            dt = (time.perf_counter() - t0) * 1e3
            d = summary["delta"]
            print(f"delta {step}: +{len(delta.inserts)}/-"
                  f"{len(delta.deletes)} edges in {dt:.1f}ms — "
                  f"replayed {d['phases_replayed']}/{d['phases_total']} "
                  f"phases, re-ran {d['phases_rerun']} "
                  f"(causes {d['causes']}), {d['dirty_rows']} dirty rows, "
                  f"{summary['cache_evicted']} cache evictions"
                  + (" [fallback rebuild]" if d["fallback"] else ""))
            out["deltas"].append({
                **{k: d[k] for k in ("phases_replayed", "phases_total",
                                     "phases_rerun", "causes",
                                     "dirty_rows", "fallback")},
                "cache_evicted": summary["cache_evicted"],
                "entries": svc.index.num_entries()})

            answers = svc.query_batch(queries)
            want = [bibfs_rlc(svc.graph, s, t, mr) for s, t, mr in queries]
            assert answers == want, "delta-served answers diverged!"
            out["answers"].append([bool(a) for a in answers])
        st = svc.stats()
        print(f"done: {st['queries_served']} queries served, "
              f"{st['deltas_applied']} deltas applied, cache hit-rate "
              f"{st['cache']['hit_rate']:.2f}, invalidations "
              f"{st['cache']['invalidations']}")
        out.update(queries_served=st["queries_served"],
                   deltas_applied=st["deltas_applied"],
                   invalidations=st["cache"]["invalidations"])
    return out


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
