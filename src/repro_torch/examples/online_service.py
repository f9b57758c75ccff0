"""Online RLC query service, end to end on the card.

Builds the RLC index for a generated graph, stands up :class:`RLCService`
(build -> freeze -> device layout -> serve), then answers a mixed
true/false query stream — textual ``(label ...)+`` expressions included —
through the result cache and micro-batching scheduler, checking every
answer against the BiBFS oracle. Prints per-backend latency and the cache
hit-rate (``examples/online_service.py`` of the JAX package).

    PYTHONPATH=src python -m repro_torch.examples.online_service [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines import bibfs_rlc
from repro_torch.core.devices import resolve_device
from repro_torch.core.queries import biased_true_queries
from repro_torch.examples._cli import parser
from repro_torch.graphgen import erdos_renyi
from repro_torch.service import ExpressionError, RLCService, ServiceConfig


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    g = erdos_renyi(num_vertices=250, avg_degree=3.5, num_labels=4, seed=42)
    print(f"graph: {g.summary()}")

    svc = RLCService.build(
        g, ServiceConfig(k=2, batch_size=16, max_wait_ms=2.0,
                         cache_capacity=512, device=str(dev),
                         label_names={"knows": 0, "worksFor": 1,
                                      "debits": 2, "credits": 3}))
    st = svc.stats()["index"]
    print(f"index: {st['entries']} entries, {st['size_bytes']} bytes, "
          f"C={st['num_mrs']} MRs, device={st['device']}")

    # -- a few single queries through the textual parser ---------------- #
    singles = []
    for expr in ["(knows)+", "(debits credits)+", "(0 1)+",
                 '("knows worksFor")+']:
        s, t = int(rng.integers(250)), int(rng.integers(250))
        a = svc.query(s, t, expr)
        singles.append(bool(a))
        print(f"  Q({s}, {t}, {expr}) = {a}")
    try:
        svc.query(0, 1, "(knows worksFor debits)+")   # |MR| = 3 > k = 2
        rejected = None
    except ExpressionError as e:
        rejected = str(e)
        print(f"  rejected as expected: {e}")

    # -- mixed true/false stream with Zipf popularity ------------------- #
    qs = biased_true_queries(g, k=2, n=150, seed=7)
    pool = qs.true_queries + qs.false_queries
    rng.shuffle(pool)
    w = np.arange(1, len(pool) + 1, dtype=np.float64) ** -1.0
    w /= w.sum()
    stream = [pool[i] for i in rng.choice(len(pool), size=1500, p=w)]
    print(f"\nserving {len(stream)} requests "
          f"({len(qs.true_queries)} true / {len(qs.false_queries)} false "
          f"distinct queries, Zipf popularity) ...")

    answers = []
    for i in range(0, len(stream), 50):   # arrivals in chunks of 50
        answers.extend(svc.query_batch(stream[i:i + 50]))

    # verify against the oracle
    wrong = sum(1 for (s, t, L), a in zip(stream, answers)
                if a != bibfs_rlc(g, s, t, L))
    n_true = sum(bool(a) for a in answers)
    print(f"answers: {n_true} true / {len(answers) - n_true} false, "
          f"{wrong} oracle mismatches")
    assert wrong == 0

    stats = svc.stats()
    c = stats["cache"]
    print(f"\ncache: {c['hits']} hits / {c['misses']} misses "
          f"(hit-rate {c['hit_rate']:.1%}, {c['evictions']} evictions)")
    sch = stats["scheduler"]
    print(f"scheduler: {sch['batches_full']} full, "
          f"{sch['batches_deadline']} deadline, "
          f"{sch['batches_drain']} drain flushes")
    print("backends:")
    for name, b in stats["executor"]["backends"].items():
        print(f"  {name:7s} {b['batches']:4d} batches "
              f"{b['queries']:5d} queries  p50 {b['p50_ms']:7.3f} ms  "
              f"p99 {b['p99_ms']:7.3f} ms  {b['qps']:9.0f} q/s")
    print(f"  fallbacks: {stats['executor']['fallbacks']}")
    return {"entries": st["entries"], "num_mrs": st["num_mrs"],
            "singles": singles, "rejected": rejected,
            "answers": [bool(a) for a in answers], "wrong": wrong,
            "cache": {k: c[k] for k in ("hits", "misses", "evictions")},
            "computed": sum(b["queries"] for b in
                            stats["executor"]["backends"].values()),
            "backends": sorted(stats["executor"]["backends"]),
            "fallbacks": stats["executor"]["fallbacks"]}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
