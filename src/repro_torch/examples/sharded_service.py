"""Sharded RLC serving, end to end on the card
(``examples/sharded_service.py`` of the JAX package).

Walks the whole distributed path: plan entry-balanced shards over the
frozen index, stand up :class:`ShardedRLCService` (4 shards x 2 replicas,
in-process shard workers, every layout on the one card), serve a Zipf
stream through the two-sided router — same-shard queries run locally,
cross-shard queries ship s's out-row digest to t's owning shard — then
hot-swap a freshly rebuilt index under the running service and keep
serving. Every answer is checked against the BiBFS oracle.

The port publishes a swap to every shard at once, between batches; the
reference rolls it shard by shard, so its post-swap report differs. The
answers do not.

    PYTHONPATH=src python -m repro_torch.examples.sharded_service [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines import bibfs_rlc
from repro_torch.core.devices import resolve_device
from repro_torch.core.queries import biased_true_queries
from repro_torch.examples._cli import parser
from repro_torch.graphgen import erdos_renyi
from repro_torch.service import ShardedRLCService, ShardedServiceConfig


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n = 300
    g = erdos_renyi(num_vertices=n, avg_degree=3.5, num_labels=4, seed=42)
    print(f"graph: {g.summary()}")

    svc = ShardedRLCService.build(
        g, ShardedServiceConfig(k=2, batch_size=16, max_wait_ms=2.0,
                                cache_capacity=512, num_shards=4,
                                num_replicas=2, device=str(dev)))
    plan = svc.plan.as_dict()
    print(f"plan: {plan}")
    shards = svc.stats()["shards"]
    for sh in shards:
        print(f"  shard {sh['shard']}: vertices [{sh['lo']}, {sh['hi']}) "
              f"{sh['entries']} entries {sh['size_bytes']} B "
              f"x{sh['replicas']} replicas device={sh['device']}")

    # -- Zipf stream through router + scatter/gather --------------------- #
    qs = biased_true_queries(g, k=2, n=150, seed=7)
    pool = qs.true_queries + qs.false_queries
    rng.shuffle(pool)
    w = np.arange(1, len(pool) + 1, dtype=np.float64) ** -1.0
    w /= w.sum()
    stream = [pool[i] for i in rng.choice(len(pool), size=1200, p=w)]
    print(f"\nserving {len(stream)} requests across 4 shards ...")

    answers = []
    for i in range(0, len(stream), 50):
        answers.extend(svc.query_batch(stream[i:i + 50]))
    wrong = sum(1 for (s, t, L), a in zip(stream, answers)
                if a != bibfs_rlc(g, s, t, L))
    n_true = sum(bool(a) for a in answers)
    print(f"answers: {n_true} true / {len(answers) - n_true} "
          f"false, {wrong} oracle mismatches")
    assert wrong == 0

    st = svc.stats()
    r = st["router"]
    print(f"router: {r['local']} local / {r['remote']} cross-shard "
          f"(local ratio {r['local_ratio']:.1%})")
    ex = st["executor"]
    print(f"fan-out: {ex['local']['batches']} local sub-batches, "
          f"{ex['remote']['batches']} remote "
          f"({ex['remote_joins_device']} device joins, "
          f"{ex['remote_joins_numpy']} numpy), "
          f"{ex['digest_bytes'] / 1024:.1f} KiB digests shipped")
    c = st["cache"]
    print(f"cache: hit-rate {c['hit_rate']:.1%}; "
          f"coalesced {st['scheduler']['coalesced']} duplicate in-flight")

    # -- hot swap under traffic ------------------------------------------ #
    g2 = erdos_renyi(num_vertices=n, avg_degree=5.0, num_labels=4, seed=43)
    print("\ngraph updated; rebuilding + swapping every shard at once ...")
    gen = svc.hot_swap(graph=g2)
    print(f"now serving generation {gen}")
    answers2 = svc.query_batch(stream[:300])
    wrong2 = sum(1 for (s, t, L), a in zip(stream[:300], answers2)
                 if a != bibfs_rlc(g2, s, t, L))
    changed = sum(1 for a, b in zip(answers[:300], answers2) if a != b)
    print(f"post-swap: {wrong2} oracle mismatches, "
          f"{changed}/300 answers changed with the new graph")
    assert wrong2 == 0
    svc.close()
    return {"plan": plan,
            "shards": [(sh["lo"], sh["hi"], sh["entries"]) for sh in shards],
            "answers": [bool(a) for a in answers], "wrong": wrong,
            "router": (r["local"], r["remote"]),
            "remote_joins_numpy": ex["remote_joins_numpy"],
            "generation": gen,
            "answers2": [bool(a) for a in answers2], "wrong2": wrong2,
            "changed": changed}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
