"""Paper Example 1: fraud-pattern reachability on the Fig. 1 network
(``examples/fraud_detection.py`` of the JAX package).

Detects (debits, credits)+ money-movement chains between accounts with
the RLC index, then scales the same query workload up on a synthetic
transaction graph served by the batched device engine: one batch through
the merge-join kernel on the card (its plain version on the CPU).

    PYTHONPATH=src python -m repro_torch.examples.fraud_detection [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.devices import resolve_device
from repro_torch.core.index_builder import build_rlc_index
from repro_torch.core.queries import generate_queries
from repro_torch.examples._cli import parser
from repro_torch.graphgen import fig1_graph, random_labeled_graph


def main(device="cuda") -> dict:
    dev_type = resolve_device(device)
    g, names, labels = fig1_graph()
    idx = build_rlc_index(g, k=3)
    D, C = labels["debits"], labels["credits"]
    K, W = labels["knows"], labels["worksFor"]

    q1 = idx.query(names["A14"], names["A19"], (D, C))
    q2 = idx.query(names["P10"], names["P13"], (K, K, W))
    print(f"Q1(A14, A19, (debits.credits)+) = {q1}   (paper: true)")
    print(f"Q2(P10, P13, (knows.knows.worksFor)+) = {q2}   (paper: false)")
    assert q1 is True and q2 is False

    # scale up: synthetic transaction network, batched screening
    print("\nScaled screening on a synthetic transaction graph:")
    big = random_labeled_graph(num_vertices=300, num_edges=1500,
                               num_labels=5, seed=13, self_loop_frac=0.02)
    bidx = build_rlc_index(big, k=2)
    dev = DeviceIndex.from_index(bidx, big.num_labels, device=dev_type)
    qs = generate_queries(big, 2, n_true=128, n_false=128, seed=3)
    trips = qs.all()
    s = np.array([q[0] for q in trips], np.int32)
    t = np.array([q[1] for q in trips], np.int32)
    m = np.array([dev.mr_ids[q[2]] for q in trips], np.int32)
    ans = dev.query_batch(s, t, m, use_kernel=True)
    hits = int(ans.sum())
    print(f"  screened {len(trips)} account pairs in one device batch: "
          f"{hits} suspicious chains found")
    assert hits == len(qs.true_queries)
    return {"q1": q1, "q2": q2, "entries": bidx.num_entries(),
            "answers": [bool(a) for a in ans], "hits": hits}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
