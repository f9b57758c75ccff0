"""Quickstart: build an RLC index on the paper's Fig. 2 graph and answer
the Example 4 queries (``examples/quickstart.py`` of the JAX package).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The build and the queries run on the host, as in the reference; the
device is checked all the same (``cuda`` without a card raises).
"""
from __future__ import annotations

from repro_torch.core.baselines import bfs_rlc
from repro_torch.core.devices import resolve_device
from repro_torch.core.index_builder import build_rlc_index_with_stats
from repro_torch.examples._cli import parser
from repro_torch.graphgen import fig2_graph


def main(device="cuda") -> dict:
    resolve_device(device)
    g, names = fig2_graph()
    print(f"Fig.2 graph: |V|={g.num_vertices} |E|={g.num_edges} "
          f"|L|={g.num_labels}")

    idx, stats = build_rlc_index_with_stats(g, k=2)
    print(f"RLC index built: {idx.num_entries()} entries "
          f"({idx.size_bytes()} bytes), condensed={idx.is_condensed()}")
    print(f"  pruned: PR1={stats.pruned_pr1} PR2={stats.pruned_pr2} "
          f"PR3 cuts={stats.pr3_cuts}")

    l1, l2 = 0, 1
    queries = [
        ("Q1 (v3 ->(l2.l1)+ v6)", names["v3"], names["v6"], (l2, l1)),
        ("Q2 (v1 ->(l2.l1)+ v2)", names["v1"], names["v2"], (l2, l1)),
        ("Q3 (v1 ->(l1)+    v3)", names["v1"], names["v3"], (l1,)),
    ]
    answers = []
    for label, s, t, L in queries:
        ans = idx.query(s, t, L)
        oracle = bfs_rlc(g, s, t, L)
        assert ans == oracle
        answers.append(ans)
        print(f"  {label}: {ans}   (oracle: {oracle})")

    # per-vertex index content, like the paper's Table II
    print("\nIndex entries (Table II layout):")
    rows = []
    for v in range(g.num_vertices):
        fmt = lambda d: ", ".join(  # noqa: E731
            f"(v{h+1},{'.'.join(f'l{x+1}' for x in mr)})"
            for h, mrs in sorted(d.items()) for mr in sorted(mrs))
        rows.append(f"  v{v+1}: L_in=[{fmt(idx.l_in[v])}] "
                    f"L_out=[{fmt(idx.l_out[v])}]")
        print(rows[-1])
    return {"entries": idx.num_entries(), "size_bytes": idx.size_bytes(),
            "condensed": idx.is_condensed(),
            "pruned": (stats.pruned_pr1, stats.pruned_pr2, stats.pr3_cuts),
            "answers": answers, "table": rows}


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
