"""Distributed RLC index build + query serving on a device mesh
(``examples/distributed_index.py`` of the JAX package, which runs on an
8-device CPU mesh).

The port is SPMD over ``torch.distributed``: the mesh is made over the
world this process finds, ``("pod", "data")`` with ``pod = 2`` on an
even world and 1 otherwise; with no world it starts one of one rank
(NCCL on the card, gloo on the CPU) and destroys it at the end. Run it
once, or once a rank under a launcher that sets up the world. The
reachability products run through the ``bool_matmul`` kernel and the
queries through the merge-join kernel on the card (their plain versions
on the CPU).

    PYTHONPATH=src python -m repro_torch.examples.distributed_index [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from repro_torch.core.baselines import bfs_rlc
from repro_torch.core.device_index import DeviceIndex
from repro_torch.core.devices import resolve_device
from repro_torch.core.distributed import (distributed_build,
                                          distributed_query_batch,
                                          init_world, make_rlc_mesh,
                                          mesh_device)
from repro_torch.core.minimum_repeat import mr_id_space
from repro_torch.examples._cli import parser
from repro_torch.graphgen import erdos_renyi


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    started = init_world(dev)
    try:
        world = dist.get_world_size()
        print(f"devices: {world}")
        pod = 2 if world % 2 == 0 else 1
        mesh = make_rlc_mesh(data=world // pod, pod=pod, device=dev)
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

        g = erdos_renyi(num_vertices=64, avg_degree=3.0, num_labels=3,
                        seed=5)
        k = 2
        idx, eng = distributed_build(g, k, mesh, hub_batch=8)
        print(f"distributed build: {idx.num_entries()} entries over "
              f"{len(eng.mrs)} minimum repeats")

        dindex = DeviceIndex.from_index(idx, g.num_labels,
                                        device=mesh_device(mesh))
        ids = mr_id_space(g.num_labels, k)
        rng = np.random.default_rng(0)
        Q = 512
        s = rng.integers(0, g.num_vertices, Q).astype(np.int32)
        t = rng.integers(0, g.num_vertices, Q).astype(np.int32)
        mr_list = list(ids.items())
        pick = rng.integers(0, len(mr_list), Q)
        m = np.array([mr_list[i][1] for i in pick], np.int32)
        ans = distributed_query_batch(dindex, s, t, m, mesh)
        # verify a sample against the oracle
        for i in range(0, Q, 37):
            L = mr_list[pick[i]][0]
            assert bool(ans[i]) == bfs_rlc(g, int(s[i]), int(t[i]), L)
        print(f"served {Q} queries on the mesh: {int(ans.sum())} true "
              f"(oracle-verified sample)")
        return {"world": world, "mesh": tuple(mesh.shape),
                "entries": sorted(_entries(idx)), "num_mrs": len(eng.mrs),
                "answers": [bool(a) for a in ans]}
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _entries(idx):
    """Every (vertex, direction, hub, MR) entry of an index."""
    for v in range(idx.num_vertices):
        for side, rows in (("in", idx.l_in[v]), ("out", idx.l_out[v])):
            for h, mrs in rows.items():
                for mr in mrs:
                    yield v, side, h, tuple(mr)


if __name__ == "__main__":
    main(parser(__doc__).parse_args().device)
