"""The port's roofline analysis (``repro_torch.roofline``) against
``repro.roofline`` (the mirror of ``tests/test_sharding_roofline.py``):
the terms at the H100 constants, ``model_flops`` / ``active_params`` on
every full config, the ring formulas against ``collective_bytes_from_hlo``
on the same kinds, output sizes and group sizes, and the op tracer's
per-device counts from local shards. Fake-backend worlds run in a
subprocess and are destroyed there."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ASSIGNED  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models.builder import count_params as j_count  # noqa: E402
from repro.roofline import analysis as J  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import count_params, init_model  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.roofline.trace_tools import (StepTrace,  # noqa: E402
                                              buffer_histogram,
                                              dot_flops_histogram,
                                              op_bytes_by_kind,
                                              trace_totals)


def test_hw_is_the_h100_datasheet():
    assert A.HW.peak_flops == 989e12 and A.HW.hbm_bw == 3.35e12
    assert A.HW.nvlink_bw == 450e9 and A.HW.network_bw == 50e9
    assert A.HW.gpus_per_node == 8


def test_roofline_terms_dominance():
    t = A.roofline_terms(989e12, 3.35e12 / 2, 0.0)   # 1 s compute, 0.5 s
    assert t["dominant"] == "compute_s"
    assert abs(t["roofline_fraction"] - 1.0) < 1e-9
    t2 = A.roofline_terms(989e11, 3.35e12, 0.0)      # 0.1 s vs 1 s memory
    assert t2["dominant"] == "memory_s"
    assert abs(t2["roofline_fraction"] - 0.1) < 1e-9
    # 450 GB on NVLink and 50 GB across nodes: 1 s + 1 s
    t3 = A.roofline_terms(0.0, 0.0, 500e9, network_bytes_per_dev=50e9)
    assert t3["dominant"] == "collective_s"
    assert abs(t3["collective_s"] - 2.0) < 1e-9
    assert set(t) == set(J.roofline_terms(1.0, 1.0, 1.0))


def test_model_flops_shapes():
    class C:
        num_experts = 0
        top_k = 0
    n = 1_000_000
    for kind, seq, batch in (("train", 128, 4), ("prefill", 128, 4),
                             ("decode", 128, 4)):
        assert A.model_flops(C, kind, seq, batch, n) == J.model_flops(
            C, kind, seq, batch, n)
    assert A.model_flops(C, "train", 128, 4, n) == 6 * n * 512


@pytest.mark.parametrize("name", ASSIGNED)
def test_counts_equal_repro_on_full_configs(name):
    cfg, jcfg = get_config(name), jax_config(name)
    n = count_params(init_model(cfg, abstract=True)[0])
    assert n == j_count(j_init_model(jcfg, abstract=True)[0])
    assert A.active_params(cfg, n) == J.active_params(jcfg, n)
    embed = cfg.padded_vocab * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    for kind in ("train", "prefill", "decode"):
        assert A.model_flops(cfg, kind, 4096, 256,
                             A.active_params(cfg, n), embed) == \
            J.model_flops(jcfg, kind, 4096, 256,
                          J.active_params(jcfg, n), embed)


_HLO = {"all-gather": "all-gather", "reduce-scatter": "reduce-scatter",
        "all-reduce": "all-reduce", "all-to-all": "all-to-all",
        "collective-permute": "collective-permute"}


@pytest.mark.parametrize("kind", A.KINDS)
@pytest.mark.parametrize("dims,g", [((1024,), 4), ((64, 32), 8),
                                    ((3, 5, 7), 2), ((4096, 16), 16)])
def test_ring_formulas_equal_collective_bytes_from_hlo(kind, dims, g):
    text = (f"%x = bf16[{','.join(map(str, dims))}]{{0}} {_HLO[kind]}(%y), "
            f"replica_groups=[{64 // g},{g}]<=[64]\n")
    want = J.collective_bytes_from_hlo(text)
    obytes = 2
    for d in dims:
        obytes *= d
    got = A.collective_bytes_from_trace([(kind, obytes, g, False)])
    assert got[kind] == want[kind]
    assert got["total"] == want["total"]
    assert got[f"raw_output_{kind}"] == want[f"raw_output_{kind}"]
    assert got["network"] == 0
    assert A.collective_bytes_from_trace(
        [(kind, obytes, g, True)])["network"] == want["total"]


def test_trace_counts_a_plain_step_as_flop_counter_does():
    """Plain tensors (a one-rank mesh): the tracer's flops are
    ``FlopCounterMode``'s, forward and backward, and its live bytes go
    back to zero once the step's tensors die."""
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 32, generator=g, requires_grad=True)
    b = torch.randn(32, 48, generator=g, requires_grad=True)

    def step():
        loss = torch.tanh(a @ b).sum()
        return torch.autograd.grad(loss, (a, b))

    with StepTrace() as tr:
        grads = step()
    with FlopCounterMode(display=False) as fc:
        step()
    assert trace_totals(tr)["flops"] == fc.get_total_flops() == \
        3 * 2 * 64 * 32 * 48
    assert tr.peak_bytes >= 64 * 48 * 4
    assert tr.live_bytes == sum(x.numel() * 4 for x in grads)
    del grads
    assert tr.live_bytes == 0
    rows = dot_flops_histogram(tr)       # the forward's, the backward's
    assert sum(r[1] for r in rows) == 3 * 2 * 64 * 32 * 48
    assert sum(r[2] for r in rows) == 3
    assert {r[0] for r in rows} == {"<top>", "backward:MmBackward0"}
    assert buffer_histogram(tr, min_bytes=1) and op_bytes_by_kind(tr)


_SHARDED = textwrap.dedent("""
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.roofline.trace_tools import StepTrace, trace_totals
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        mesh = init_device_mesh("cuda", (8,), mesh_dim_names=("data",))
        a = DTensor.from_local(torch.empty(64, 512, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        b = DTensor.from_local(torch.empty(512, 512, device="meta"), mesh,
                               [Replicate()], run_check=False)
        with StepTrace() as tr:
            c = (a @ b).redistribute(mesh, [Replicate()])
        with FlopCounterMode(display=False) as fc:
            a @ b
        t = trace_totals(tr)
        print(t["flops"], fc.get_total_flops(), t["coll_all-gather"],
              t["coll_network"], tr.collectives)
    finally:
        dist.destroy_process_group()
""")


def test_a_product_split_eight_ways_counts_its_share():
    """A 512^3 product split 8 ways on a fake mesh counts 2 * 512^3 / 8
    flops a device (``FlopCounterMode`` counts the global 2 * 512^3); the
    all-gather of its (512, 512) float32 result over 8 ranks of one node
    puts 7/8 of 1 MiB on NVLink."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [p for p in sys.path if p]))
    out = subprocess.run([sys.executable, "-c", _SHARDED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    flops, logical, ag, network, colls = out.stdout.split(maxsplit=4)
    assert float(flops) == 2 * 512 ** 3 / 8
    assert int(logical) == 2 * 512 ** 3
    assert int(ag) == 512 * 512 * 4 * 7 // 8 and int(network) == 0
    assert colls.strip() == str([("all-gather", 512 * 512 * 4, 8, False)])
