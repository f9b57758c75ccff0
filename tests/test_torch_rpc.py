"""Port multi-process shard serving (``repro_torch.service.rpc``).

Three layers, cheapest first: the wire codec (msgpack and JSON, whose
frames the JAX package's codec decodes and vice versa), the
:class:`ShardWorker` protocol driven without a process (replies equal
the reference worker's), then real spawn-based clusters (worker count
from ``RLC_RPC_WORKERS``, default 2): answers bit-identical to the
port's in-process sharded service and single host across a mid-stream
hot swap, ``apply_delta``, worker death and leave/rejoin. Only a lost
worker takes the BiBFS path; a worker's own error raises. The shards x
replicas sweep is ``slow``-marked, as the reference's is.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import graphgen as tgen  # noqa: E402
from repro_torch.build import build_rlc_index as t_build  # noqa: E402
from repro_torch.core.minimum_repeat import (enumerate_mrs,  # noqa: E402
                                             mr_id_space)
from repro_torch.service import (RLCService, ServiceConfig,  # noqa: E402
                                 ShardedRLCService, ShardedServiceConfig,
                                 validate_stats)
from repro_torch.service.rpc import (RemoteError, ShardWorker,  # noqa: E402
                                     WorkerLost, wire)
from repro_torch.service.rpc.controller import _slice_payload  # noqa: E402

K = 2
#: CI knob: how many worker processes the cheap cluster tests may spawn
WORKERS = max(1, int(os.environ.get("RLC_RPC_WORKERS", "2")))


def frozen_clock():
    return 0.0


def _graph(n=80, seed=11):
    return tgen.erdos_renyi(n, 3.0, 3, seed=seed)


def _queries(g, n=40, seed=0):
    rng = np.random.default_rng(seed)
    st = rng.integers(0, g.num_vertices, size=(n, 2))
    mrs = list(enumerate_mrs(g.num_labels, K))
    return [(int(s), int(t), mrs[i % len(mrs)])
            for i, (s, t) in enumerate(st)]


def _cfg(**kw):
    cfg = dict(k=K, batch_size=8, device="cpu", clock=frozen_clock)
    cfg.update(kw)
    return cfg


def _single(g):
    return RLCService.build(g, ServiceConfig(**_cfg()))


def _rpc(g, num_shards=None, num_replicas=1, **kw):
    return ShardedRLCService.build(g, ShardedServiceConfig(**_cfg(
        num_shards=num_shards or min(WORKERS, 2),
        num_replicas=num_replicas, transport="rpc", **kw)))


def _bools(answers):
    return [bool(a) for a in answers]


def _fleet_down(svc):
    return all(not h.proc.is_alive()
               for hs in svc.cluster.handles.values() for h in hs)


# ------------------------------------------------------------------ #
# Wire codec
# ------------------------------------------------------------------ #
DOC = dict(
    method="execute", id=7, ok=True, name="s0r1",
    s=np.arange(5, dtype=np.int32),
    aid=np.array([2 ** 40, -3], dtype=np.int64),
    flags=np.array([True, False]),
    nested=dict(hub=np.empty(0, dtype=np.int32), note=None),
    seq=[1, "two", 3.5])


def _check_doc(out):
    assert out["method"] == "execute" and out["id"] == 7
    assert out["ok"] is True and out["nested"]["note"] is None
    for path in (("s",), ("aid",), ("flags",), ("nested", "hub")):
        got, want = out, DOC
        for k in path:
            got, want = got[k], want[k]
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert list(out["seq"]) == [1, "two", 3.5]


@pytest.mark.parametrize("codec", ["msgpack", "json"])
def test_wire_roundtrips_and_speaks_the_reference_codec(codec, monkeypatch):
    """Each codec round-trips scalars, arrays and nesting, and its frames
    decode with the JAX package's codec and back: a port controller and
    a reference worker could share a socket."""
    if codec == "json":
        monkeypatch.setattr(wire, "msgpack", None)
    elif wire.msgpack is None:
        pytest.skip("msgpack is not installed")
    assert wire.codec_name() == codec
    frame = wire.encode(DOC)
    assert frame[:1] == (b"J" if codec == "json" else b"M")
    _check_doc(wire.decode(frame))
    pytest.importorskip("jax")
    jwire = pytest.importorskip("repro.service.rpc.wire")
    if codec == "json":
        monkeypatch.setattr(jwire, "msgpack", None)
    _check_doc(jwire.decode(frame))
    _check_doc(wire.decode(jwire.encode(DOC)))
    with pytest.raises(ValueError):
        wire.decode(b"X" + frame[1:])


# ------------------------------------------------------------------ #
# ShardWorker protocol (no processes)
# ------------------------------------------------------------------ #
def _id_to_mr(ids):
    return [mr for mr, _ in sorted(ids.items(), key=lambda kv: kv[1])]


def _worker_for(g, lo, hi, generation=0):
    idx = t_build(g, K)
    ids = mr_id_space(g.num_labels, K)
    frozen = idx.freeze(ids)
    payload = _slice_payload(frozen.slice_rows(lo, hi), lo, hi,
                             generation, _id_to_mr(ids))
    w = ShardWorker("t0")
    reply = w.on_init(dict(payload, shard_id=0, replica_id=0))
    assert reply["generation"] == generation
    return w, frozen, idx, ids, payload


def test_shard_worker_replies_equal_the_reference_workers():
    pytest.importorskip("jax")
    jworker = pytest.importorskip("repro.service.rpc.worker")
    g = _graph(50, seed=3)
    w, frozen, idx, ids, payload = _worker_for(g, 10, 40)
    jw = jworker.ShardWorker("j0")
    jw.on_init(dict(payload, shard_id=0, replica_id=0))
    qs = [q for q in _queries(g, 48, seed=1)
          if 10 <= q[0] < 40 and 10 <= q[1] < 40]
    s = np.array([q[0] for q in qs], dtype=np.int32)
    t = np.array([q[1] for q in qs], dtype=np.int32)
    mr = np.array([ids[q[2]] for q in qs], dtype=np.int32)
    msg = dict(method="execute", id=1, s=s, t=t, mr=mr)
    (reply, keep), (jreply, _) = w.handle(msg), jw.handle(msg)
    assert keep and reply["ok"] and jreply["ok"]
    np.testing.assert_array_equal(reply["ans"], jreply["ans"])
    assert list(reply["ans"]) == [idx.query(int(a), int(b), q[2])
                                  for a, b, q in zip(s, t, qs)]
    dig = dict(method="gather_digest", id=2, s=s.astype(np.int64))
    (mine, _), (theirs, _) = w.handle(dig), jw.handle(dig)
    for k in ("indptr", "hub", "mr"):
        np.testing.assert_array_equal(mine[k], theirs[k])
    stats, _ = w.handle(dict(method="stats", id=3))
    assert stats["queries"] == len(qs) and stats["batches"] == 1
    assert stats["digests"] == len(qs)


def test_shard_worker_rejects_unknown_method_and_stale_swap():
    g = _graph(40, seed=5)
    w, frozen, _idx, ids, _ = _worker_for(g, 0, g.num_vertices,
                                          generation=3)
    reply, keep = w.handle(dict(method="frobnicate", id=9))
    assert keep and not reply["ok"] and "unknown method" in reply["error"]
    stale = _slice_payload(frozen.slice_rows(0, g.num_vertices), 0,
                           g.num_vertices, 1, _id_to_mr(ids))
    reply, keep = w.handle(dict(stale, method="swap", id=10))
    assert keep and not reply["ok"] and "stale swap" in reply["error"]
    assert w.generation == 3 and w.swaps == 0
    fresh = _slice_payload(frozen.slice_rows(0, g.num_vertices), 0,
                           g.num_vertices, 4, _id_to_mr(ids))
    reply, keep = w.handle(dict(fresh, method="swap", id=11))
    # staged beside generation 3, which serves until the commit
    assert reply["ok"] and reply["staged"] == 4
    assert w.generation == 3 and w.swaps == 0
    reply, keep = w.handle(dict(method="commit", id=12, generation=5))
    assert keep and not reply["ok"] and w.generation == 3
    reply, keep = w.handle(dict(method="commit", id=13, generation=4))
    assert reply["ok"] and w.generation == 4 and w.swaps == 1
    reply, keep = w.handle(dict(method="commit", id=14, generation=4))
    assert not reply["ok"], "a commit without a staged generation"
    reply, keep = w.handle(dict(method="shutdown", id=15))
    assert reply["ok"] and not keep


def test_shard_worker_digest_hop_matches_direct_execution():
    g = _graph(60, seed=7)
    mid = g.num_vertices // 2
    w_lo, frozen, idx, ids, _ = _worker_for(g, 0, mid)
    w_hi = ShardWorker("t1")
    w_hi.on_init(dict(_slice_payload(frozen.slice_rows(mid,
                                                       g.num_vertices),
                                     mid, g.num_vertices, 0,
                                     _id_to_mr(ids)),
                      shard_id=1, replica_id=0))
    qs = [(s, t, mr) for s, t, mr in _queries(g, 24, seed=2)
          if s < mid <= t]
    assert qs, "need at least one genuinely cross-shard query"
    s = np.array([q[0] for q in qs], dtype=np.int64)
    dig, _ = w_lo.handle(dict(method="gather_digest", id=1, s=s))
    assert dig["ok"]
    join, _ = w_hi.handle(dict(
        method="join_digest", id=2, s=s,
        t=np.array([q[1] for q in qs], dtype=np.int64),
        mr=np.array([ids[q[2]] for q in qs], dtype=np.int64),
        digest_indptr=dig["indptr"], digest_hub=dig["hub"],
        digest_mr=dig["mr"]))
    assert join["ok"]
    assert list(join["ans"]) == [idx.query(int(a), int(b), mr)
                                 for a, b, mr in qs]
    assert w_lo.digests == len(qs) and w_hi.joins == len(qs)


def test_shard_worker_serves_from_the_host():
    g = _graph(30, seed=9)
    w, *_ = _worker_for(g, 0, g.num_vertices)
    assert w.executor.device_index is None
    assert w.executor.backend == "numpy" and not w.executor.on_cuda


# ------------------------------------------------------------------ #
# Spawn-based cluster (env-gated: RLC_RPC_WORKERS)
# ------------------------------------------------------------------ #
def test_rpc_cluster_matches_inproc_and_single_host():
    g = _graph()
    qs = _queries(g)
    want = _bools(_single(g).query_batch(qs))
    shards = min(WORKERS, 2)
    inproc = ShardedRLCService.build(g, ShardedServiceConfig(**_cfg(
        num_shards=shards)))
    assert _bools(inproc.query_batch(qs)) == want
    svc = _rpc(g)
    try:
        got = svc.query_batch(qs)
        assert _bools(got) == want
        backends = {a.backend for a in got if a.disposition == "computed"}
        assert backends <= {"rpc:numpy", "rpc:digest"}
        if shards > 1:
            assert "rpc:digest" in backends, "no cross-shard query ran"
        # the same batches fan out to the same sub-batches as in process
        ex, ix = svc.stats()["executor"], inproc.stats()["executor"]
        assert ex["sub_batches"] == ix["sub_batches"]
        assert ex["remote_joins_rpc"] == ix["remote_joins_device"]
        st = validate_stats(svc.stats())
        assert st["transport"] == "rpc"
        assert st["rpc"]["live_workers"] == \
            svc.config.num_shards * svc.config.num_replicas
        assert st["rpc"]["wire_bytes"]["sent"] > 0
        assert st["rpc"]["wire_bytes"]["received"] > 0
        assert all(row["backends"].keys() <= {"numpy"}
                   for row in st["shards"])
        again = svc.query_batch(qs)
        assert {a.disposition for a in again} == {"cache_hit"}
        assert svc.explain(*qs[0])["answer"] == want[0]
    finally:
        svc.close()
    assert _fleet_down(svc)


def test_rpc_async_submit_with_mid_stream_swap():
    g = _graph(seed=13)
    qs = _queries(g, 32, seed=4)
    want = _bools(_single(g).query_batch(qs))
    svc = _rpc(g)
    try:
        with svc.start():
            futs = [svc.submit(s, t, c) for s, t, c in qs[:16]]
            swapped = svc.hot_swap()
            futs += [svc.submit(s, t, c) for s, t, c in qs[16:]]
            svc._engine.flush()
            got = [f.result(timeout=60) for f in futs]
        assert _bools(got) == want
        assert swapped >= 1
        assert svc.stats()["rpc"]["generation"] == svc.generation
    finally:
        svc.close()
    assert _fleet_down(svc)


def test_rpc_apply_delta_matches_inproc_and_a_fresh_build():
    g = _graph(60, seed=17)
    svc = _rpc(g, delta_fallback_frac=1.0)
    inproc = ShardedRLCService.build(g, ShardedServiceConfig(**_cfg(
        num_shards=svc.config.num_shards, delta_fallback_frac=1.0)))
    rng = np.random.default_rng(23)
    try:
        for _ in range(2):
            delta = tgen.random_delta(svc.graph, 2, 2, rng)
            a, b = svc.apply_delta(delta), inproc.apply_delta(delta)
            assert a["shards_touched"] == b["shards_touched"]
            qs = _queries(svc.graph, 24, seed=int(rng.integers(1 << 30)))
            got = _bools(svc.query_batch(qs))
            assert got == _bools(inproc.query_batch(qs))
            fresh = t_build(svc.graph, K, backend="python")
            assert got == [fresh.query(s, t, mr) for s, t, mr in qs]
        assert svc.deltas_applied == 2
    finally:
        svc.close()


def test_rpc_batches_between_stage_and_commit_see_one_generation():
    """A batch served after every worker staged the swapped graph's
    slices, but before the commit, answers wholly from the old
    generation (no cross-shard join meets two); after the commit, from
    the new one. Nothing degrades."""
    g, g2 = _graph(seed=41), tgen.erdos_renyi(80, 5.0, 3, seed=42)
    qs = _queries(g, 40, seed=12)
    old = _bools(_single(g).query_batch(qs))
    new = _bools(_single(g2).query_batch(qs))
    assert old != new
    svc = _rpc(g)
    real, mid, staged = svc.cluster.stage, [], []

    def stage(sid, generation, frozen_slice):
        n = real(sid, generation, frozen_slice)
        staged.append(sid)
        if len(staged) == svc.config.num_shards:    # all staged, no commit
            svc.cache.clear()
            mid.append(_bools(svc.query_batch(qs)))
        return n

    try:
        svc.cluster.stage = stage
        svc.hot_swap(graph=g2)
        svc.cache.clear()
        after = _bools(svc.query_batch(qs))
        degraded = svc.stats()["executor"]["degraded"]
        generations = {h.generation for hs in svc.cluster.handles.values()
                       for h in hs}
    finally:
        svc.cluster.stage = real
        svc.close()
    assert _fleet_down(svc)
    assert mid == [old] and after == new
    assert degraded == 0 and generations == {1}


def test_rpc_transport_takes_only_the_host_device():
    g = _graph(40, seed=43)
    idx = t_build(g, K)
    with pytest.raises(ValueError, match="serves from the host"):
        ShardedRLCService(g, idx, ShardedServiceConfig(**_cfg(
            transport="rpc", device="cuda")))
    with pytest.raises(ValueError, match="serves from the host"):
        ShardedRLCService.build(g, ShardedServiceConfig(**_cfg(
            transport="rpc", device="cuda:0")), index=idx)


def test_rpc_worker_death_fails_over_to_sibling_replica():
    g = _graph(seed=19)
    qs = _queries(g, 30, seed=6)
    want = _bools(_single(g).query_batch(qs))
    svc = _rpc(g, num_shards=1, num_replicas=2)
    try:
        victim = svc.cluster.handles[0][0]
        victim.proc.terminate()
        victim.proc.join(timeout=10)
        got = svc.query_batch(qs)
        assert _bools(got) == want
        st = svc.stats()["rpc"]
        assert st["live_workers"] == 1
        assert st["retries"] >= 1
        assert not victim.alive
        assert svc.stats()["executor"]["degraded"] == 0
    finally:
        svc.close()


def test_rpc_worker_leave_and_rejoin_mid_stream():
    g = _graph(seed=29)
    qs = _queries(g, 30, seed=8)
    want = _bools(_single(g).query_batch(qs))
    svc = _rpc(g, num_shards=min(WORKERS, 2), num_replicas=1)
    try:
        assert _bools(svc.query_batch(qs)) == want
        svc.cluster.leave(0, 0)
        svc.cache.clear()
        degraded = svc.query_batch(qs)
        assert _bools(degraded) == want, \
            "answers must stay exact while shard 0 has no workers"
        assert any(a.disposition == "degraded" for a in degraded)
        svc.cluster.rejoin(0, 0)
        svc.cache.clear()
        healed = svc.query_batch(qs)
        assert _bools(healed) == want
        assert all(a.disposition != "degraded" for a in healed)
        st = validate_stats(svc.stats())["rpc"]
        assert st["leaves"] == 1 and st["rejoins"] == 1
        assert st["membership_epoch"] >= 2
    finally:
        svc.close()
    assert _fleet_down(svc)


def test_only_a_lost_worker_takes_the_bibfs_path():
    """A worker's application error (``RemoteError``) raises to the
    caller; a lost worker (``WorkerLost``) is answered exactly by
    BiBFS."""
    g = _graph(seed=37)
    qs = _queries(g, 16, seed=10)
    want = _bools(_single(g).query_batch(qs))
    svc = _rpc(g, num_shards=1)
    real = svc.cluster.execute

    def remote_error(*args, **kw):
        raise RemoteError("ValueError('bad slice')")

    def lost(*args, **kw):
        raise WorkerLost("shard 0 has no serving worker")

    try:
        svc.cluster.execute = remote_error
        with pytest.raises(RemoteError):
            svc.query_batch(qs)
        assert svc.stats()["executor"]["degraded"] == 0
        svc.cluster.execute = lost
        svc.cache.clear()
        got = svc.query_batch(qs)
        assert _bools(got) == want
        assert svc.stats()["executor"]["degraded"] > 0
        svc.cluster.execute = real
        svc.cache.clear()
        assert _bools(svc.query_batch(qs)) == want
    finally:
        svc.cluster.execute = real
        svc.close()


@pytest.mark.slow
def test_rpc_bit_identical_sweep_shards_by_replicas():
    """Shards {1,2,4} x replicas {1,2}, each cell bit-identical to the
    in-process sharded service and the single host, including a
    mid-stream hot swap."""
    g = _graph(100, seed=31)
    qs = _queries(g, 60, seed=9)
    want = _bools(_single(g).query_batch(qs))
    for num_shards in (1, 2, 4):
        for num_replicas in (1, 2):
            inproc = ShardedRLCService.build(g, ShardedServiceConfig(
                **_cfg(num_shards=num_shards, num_replicas=num_replicas)))
            assert _bools(inproc.query_batch(qs)) == want
            svc = _rpc(g, num_shards=num_shards,
                       num_replicas=num_replicas)
            try:
                assert _bools(svc.query_batch(qs)) == want, \
                    f"shards={num_shards} replicas={num_replicas}"
                svc.hot_swap()
                svc.cache.clear()
                assert _bools(svc.query_batch(qs)) == want, \
                    f"post-swap shards={num_shards} " \
                    f"replicas={num_replicas}"
                validate_stats(svc.stats())
            finally:
                svc.close()
            assert _fleet_down(svc)
