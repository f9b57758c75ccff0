#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once at the published size of the paper's
Advogato graph (AD: 6,541 vertices, 3 labels, k = 2) through the entry
points a user calls:

1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` for each source, all started together;
2. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, and times both with CUDA events:
   the merge join at 65,536 random queries (full-height and windowed
   rows) and at a served batch of 32, the frontier wave at R = 300, 150
   and 15 rows;
3. ``RLCService.build`` on the card with the default build backend, which
   there is the ``cuda`` one (frontier kernel); its entries and pruning
   counters must equal the ``numpy`` build's;
4. ``RLCService.query_batch`` on ~4k distinct queries plus a repeated
   pass: every computed answer must come from the ``cuda`` backend (merge
   kernel), with no fallback, equal to the host CSR join and, on a
   sample, to the BiBFS oracle;
5. one ``DeviceIndex.query_batch`` of 65,536 queries through the kernel,
   compared in full with the CSR join.

6. holds the dense engine's kernels (``bool_matmul``, ``closure_step``)
   and the rest of the kernel surface (``bitpack_matmul``,
   ``frontier_step``, ``frontier_steps``) against their plain versions on
   the card, bit for bit, at the dense engine's shapes (``n = 6541``
   padded to 6656), and times each beside its plain version and, where
   one PyTorch call computes the same function, that call; the three
   semiring rows (``bool_matmul``, ``closure_step``, ``frontier_step``)
   are timed in float32 (the kernels line) and in bf16, each beside
   ``torch.matmul`` in the same dtype, with the route (wgmma or split-K
   kernel, staged or not) each shape took; ``bitpack_matmul`` also at the
   BFS's 150 rows, ``frontier_steps`` also per wave and as a whole call
   with the wrapper's packing of ``A``;
7. the dense path: ``DenseEngine.build`` on the card (bf16 stacks, every
   product through the semiring kernels; its ``reach`` must equal the
   plain path's), ``build_condensed_device`` at ``hub_batch = 8`` and an
   ``RLCService`` over the condensed index, whose answers to 64 sources x
   all targets x all MRs, through the merge kernel, must equal ``reach``
   and the step-3 index's answers; those two 3,767,616-query launches
   (E = 40 and E = 80) are then timed alone;
8. the kernel surface's path: product-automaton BFS from sampled sources
   through ``frontier_step``, ``frontier_steps`` and ``bitpack_matmul``,
   whose visited sets must equal ``reach``;
9. the whole single-host service on the card (:func:`run_full_service`):
   the step-3 index adopted under the control plane (SLO batching,
   depth-bound admission, cache warming), shadow verification and span
   sampling; four threads ``submit()`` the step-4 stream to the async
   engine, two chained ``apply_delta`` calls of 32 inserts and 32
   deletes run while the engine runs (each followed by a submit wave
   and held against a fresh ``numpy`` build of the mutated graph),
   then ``explain``, ``audit_report``, ``drain_shadow``, the telemetry
   snapshot and ``stats()`` are checked and ``close()`` must stop every
   thread it started;
10. sharded serving on the card (:func:`run_sharded`): the step-3 index
    adopted by ``ShardedRLCService`` at 2 and 4 shards x 2 replicas,
    each shard's row-windowed layout on the card; the step-4 stream
    through ``query_batch``, a ``submit()`` wave from four threads and a
    wave with a ``hot_swap()`` from a second thread, at 4 shards also one
    ``apply_delta`` of 32 + 32 edges held against a fresh ``numpy``
    build; every answer equal to step 4's, no digest join off the card,
    the merge kernel launched on every shard's layout; then the same
    stream over ``transport="rpc"`` (two shard-host processes answering
    from the host), equal to the in-process answers.

Launch counts are reset to 0 right before steps 3-4, 7, 8, 9 and each
configuration of 10 and read right after each; the ``kernels`` line
reports each kernel's count from
the path that runs it. The merge join, the frontier wave,
``frontier_steps`` and ``bitpack_matmul`` take less time on the card
than a launch from Python, so their kernel times are taken from a
captured CUDA graph (:func:`graph_ms`; the time launched from Python is
logged beside it); every bound counts the bytes and operations of this
run's inputs.
Any failure raises and the script exits non-zero; without a CUDA device,
or without the repository beside it, it exits non-zero before printing a
result. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

AD = dict(num_vertices=6541, m_attach=4, num_labels=3,
          seed=zlib.crc32(b"AD") % 2**31)
K = 2
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside tensor cores
TENSOR_OPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
HUB_BATCH = 8                # distributed_build's default in the reference


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one
    CUDA graph and replayed: the kernels' own time, where launching them
    one by one from Python would leave the card waiting on the host
    (a small kernel takes less than a launch from Python). ``fn`` must
    read the current stream at each call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int):
    """``(graph_ms, cuda_ms)`` of ``fn``: launched from a CUDA graph, and
    launched one by one from Python."""
    return graph_ms(fn, iters), cuda_ms(fn, iters)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = CUDA_CORE_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def mergejoin_bound(d, s, t, mr):
    """The merge join's bound for the queries ``(s, t, mr)`` on the device
    index ``d``: bytes are the ids and answers plus each stored row a
    query touches; operations are 2E Case-2 compares per query and E
    compares per out entry carrying the queried MR."""
    n, E = d.out_hub.shape
    lo, Q = d.row_lo, len(s)
    rows = len(np.unique(s)) + len(np.unique(t))
    nbytes = 3 * 4 * Q + Q + rows * E * 4 * 2
    om, oh = d.out_mr.cpu().numpy(), d.out_hub.cpu().numpy()
    # entries of each stored out row by MR (PAD hubs excluded)
    keep = (oh != -1) & (om >= 0)
    per_mr = np.zeros((n, d.num_mrs), np.int64)
    np.add.at(per_mr, (np.nonzero(keep)[0], om[keep]), 1)
    match = int(per_mr[np.asarray(s) - lo, np.asarray(mr)].sum())
    return bound_ms(nbytes, 2 * E * Q + match * E)


def mergejoin_kernel_ms(torch, d, s, t, mr, iters: int):
    """Device time of one merge-join launch alone on ``(s, t, mr)``, ids
    already on the card: :func:`kernel_ms` over ``iters`` launches."""
    from repro_torch.kernels import mergejoin

    lo = d.row_lo
    ids = torch.from_numpy(np.stack([s, t, mr]).astype(np.int32)).cuda()
    out = torch.empty(len(s), dtype=torch.bool, device="cuda")
    rows = (d.out_hub, d.out_mr, d.in_hub, d.in_mr)
    return kernel_ms(lambda: mergejoin.launch(rows, ids, out, lo, lo), iters)


def call_ms(torch, fn, iters: int) -> float:
    """Host-clock mean of ``fn()`` followed by a synchronise: what a caller
    waits for one call, copies and launch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def check_mergejoin(torch, dev_index, rng, windowed: bool,
                    Q: int = 65_536) -> dict:
    """Merge-join kernel vs its plain version at Q random queries."""
    from repro_torch.kernels import mergejoin, ref

    d = dev_index
    n, E = d.out_hub.shape
    lo = d.row_lo
    s = rng.integers(lo, lo + n, Q).astype(np.int32)
    t = rng.integers(lo, lo + n, Q).astype(np.int32)
    mr = rng.integers(0, d.num_mrs, Q).astype(np.int32)
    got = mergejoin.query_batch(d.out_hub, d.out_mr, d.in_hub, d.in_mr,
                                s, t, mr, row_base_out=lo, row_base_in=lo)
    ts, tt, tm = (torch.from_numpy(a).cuda() for a in (s, t, mr))
    plain = lambda: ref.mergejoin_ref(  # noqa: E731
        d.out_hub, d.out_mr, d.in_hub, d.in_mr, ts, tt, tm, lo, lo)
    want = plain()
    err = float((got.int() - want.int()).abs().max())
    if err != 0.0:
        raise AssertionError(f"merge join differs from its plain version "
                             f"(windowed={windowed}) at "
                             f"{int((got != want).sum())} of {Q} queries")
    ms, stream_ms = mergejoin_kernel_ms(torch, d, s, t, mr, 50)
    plain_ms = cuda_ms(plain, 5)
    b, by = mergejoin_bound(d, s, t, mr)
    call = call_ms(torch, lambda: d.query_batch(s, t, mr, use_kernel=True),
                   50)
    log(f"mergejoin windowed={windowed} rows={n} E={E} Q={Q}: max abs err "
        f"{err}; kernel {ms:.4f} ms (graph; {stream_ms:.4f} ms launched "
        f"from Python), plain {plain_ms:.4f} ms, bound "
        f"{b:.5f} ms ({by}, {b / ms:.1%} of it reached); "
        f"DeviceIndex.query_batch call {call:.4f} ms (host clock: id "
        f"checks and copy, launch, answers back)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def check_frontier(torch, engine, rng, R: int, density: float) -> dict:
    """Frontier kernel vs its plain version on R sparse frontier rows."""
    from repro_torch.kernels import label_frontier, ref

    Vp, nl = engine.Vp, engine.nl
    W = Vp // 32
    A = engine._A[False]
    F = np.zeros((R, Vp), np.float32)
    F[:, :engine.V] = rng.random((R, engine.V)) < density
    labels = rng.integers(0, nl, R).astype(np.int32)
    tF = torch.from_numpy(F).cuda()
    got = label_frontier.frontier_step_many(tF, A, labels)
    tl = torch.from_numpy(labels).cuda()
    plain = lambda: ref.frontier_step_many_ref(tF, A, tl)  # noqa: E731
    want = plain()
    # on the 0/1 frontier values the packed words stand for
    err = float((ref.unpack_bits(got) - ref.unpack_bits(want)).abs().max())
    if err != 0.0:
        raise AssertionError(f"frontier step differs from its plain version "
                             f"at R={R} in {int((got != want).sum())} words")
    out = torch.empty((R, W), dtype=torch.int32, device="cuda")
    kernel = lambda: label_frontier.KERNEL(  # noqa: E731
        tF.data_ptr(), A.data_ptr(), tl.data_ptr(), out.data_ptr(), R, Vp,
        W, torch.cuda.current_stream().cuda_stream)
    ms, stream_ms = kernel_ms(kernel, 50)
    plain_ms = cuda_ms(plain, 3)
    # bytes: F, labels and the output once, plus the packed adjacency
    # row of every distinct (label, frontier vertex) pair
    nz_r, nz_u = np.nonzero(F)
    pairs = len(np.unique(labels[nz_r].astype(np.int64) * Vp + nz_u))
    nbytes = F.nbytes + labels.nbytes + R * W * 4 + pairs * W * 4
    ops = len(nz_r) * W + R * Vp   # word ORs + frontier compares
    b, by = bound_ms(nbytes, ops)
    log(f"frontier R={R} Vp={Vp} |L|={nl} nnz={len(nz_r)}: max abs err "
        f"{err}; kernel {ms:.4f} ms (graph; {stream_ms:.4f} ms launched "
        f"from Python), plain {plain_ms:.4f} ms, bound "
        f"{b:.5f} ms ({by}, {b / ms:.1%} of it reached)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


def compare(name: str, got, want) -> float:
    """Largest absolute difference of two results (0/1 values, or int32
    words read as their 0/1 bits); raises unless it is 0."""
    import torch
    from repro_torch.kernels import ref
    if got.dtype == torch.int32:
        got, want = ref.unpack_bits(got), ref.unpack_bits(want)
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    if err != 0.0 or got.shape != want.shape:
        raise AssertionError(f"{name} differs from its plain version: max "
                             f"abs err {err}, shapes {tuple(got.shape)} "
                             f"{tuple(want.shape)}")
    return err


def timed(name: str, err: float, kernel, plain, library, nbytes: float,
          ops: float, ops_per_s: float, iters: int, note: str,
          graph: bool = False) -> dict:
    """Time the kernel, its plain version and the library call (or None)
    with CUDA events; the bound from the bytes and operations given. With
    ``graph``, the kernel's time is :func:`graph_ms` (the time launched
    from Python is logged beside it)."""
    if graph:
        ms, stream_ms = kernel_ms(kernel, iters)
        how = f" (graph; {stream_ms:.4f} ms launched from Python)"
    else:
        ms, how = cuda_ms(kernel, iters), ""
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 3) if library is not None else None
    b, by = bound_ms(nbytes, ops, ops_per_s)
    lib = f"{library_ms:.4f} ms" if library_ms is not None else "none"
    log(f"{name} {note}: max abs err {err}; kernel {ms:.4f} ms{how}, plain "
        f"{plain_ms:.4f} ms, library {lib}, bound {b:.5f} ms ({by}, "
        f"{b / ms:.1%} of it reached)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=library_ms)


def route_note(a, b) -> str:
    """The semiring kernel that the product ``a @ b`` is routed to."""
    from repro_torch.kernels import bool_semiring
    rt = bool_semiring.route_of(a, b)
    staged = [side for side, on in (("a", rt.stage_a), ("b", rt.stage_b))
              if on]
    return f"route {rt.kernel}" + (f", {'+'.join(staged)} staged"
                                   if staged else "")


def bf16_timing(name: str, kernel, library, nbytes: float, ops: float,
                note: str) -> None:
    """Time a semiring entry point on bf16 operands beside
    ``torch.matmul`` on the same bf16 operands (the main path's dtype on
    the dense engine); logged, not part of the kernels line."""
    ms = cuda_ms(kernel, 10)
    lib = cuda_ms(library, 5)
    b, by = bound_ms(nbytes, ops, TENSOR_OPS_PER_S)
    log(f"{name} bf16 {note}: kernel {ms:.4f} ms, library {lib:.4f} ms "
        f"(torch.matmul, bf16), bound {b:.5f} ms ({by}, {b / ms:.1%} of "
        f"it reached)")


def packed_rows_bytes(F, labels, Vp: int, W: int) -> int:
    """Bytes of the packed adjacency rows a wave reads: one row of W words
    for every distinct (label, non-zero frontier column) pair."""
    r, u = np.nonzero(F)
    labels = np.broadcast_to(np.asarray(labels), (F.shape[0],))
    return len(np.unique(labels[r].astype(np.int64) * Vp + u)) * W * 4


def check_dense_kernels(torch, g, rng) -> dict:
    """The dense engine's kernels and the rest of the kernel surface
    against their plain versions at the dense engine's shapes (n = 6541
    padded to the tile, 6656)."""
    from repro_torch.core import dense
    from repro_torch.kernels import bitpack, label_frontier
    from repro_torch.kernels import ops, ref

    A = dense.label_adjacency(g, "cuda")
    nl, n_pad = A.shape[0], A.shape[1]
    n = g.num_vertices
    W = n_pad // 32
    res = {}

    # bool_matmul: one step product of the MR (0, 1), f32 and bf16, and
    # once unpadded (n = 6541: a pitch that only the staged path reads)
    a, b = A[0], A[1]
    got = ops.bool_matmul(a, b)
    err = compare("bool_matmul", got, ref.bool_matmul_ref(a, b))
    for x, y, what in ((a.bfloat16(), b.bfloat16(), "bf16"),
                       (a[:n, :n].contiguous(), b[:n, :n].contiguous(),
                        f"unpadded n={n}")):
        ok = compare(f"bool_matmul {what}", ops.bool_matmul(x, y),
                     ref.bool_matmul_ref(x, y))
        log(f"bool_matmul {what} ({route_note(x, y)}): max abs err {ok}")
    ab, bb = a.bfloat16(), b.bfloat16()
    bf16_timing("bool_matmul", lambda: ops.bool_matmul(ab, bb),
                lambda: torch.matmul(ab, bb), 3 * n_pad * n_pad * 2,
                2 * n_pad ** 3, f"{n_pad}^3, {route_note(ab, bb)}")
    del ab, bb
    res["bool_matmul"] = timed(
        "bool_matmul", err, lambda: ops.bool_matmul(a, b),
        lambda: ref.bool_matmul_ref(a, b), lambda: torch.matmul(a, b),
        3 * n_pad * n_pad * 4, 2 * n_pad ** 3, TENSOR_OPS_PER_S, 10,
        f"f32 {n_pad}x{n_pad}x{n_pad}, {route_note(a, b)}")

    # closure_step on that step matrix, the first doubling step's input
    M = got
    out = torch.empty_like(M)
    err = compare("closure_step", ops.closure_step(M, out=out),
                  ref.fused_closure_step_ref(M))
    Mb = M.bfloat16()
    compare("closure_step bf16", ops.closure_step(Mb),
            ref.fused_closure_step_ref(Mb))
    Mu = M[:n, :n].contiguous()
    compare(f"closure_step unpadded n={n}", ops.closure_step(Mu),
            ref.fused_closure_step_ref(Mu))
    log(f"closure_step unpadded n={n} ({route_note(Mu, Mu)}): max abs err "
        f"0.0")
    del Mu
    outb = torch.empty_like(Mb)
    bf16_timing("closure_step", lambda: ops.closure_step(Mb, out=outb),
                lambda: torch.matmul(Mb, Mb), 2 * n_pad * n_pad * 2,
                2 * n_pad ** 3, f"n={n_pad}, {route_note(Mb, Mb)}")
    del Mb, outb
    res["closure_step"] = timed(
        "closure_step", err, lambda: ops.closure_step(M, out=out),
        lambda: ref.fused_closure_step_ref(M), lambda: torch.matmul(M, M),
        2 * n_pad * n_pad * 4, 2 * n_pad ** 3, TENSOR_OPS_PER_S, 10,
        f"f32 n={n_pad}, {route_note(M, M)}")

    # bitpack_matmul: the step matrix against the packed A[2]
    P = ref.pack_bits(A[2])
    got = bitpack.bitpack_matmul(M, P)
    err = compare("bitpack_matmul", got, ref.bitpack_matmul_ref(M, P))
    Mh = M.cpu().numpy()
    rows = int(np.count_nonzero(Mh.any(axis=0)))
    nnz = int(np.count_nonzero(Mh))
    res["bitpack_matmul"] = timed(
        "bitpack_matmul", err, lambda: bitpack.bitpack_matmul(M, P),
        lambda: ref.bitpack_matmul_ref(M, P), None,
        M.numel() * 4 + n_pad * W * 4 + rows * W * 4,
        nnz * W + M.numel(), CUDA_CORE_OPS_PER_S, 20,
        f"a {n_pad}x{n_pad} ({nnz} > 0), b {n_pad}x{W} words", graph=True)
    # ... and at the surface BFS's shape: 150 frontier rows (rows of the
    # step matrix, 150 sampled vertices' first step)
    rows150 = torch.from_numpy(np.sort(rng.choice(n, 150, replace=False)))
    a150 = M[rows150.cuda()].contiguous()
    e150 = compare("bitpack_matmul M=150", bitpack.bitpack_matmul(a150, P),
                   ref.bitpack_matmul_ref(a150, P))
    ah = Mh[rows150.numpy()]
    sel = int(np.count_nonzero(ah.any(axis=0)))
    timed("bitpack_matmul", e150, lambda: bitpack.bitpack_matmul(a150, P),
          lambda: ref.bitpack_matmul_ref(a150, P), None,
          a150.numel() * 4 + 150 * W * 4 + sel * W * 4,
          int(np.count_nonzero(ah)) * W + a150.numel(), CUDA_CORE_OPS_PER_S,
          50, f"M=150: a 150x{n_pad} ({int(np.count_nonzero(ah))} > 0), "
          f"b {n_pad}x{W} words", graph=True)
    del Mh, ah, a150

    # frontier_step: 300 frontier rows, 1 % dense, on the dense A[1]
    B = 300
    F = np.zeros((B, n_pad), np.float32)
    F[:, :n] = rng.random((B, n)) < 0.01
    tF = torch.from_numpy(F).cuda()
    got = label_frontier.frontier_step(tF, A, 1)
    err = compare("frontier_step", got, ref.frontier_step_ref(tF, A, 1))
    Fb, Ab = tF.bfloat16(), A.bfloat16()
    compare("frontier_step bf16", label_frontier.frontier_step(Fb, Ab, 1),
            ref.frontier_step_ref(Fb, Ab, 1))
    bf16_timing("frontier_step", lambda: label_frontier.frontier_step(
        Fb, Ab, 1), lambda: torch.matmul(Fb, Ab[1]),
        (2 * B * n_pad + n_pad * n_pad) * 2, 2 * B * n_pad * n_pad,
        f"B={B} V={n_pad}, {route_note(Fb, Ab[1])}")
    del Fb, Ab
    res["frontier_step"] = timed(
        "frontier_step", err, lambda: label_frontier.frontier_step(tF, A, 1),
        lambda: ref.frontier_step_ref(tF, A, 1),
        lambda: torch.matmul(tF, A[1]),
        (2 * B * n_pad + n_pad * n_pad) * 4, 2 * B * n_pad * n_pad,
        TENSOR_OPS_PER_S, 20, f"B={B} V={n_pad}, {route_note(tF, A[1])}")

    # frontier_steps: R = 300, T = 2, a cyclic row shift after each wave
    T = 2
    labels = rng.integers(0, nl, (T, B)).astype(np.int32)
    dst = np.tile((np.arange(B) + B // 2) % B, (T, 1)).astype(np.int32)
    got = label_frontier.frontier_steps(tF, A, labels, dst)
    tl, td = (torch.from_numpy(x) for x in (labels, dst))
    err = compare("frontier_steps", got,
                  ref.frontier_steps_ref(tF, A, tl, td))
    # the kernel alone: T launches over the slices packed once, the
    # frontier bit-packed between waves
    used, local = label_frontier.packed_slices(labels, nl)
    AP = bitpack.pack_slices(A, used, n_pad)
    sched = torch.from_numpy(np.stack([local, dst])).cuda()
    words = torch.empty((B, W), dtype=torch.int32, device="cuda")
    dense_out = torch.empty_like(tF)

    def waves():
        src = tF
        for t in range(T):
            nxt = dense_out if t == T - 1 else words
            label_frontier.STEPS_KERNEL(
                src.data_ptr(), AP.data_ptr(), sched[0, t].data_ptr(),
                sched[1, t].data_ptr(), nxt.data_ptr(), B, n_pad, W,
                int(t > 0), int(t == T - 1),
                torch.cuda.current_stream().cuda_stream)
            src = nxt
    # the whole call's bytes: F read once, the output written once, the
    # schedules, and the packed rows each wave selects; its operations:
    # the word ORs of each wave and one test per frontier entry a wave
    # reads (all of F at the first wave, words after it)
    nbytes = 2 * F.nbytes + 2 * 4 * T * B
    ops_ = B * n_pad
    Ft = F
    for t in range(T):
        nbytes += packed_rows_bytes(Ft, labels[t], n_pad, W)
        ops_ += int(np.count_nonzero(Ft)) * W + (B * W if t else 0)
        Ft = ref.frontier_steps_ref(
            torch.from_numpy(Ft).cuda(), A, tl[t:t + 1],
            td[t:t + 1]).cpu().numpy()
    res["frontier_steps"] = timed(
        "frontier_steps", err, waves,
        lambda: ref.frontier_steps_ref(tF, A, tl, td), None, nbytes, ops_,
        CUDA_CORE_OPS_PER_S, 20, f"R={B} V={n_pad} T={T}, cyclic dst",
        graph=True)
    r = res["frontier_steps"]
    call = cuda_ms(lambda: label_frontier.frontier_steps(tF, A, labels, dst),
                   10)
    log(f"frontier_steps R={B} V={n_pad} T={T}: {r['ms'] / T:.4f} ms a "
        f"wave; the call with the wrapper's packing of A {call:.4f} ms "
        f"(CUDA events)")
    return res


def counted(torch, kernels, names, run):
    """Run ``run()`` with every launch count at 0; return its result and
    the counts of ``names`` right after (each must be > 0)."""
    for kern in kernels.values():
        kern.launches = 0
    out = run()
    torch.cuda.synchronize()
    counts = {name: kernels[name].launches for name in names}
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    return out, counts


def bfs_closure(torch, step, seeds):
    """Rows of vertices reached by one or more repetitions: ``step(X)``
    advances frontier rows X by one repetition; pruned on the card."""
    X = seeds
    visited = torch.zeros_like(seeds)
    while True:
        Y = step(X)
        X = Y * (1 - visited)
        if not X.any():
            return visited
        visited = torch.maximum(visited, Y)


def run_surface_path(torch, g, eng, rng):
    """Product-automaton BFS from 150 sampled sources along length-2 MRs,
    through the kernel surface: ``frontier_step`` for (0, 1),
    ``frontier_steps`` for (0, 2) and (2, 0) at once (one row per source
    and phase, a cyclic row shift after each wave), ``bitpack_matmul`` for
    (1, 2). Each visited set must equal the dense engine's ``reach``."""
    from repro_torch.core import dense
    from repro_torch.kernels import bitpack, label_frontier
    from repro_torch.kernels import ops, ref

    A = dense.label_adjacency(g, "cuda")
    n, n_pad = g.num_vertices, A.shape[1]
    S = np.sort(rng.choice(n, 150, replace=False))
    seeds = torch.zeros((len(S), n_pad), device="cuda")
    seeds[torch.arange(len(S)), torch.from_numpy(S).cuda()] = 1
    got = {}

    got[(0, 1)] = bfs_closure(torch, lambda X: ops.frontier_step(
        ops.frontier_step(X, A, 0), A, 1), seeds)

    B = len(S)
    labels = np.tile([0] * B + [2] * B, (2, 1))   # the same at each wave
    dst = np.tile((np.arange(2 * B) + B) % (2 * B), (2, 1))
    both = bfs_closure(
        torch, lambda X: label_frontier.frontier_steps(X, A, labels, dst),
        torch.cat([seeds, seeds]))
    got[(0, 2)], got[(2, 0)] = both[:B], both[B:]

    P1, P2 = ref.pack_bits(A[1]), ref.pack_bits(A[2])
    got[(1, 2)] = bfs_closure(torch, lambda X: ref.unpack_bits(
        bitpack.bitpack_matmul(ref.unpack_bits(
            bitpack.bitpack_matmul(X, P1)), P2)), seeds)

    for mr, visited in got.items():
        want = eng.reach[eng.mr_ids[mr]][S]
        if not np.array_equal(visited[:, :n].cpu().numpy() > 0, want):
            raise AssertionError(f"BFS along {mr} differs from reach")
    return len(S)


def submit_wave(svc, queries, threads: int = 4):
    """``queries`` submitted from ``threads`` threads; returns the answers
    (``result()`` of every future), the wall seconds from the first
    submit to the last answer, and each future's latency (host clock,
    submit to resolution)."""
    import threading

    n = len(queries)
    futs, t_sub, t_done = [None] * n, np.zeros(n), np.zeros(n)
    resolved = threading.Semaphore(0)

    def done(i):
        t_done[i] = time.perf_counter()
        resolved.release()

    def run(lo):
        for i in range(lo, n, threads):
            t_sub[i] = time.perf_counter()
            futs[i] = svc.submit(*queries[i])
            futs[i].add_done_callback(lambda _f, i=i: done(i))

    t0 = time.perf_counter()
    workers = [threading.Thread(target=run, args=(i,))
               for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    answers = [f.result(timeout=300) for f in futs]   # raises a batch's error
    for _ in range(n):
        resolved.acquire()
    return answers, time.perf_counter() - t0, t_done - t_sub


def check_wave(svc, queries, answers, frozen, mr_ids, g, rng,
               n_oracle: int = 0) -> int:
    """Every answer that is not SHED equals the CSR join of ``frozen``
    (and, on ``n_oracle`` samples, the BiBFS oracle); computed answers
    come from backend ``cuda``. Returns the number shed."""
    from repro_torch.core.baselines import bibfs_rlc
    from repro_torch.service import SHED

    live = [i for i, a in enumerate(answers) if a is not SHED]
    backends = {answers[i].backend for i in live
                if answers[i].disposition == "computed"}
    if backends - {"cuda"}:
        raise AssertionError(f"computed answers came from {backends}")
    s, t, m = (np.array([f(queries[i]) for i in live]) for f in (
        lambda q: q[0], lambda q: q[1], lambda q: mr_ids[q[2]]))
    want = frozen.query_batch(s, t, m)
    if [answers[i].value for i in live] != want.tolist():
        raise AssertionError("submitted answers differ from the CSR join")
    if n_oracle:
        for i in rng.choice(live, size=min(n_oracle, len(live)),
                            replace=False).tolist():
            if bibfs_rlc(g, *queries[i]) != answers[i].value:
                raise AssertionError(f"answer {i} differs from the oracle")
    return len(answers) - len(live)


def numpy_reference(graph, mr_ids):
    """A fresh ``numpy`` build of ``graph``, in a worker process: its
    entry sets, counters, frozen layout and wall seconds."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.build import build_rlc_index_with_stats
    t0 = time.perf_counter()
    idx, st = build_rlc_index_with_stats(graph, K, backend="numpy")
    return (entry_sets(idx), st.counters(), idx.freeze(mr_ids),
            time.perf_counter() - t0)


def run_full_service(torch, card, g, index, queries, kernels, rng) -> dict:
    """Phase 9: the whole single-host service on the card, counted.

    Adopts ``index`` (the step-3 build, so nothing is built before
    serving) under the control plane, shadow verification and span
    sampling; every batch the async engine's thread flushes, every warm
    batch and every batch after a delta goes through the merge kernel,
    and the delta builder's traced bootstrap and dirty phases take device
    waves through the ``cuda`` backend. The two deltas are drawn up
    front, so the fresh ``numpy`` builds of the mutated graphs that each
    apply is held against run in two worker processes meanwhile. Raises
    on any failed check; returns the phase's launch counts."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core.queries import biased_true_queries
    from repro_torch.graphgen import random_delta
    from repro_torch.obs import (fingerprint, replay_witness,
                                 validate_audit_report, validate_snapshot,
                                 verify_witness_entries)
    from repro_torch.service import RLCService, ServiceConfig, validate_stats

    cfg = ServiceConfig(
        k=K, device="cuda", batch_size=32, max_wait_ms=2.0,
        target_p99_ms=5.0, warm_capacity=256, admission_max_pending=4096,
        shadow_sample_rate=0.05, trace_sample_rate=0.01,
        delta_fallback_frac=1.0)
    for kern in kernels.values():
        kern.launches = 0
    svc = RLCService(g, index, cfg)
    mr_ids = svc.mr_ids
    svc.start()

    last = {}

    def log_wave(what, answers, wall, lat, shed):
        """One wave's throughput and latency, and where its time went:
        the engine's batches (executed, mean fill, execute and admission
        time) and the scheduler's full and deadline flushes."""
        computed = sum(a.disposition == "computed" for a in answers)
        now = dict(svc._engine.stats())
        now.update(full=svc.batcher.batches_full,
                   deadline=svc.batcher.batches_deadline)
        d = {k: now[k] - last.get(k, 0) for k in (
            "exec_batches", "exec_s", "admit_s", "full", "deadline")}
        last.update(now)
        per = max(d["exec_batches"], 1)
        log(f"phase 9 {what}: {len(answers)} submits from 4 threads in "
            f"{wall:.3f} s = {len(answers) / wall:.0f} queries/s; future "
            f"latency p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
            f"{np.percentile(lat, 99) * 1e3:.3f} ms (host clock); "
            f"{computed} computed, {shed} shed; {d['exec_batches']} batches "
            f"({computed / per:.2f} queries a batch, "
            f"{d['exec_s'] / per * 1e3:.3f} ms each to execute; "
            f"{d['full']} full, {d['deadline']} deadline flushes), "
            f"admission {d['admit_s'] / len(answers) * 1e3:.3f} ms a submit; "
            f"controller {svc.ctl.slo.stats()['batch_size']} / "
            f"{svc.ctl.slo.stats()['max_wait_ms']} ms ({card})")

    # the deltas, and the numpy builds of the graphs they make
    drng = np.random.default_rng(SEED + 9)
    deltas, graphs = [], [g]
    for _ in range(2):
        deltas.append(random_delta(graphs[-1], 32, 32, drng))
        graphs.append(graphs[-1].apply_delta(deltas[-1]))
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(2, mp_context=spawn) as pool:
        refs = [pool.submit(numpy_reference, gr, mr_ids)
                for gr in graphs[1:]]

        # 1-2: the step-4 stream, then a repeated pass
        for what in ("serve", "repeated pass"):
            answers, wall, lat = submit_wave(svc, queries)
            shed = check_wave(svc, queries, answers, svc.frozen, mr_ids, g,
                              rng, n_oracle=256 if what == "serve" else 0)
            log_wave(what, answers, wall, lat, shed)

        # 3: two chained deltas while the engine runs
        before = kernels["label_frontier"].launches
        t0 = time.perf_counter()
        svc._ensure_delta_builder()     # the traced bootstrap, timed apart
        boot_s = time.perf_counter() - t0
        boot_launches = kernels["label_frontier"].launches - before
        log(f"phase 9 delta bootstrap (traced cuda build of the adopted "
            f"graph): {boot_s:.2f} s, frontier launches {boot_launches} "
            f"({card})")
        if boot_launches == 0:
            raise AssertionError("the delta bootstrap launched no frontier "
                                 "kernel")
        for step, delta, graph, ref in zip((1, 2), deltas, graphs[1:], refs):
            before = kernels["label_frontier"].launches
            t0 = time.perf_counter()
            summary = svc.apply_delta(delta)
            apply_s = time.perf_counter() - t0
            launched = kernels["label_frontier"].launches - before
            ref_entries, ref_counters, frozen, ref_s = ref.result()
            if not np.array_equal(svc.graph.edges, graph.edges):
                raise AssertionError(f"delta {step}: the mutated graph "
                                     f"differs")
            if entry_sets(svc.index) != ref_entries:
                raise AssertionError(f"delta {step}: entries differ from a "
                                     f"fresh numpy build")
            if svc.build_stats.counters() != ref_counters:
                raise AssertionError(f"delta {step}: counters differ")
            d = summary["delta"]
            warm = summary["warm"] or {}
            log(f"phase 9 apply_delta {step} (32 inserts, 32 deletes): "
                f"{apply_s:.2f} s, fallback {d['fallback']}, phases re-run "
                f"{d['phases_rerun']} / replayed {d['phases_replayed']} of "
                f"{d['phases_total']} (causes {d['causes']}), dirty rows "
                f"{d['dirty_rows']}, cache "
                f"evicted {summary['cache_evicted']}, warmed "
                f"{warm.get('warmed')}, frontier launches {launched}; entries "
                f"{svc.index.num_entries()} equal a fresh numpy build "
                f"({ref_s:.2f} s in a worker process) ({card})")
            if d["fallback"]:
                raise AssertionError("delta_fallback_frac=1.0 fell back")
            fresh = biased_true_queries(svc.graph, K, 300, seed=SEED + step)
            wave = queries + fresh.true_queries + fresh.false_queries
            answers, wall, lat = submit_wave(svc, wave)
            shed = check_wave(svc, wave, answers, frozen, mr_ids, svc.graph,
                              rng)
            log_wave(f"wave after delta {step}", answers, wall, lat, shed)
    if svc.executor.fallbacks or svc._engine.failed_batches:
        raise AssertionError(
            f"{svc.executor.fallbacks} fallbacks, "
            f"{svc._engine.failed_batches} failed batches")

    # 4: explain 32 true and 32 false served answers
    served = {q: a.value for q, a in zip(wave, answers) if not a.shed}
    picks = [q for v in (True, False)
             for q in [q for q, x in served.items() if x == v][:32]]
    t0 = time.perf_counter()
    bundles = [svc.explain(*q) for q in picks]
    explain_ms = (time.perf_counter() - t0) / len(picks) * 1e3
    for q, b in zip(picks, bundles):
        if b["answer"] != served[q]:
            raise AssertionError(f"explain answer differs on {q}")
        if b["backend"] != "cuda":
            raise AssertionError(f"explained by {b['backend']!r}")
        if b["answer"] and not (replay_witness(svc.graph, b)
                                and verify_witness_entries(
                                    svc.index, b["witness"], b["mr"])):
            raise AssertionError(f"witness of {q} does not hold")
    kinds = sorted({b["witness"]["kind"] for b in bundles})
    log(f"phase 9 explain: {len(picks)} queries (32 true, 32 false), "
        f"{explain_ms:.3f} ms a query (host clock), witness kinds {kinds}, "
        f"positives replay under BiBFS and cite index entries ({card})")

    # 5: the audit
    t0 = time.perf_counter()
    rep = svc.audit_report(sample=128)
    audit_s = time.perf_counter() - t0
    validate_audit_report(rep)
    if rep["fingerprint"] != fingerprint(frozen):
        raise AssertionError("audit fingerprint differs from the fresh "
                             "numpy build's")
    if rep["soundness"]["violations"]:
        raise AssertionError(f"audit soundness: {rep['soundness']}")
    log(f"phase 9 audit_report(sample=128): {audit_s:.2f} s, fingerprint "
        f"{rep['fingerprint']['combined']} equals the numpy build's, "
        f"soundness {rep['soundness']['violations']} of "
        f"{rep['soundness']['sampled']} wrong, redundancy "
        f"{rep['redundancy']['violations']} of "
        f"{rep['redundancy']['sampled']}, device bytes "
        f"{rep['bytes']['device']} ({card})")

    # 6-7: shadow, snapshot, stats
    svc.drain_shadow()
    sh = svc._shadow.stats()
    if sh["checked"] == 0 or sh["divergent"]:
        raise AssertionError(f"shadow verification: {sh}")
    validate_snapshot(svc.telemetry_snapshot())
    st = validate_stats(svc.stats())
    if st["async"] is None:
        raise AssertionError("stats() lacks the async section")
    log(f"phase 9 shadow: {sh['checked']} checked, {sh['divergent']} "
        f"divergent, {sh['discarded']} discarded at deltas; snapshot and "
        f"stats valid; async {st['async']}")

    # 8: close stops every thread the service started
    threads = [svc._engine._thread, svc.batcher._ticker]
    svc.close()
    alive = [th.name for th in threads if th is not None and th.is_alive()]
    if alive or svc._shadow.running:
        raise AssertionError(f"threads alive after close(): {alive}")
    torch.cuda.synchronize()
    counts = {name: kernels[name].launches
              for name in ("mergejoin", "label_frontier")}
    if not all(counts.values()):
        raise AssertionError(f"a kernel of phase 9 never ran: {counts}")
    return counts


def batch_timer(svc) -> list:
    """Wrap ``svc._run_batch`` so each executed batch appends its host
    seconds to the returned list (the async engine's thread included)."""
    lat, run = [], svc._run_batch

    def timed(batch, tr=None):
        t0 = time.perf_counter()
        out = run(batch, tr)
        lat.append(time.perf_counter() - t0)
        return out

    svc._run_batch = timed
    return lat


def pct(xs, p: float) -> float:
    return float(np.percentile(xs, p)) * 1e3 if len(xs) else 0.0


def run_sharded(torch, card, g, index, queries, want, kernels, rng) -> dict:
    """Phase 10: sharded serving on the card, counted.

    Adopts ``index`` into ``ShardedRLCService`` at 2 and 4 shards x 2
    replicas, all shards' row-windowed layouts on the card: a synchronous
    pass of ``queries``, a ``submit()`` wave from 4 threads, and a wave
    during which a second thread runs ``hot_swap()``; at 4 shards also
    the delta builder's bootstrap and one ``apply_delta`` of 32 inserts
    and 32 deletes, held against a fresh ``numpy`` build of the mutated
    graph (made in a worker process meanwhile). Every answer must equal
    ``want`` (the single-host service's answers, equal to the CSR join);
    no digest join may leave the card, no sub-batch may degrade (the swap
    publishes every shard at once, between batches), the bootstrap and
    the apply must each launch the frontier kernel, and every shard's
    layout must have launched the merge kernel. Then ``transport="rpc"``
    on ``device="cpu"`` (2 shard-host processes, answering from the host)
    serves the stream; its answers must equal the in-process ones and
    ``close()`` must leave no worker alive. Returns the phase's
    merge-join launches by configuration."""
    import multiprocessing
    import threading
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core.minimum_repeat import mr_id_space
    from repro_torch.core.queries import biased_true_queries
    from repro_torch.graphgen import random_delta
    from repro_torch.obs.audit import device_nbytes
    from repro_torch.service import (ShardedRLCService, ShardedServiceConfig,
                                     validate_stats)

    t_phase = time.perf_counter()
    base = dict(k=K, batch_size=32, max_wait_ms=2.0, device="cuda")
    delta = random_delta(g, 32, 32, np.random.default_rng(SEED + 10))
    mutated = g.apply_delta(delta)
    out = {}

    def check(what, svc, answers):
        if [a.value for a in answers] != want:
            raise AssertionError(f"phase 10 {what}: answers differ from the "
                                 f"single-host service and the CSR join")
        computed = {a.backend for a in answers
                    if a.disposition == "computed"}
        if computed - {"cuda", "digest"}:
            raise AssertionError(f"phase 10 {what}: computed answers came "
                                 f"from {computed}")

    def fanout_line(svc):
        ex = svc.fanout.stats()
        local = sum(c for k, c in ex["sub_batches"].items()
                    if k.split("->")[0] == k.split("->")[1])
        remote = sum(ex["sub_batches"].values()) - local
        return (ex, f"sub-batches {local} local / {remote} remote, device "
                    f"digest joins {ex['remote_joins_device']}, numpy digest "
                    f"joins {ex['remote_joins_numpy']}, digest bytes "
                    f"{ex['digest_bytes']}, degraded {ex['degraded']}")

    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        ref = pool.submit(numpy_reference, mutated,
                          mr_id_space(g.num_labels, K))
        for S in (2, 4):
            name = f"{S} shards x 2 replicas"
            for kern in kernels.values():
                kern.launches = 0
            t0 = time.perf_counter()
            svc = ShardedRLCService(g, index, ShardedServiceConfig(
                num_shards=S, num_replicas=2, delta_fallback_frac=1.0,
                **base))
            setup_s = time.perf_counter() - t0
            lat = batch_timer(svc)
            # shard 0's first layout, the shape the passes below serve
            windowed = svc.shards[0].replicas[0].device_index
            for rs in svc.shards:
                d = rs.replicas[0].device_index
                if d.device.type != "cuda" or rs.replicas[1].device_index \
                        is not d:
                    raise AssertionError(f"shard {rs.shard_id}: layout not "
                                         f"shared on the card")
                log(f"phase 10 {name} shard {rs.shard_id}: rows "
                    f"[{rs.lo}, {rs.hi}), E={d.row_len}, "
                    f"{rs.replicas[0].frozen.num_entries()} entries, device "
                    f"bytes {device_nbytes(d)} on {d.device}")
            # 1: the stream, synchronously
            t0 = time.perf_counter()
            answers = svc.query_batch(queries)
            wall = time.perf_counter() - t0
            check(f"{name} query_batch", svc, answers)
            ex, fl = fanout_line(svc)
            log(f"phase 10 {name} query_batch: {len(queries)} queries in "
                f"{wall:.3f} s = {len(queries) / wall:.0f} queries/s; "
                f"{len(lat)} batches, batch latency p50 {pct(lat, 50):.3f} "
                f"ms, p99 {pct(lat, 99):.3f} ms (host clock); {fl}; setup "
                f"(freeze, plan, layouts) {setup_s:.2f} s ({card})")
            # 2: a submit() wave from 4 threads (SLO controller off)
            svc.cache.clear()
            del lat[:]
            svc.start()
            answers, wall, flat = submit_wave(svc, queries)
            check(f"{name} submit", svc, answers)
            ex, fl = fanout_line(svc)
            log(f"phase 10 {name} submit: {len(queries)} submits from 4 "
                f"threads in {wall:.3f} s = {len(queries) / wall:.0f} "
                f"queries/s; future latency p50 {pct(flat, 50):.3f} ms, p99 "
                f"{pct(flat, 99):.3f} ms; {len(lat)} batches, batch latency "
                f"p50 {pct(lat, 50):.3f} ms, p99 {pct(lat, 99):.3f} ms (host "
                f"clock); {fl} ({card})")
            if ex["degraded"] or ex["remote_joins_numpy"]:
                raise AssertionError(f"phase 10 {name}: {fl}")
            # 3: a hot swap from a second thread in the middle of a wave
            svc.cache.clear()
            swap = {}
            before = svc._engine.stats()["submitted"]

            def swapper():
                while svc._engine.stats()["submitted"] - before < \
                        len(queries) // 3:
                    time.sleep(0.001)
                t1 = time.perf_counter()
                swap["generation"] = svc.hot_swap()
                swap["s"] = time.perf_counter() - t1

            th = threading.Thread(target=swapper)
            th.start()
            answers, wall, flat = submit_wave(svc, queries)
            th.join(timeout=300)
            if th.is_alive() or swap.get("generation") != 1:
                raise AssertionError(f"phase 10 {name}: hot swap {swap}")
            check(f"{name} swap wave", svc, answers)
            ex, fl = fanout_line(svc)
            log(f"phase 10 {name} hot_swap during a wave: swap "
                f"{swap['s']:.3f} s (host clock), wave of "
                f"{svc._engine.stats()['submitted'] - before} submits "
                f"{wall:.3f} s; {fl} ({card})")
            if ex["degraded"] or ex["remote_joins_numpy"]:
                raise AssertionError(f"phase 10 {name} swap wave: {fl}")
            # the swapped layouts serve
            svc.cache.clear()
            check(f"{name} after swap", svc, svc.query_batch(queries))
            if S == 4:
                # 4: the delta builder's bootstrap, then one apply, each
                # through the frontier kernel of the cuda delta backend
                frontier = kernels["label_frontier"]
                before = frontier.launches
                t0 = time.perf_counter()
                svc._ensure_delta_builder()
                boot_s = time.perf_counter() - t0
                boot_launches = frontier.launches - before
                before = frontier.launches
                t0 = time.perf_counter()
                summary = svc.apply_delta(delta)
                apply_s = time.perf_counter() - t0
                apply_launches = frontier.launches - before
                if not (boot_launches and apply_launches):
                    raise AssertionError(
                        f"phase 10 delta: frontier launches {boot_launches} "
                        f"(bootstrap), {apply_launches} (apply)")
                ref_entries, ref_counters, frozen, ref_s = ref.result()
                if entry_sets(svc.index) != ref_entries or \
                        svc.build_stats.counters() != ref_counters:
                    raise AssertionError("phase 10 delta: entries or "
                                         "counters differ from a fresh "
                                         "numpy build")
                d = summary["delta"]
                if d["fallback"]:
                    raise AssertionError("delta_fallback_frac=1.0 fell back")
                fresh = biased_true_queries(svc.graph, K, 300, seed=SEED + 10)
                wave = queries + fresh.true_queries + fresh.false_queries
                got = svc.query_batch(wave)
                csr = frozen.query_batch(
                    [q[0] for q in wave], [q[1] for q in wave],
                    [svc.mr_ids[q[2]] for q in wave])
                if [a.value for a in got] != csr.tolist():
                    raise AssertionError("phase 10 delta: answers differ "
                                         "from a fresh numpy build")
                log(f"phase 10 {name} delta: bootstrap (traced cuda build, "
                    f"hot swap onto it) {boot_s:.2f} s, frontier launches "
                    f"{boot_launches}; apply_delta (32 inserts, 32 deletes) "
                    f"{apply_s:.2f} s, frontier launches {apply_launches}, "
                    f"phases re-run "
                    f"{d['phases_rerun']} of {d['phases_total']}, shards "
                    f"touched {summary['shards_touched']}; {len(wave)} "
                    f"answers equal a fresh numpy build ({ref_s:.2f} s in a "
                    f"worker process) ({card})")
            ex, fl = fanout_line(svc)
            if ex["remote_joins_numpy"] or ex["degraded"]:
                raise AssertionError(f"phase 10 {name}: {fl}")
            validate_stats(svc.stats())
            svc.close()
            torch.cuda.synchronize()
            launches = kernels["mergejoin"].launches
            per_shard = [rs.backend_totals().get("cuda", {}).get("batches", 0)
                         for rs in svc.shards]
            if not all(per_shard) or launches != sum(per_shard):
                raise AssertionError(f"phase 10 {name}: merge launches "
                                     f"{launches}, by shard {per_shard}")
            log(f"phase 10 {name}: merge-join launches {launches} (by shard "
                f"{per_shard}), frontier launches "
                f"{kernels['label_frontier'].launches} ({card})")
            out[name] = launches
            del svc

    # a served windowed batch, timed alone (not counted)
    log("phase 10, a served windowed batch (4 shards, shard 0's first "
        "layout):")
    check_mergejoin(torch, windowed, rng, windowed=True, Q=32)

    # 5: the same stream over RPC: 2 shard-host processes, from the host
    t0 = time.perf_counter()
    rpc = ShardedRLCService(g, index, ShardedServiceConfig(
        num_shards=2, num_replicas=1, transport="rpc",
        **dict(base, device="cpu")))
    boot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers = rpc.query_batch(queries)
    wall = time.perf_counter() - t0
    if [a.value for a in answers] != want:
        raise AssertionError("phase 10 rpc: answers differ from in-process")
    st = validate_stats(rpc.stats())
    procs = [h.proc for hs in rpc.cluster.handles.values() for h in hs]
    rpc.close()
    alive = [p.pid for p in procs if p.is_alive()]
    if alive:
        raise AssertionError(f"rpc workers alive after close(): {alive}")
    ex = st["executor"]
    log(f"phase 10 rpc 2 shards x 1 replica: fleet up in {boot_s:.2f} s, "
        f"{len(queries)} queries in {wall:.3f} s = {len(queries) / wall:.0f} "
        f"queries/s (host clock, numpy in the workers), sub-batches "
        f"{ex['sub_batches']}, rpc digest joins {ex['remote_joins_rpc']}, "
        f"digest bytes {ex['digest_bytes']}, wire bytes "
        f"{st['rpc']['wire_bytes']}; equal to in-process; no worker alive "
        f"after close() ({card})")
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s (host clock) "
        f"({card})")
    return out


def entry_sets(idx):
    return tuple(tuple(sorted((v, h, m) for v, d in enumerate(maps)
                              for h, ms in d.items() for m in ms))
                 for maps in (idx.l_out, idx.l_in))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.build import build_rlc_index_with_stats
    from repro_torch.build.cuda_backend import CudaEngine
    from repro_torch.core import dense
    from repro_torch.core.baselines import bibfs_rlc
    from repro_torch.core.device_index import DeviceIndex
    from repro_torch.core.queries import biased_true_queries
    from repro_torch.graphgen import barabasi_albert
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.service import RLCService, ServiceConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card)

    t0 = time.perf_counter()
    logs = _build.build(["mergejoin", "label_frontier", "bool_semiring"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for src, text in logs.items():
        kernel = "?"
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '([^']+)'", line)
            if found:   # the kernel's name and template arguments
                kernel = re.sub(r"_ZN\w+?_cu_\w{8}\d*", "",
                                found.group(1))[:60]
            elif "registers" in line or "spill" in line:
                log(f"  {src} {kernel}: {line.strip()}")
    smem = _build.library("bool_semiring").rlc_semiring_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    log(f"  bool_semiring dynamic shared memory a block: wgmma "
        f"{smem(0, 0)} B, split-K with float32 b {smem(1, 1)} B, with "
        f"bf16 b {smem(1, 0)} B")

    t0 = time.perf_counter()
    g = barabasi_albert(**AD)
    log(f"graph AD: |V|={g.num_vertices} |E|={g.num_edges} "
        f"|L|={g.num_labels} ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    ref_idx, ref_stats = build_rlc_index_with_stats(g, K, backend="numpy")
    log(f"numpy build: {time.perf_counter() - t0:.2f} s, entries "
        f"{ref_idx.num_entries()}, counters {ref_stats.counters()}")

    # -- kernels against their plain versions (not counted) ------------- #
    rng = np.random.default_rng(SEED)
    svc_ref = RLCService(g, ref_idx, ServiceConfig(k=K, device="cuda"))
    d = svc_ref.device_index
    log(f"device index: rows={d.out_hub.shape[0]} E={d.row_len}")
    results = {"mergejoin": check_mergejoin(torch, d, rng, windowed=False)}
    lo, hi = g.num_vertices // 3, 2 * g.num_vertices // 3
    dw = DeviceIndex.from_frozen(svc_ref.frozen.slice_rows(lo, hi),
                                 svc_ref.mr_ids, rows=(lo, hi),
                                 device="cuda")
    check_mergejoin(torch, dw, rng, windowed=True)
    check_mergejoin(torch, d, rng, windowed=False, Q=32)  # a served batch
    engine = CudaEngine(g, device="cuda")
    results["label_frontier"] = check_frontier(torch, engine, rng, R=300,
                                               density=0.01)
    check_frontier(torch, engine, rng, R=150, density=0.01)
    check_frontier(torch, engine, rng, R=15, density=0.05)
    del svc_ref, dw, engine

    # -- the main path, counted ---------------------------------------- #
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    svc = RLCService.build(g, ServiceConfig(k=K, device="cuda"))
    build_s = time.perf_counter() - t0
    st = svc.build_stats
    if st.backend != "cuda":
        raise AssertionError(f"the service built with {st.backend!r}")
    log(f"cuda build (hybrid) + freeze + device transfer: {build_s:.2f} s "
        f"(build {st.wall_time_s:.2f} s), entries "
        f"{svc.index.num_entries()}, counters {st.counters()}, frontier "
        f"launches {KERNELS['label_frontier'].launches}")
    if KERNELS["label_frontier"].launches == 0:
        raise AssertionError("the cuda build launched no frontier kernel")
    if entry_sets(svc.index) != entry_sets(ref_idx):
        raise AssertionError("cuda build entries differ from numpy build")
    if st.counters() != ref_stats.counters():
        raise AssertionError("cuda build counters differ from numpy build")

    t0 = time.perf_counter()
    qs = biased_true_queries(g, K, 2000, seed=SEED)
    queries = list(dict.fromkeys(qs.true_queries + qs.false_queries))
    log(f"queries: {len(queries)} distinct "
        f"({time.perf_counter() - t0:.2f} s to generate)")
    t0 = time.perf_counter()
    answers = svc.query_batch(queries)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = svc.query_batch(queries)
    hit_s = time.perf_counter() - t0
    computed = [a for a in answers if a.disposition == "computed"]
    if {a.backend for a in computed} != {"cuda"}:
        raise AssertionError(f"computed answers came from "
                             f"{ {a.backend for a in computed} }")
    if svc.executor.fallbacks:
        raise AssertionError(f"{svc.executor.fallbacks} batches fell back")
    if any(a.disposition != "cache_hit" for a in again) or again != answers:
        raise AssertionError("the repeated pass was not all cache hits")
    mr_ids = svc.mr_ids
    s = np.array([q[0] for q in queries])
    t = np.array([q[1] for q in queries])
    m = np.array([mr_ids[q[2]] for q in queries])
    csr = svc.frozen.query_batch(s, t, m)
    if [a.value for a in answers] != csr.tolist():
        raise AssertionError("served answers differ from the CSR join")
    sample = rng.choice(len(queries), size=200, replace=False)
    for i in sample.tolist():
        if bibfs_rlc(g, *queries[i]) != answers[i].value:
            raise AssertionError(f"answer {i} differs from the oracle")
    log(f"serve: {len(queries)} queries in {serve_s:.3f} s "
        f"({len(computed)} computed, batch_size {svc.config.batch_size}), "
        f"repeat pass {hit_s:.3f} s all cache hits; "
        f"{sum(a.value for a in answers)} true; equal to the CSR join and "
        f"to BiBFS on 200 samples; merge launches "
        f"{KERNELS['mergejoin'].launches}, fallbacks 0")
    launches = {name: KERNELS[name].launches
                for name in ("mergejoin", "label_frontier")}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    Q = 65_536
    s = rng.integers(0, g.num_vertices, Q)
    t = rng.integers(0, g.num_vertices, Q)
    m = rng.integers(0, len(mr_ids), Q)
    before = KERNELS["mergejoin"].launches
    t0 = time.perf_counter()
    got = svc.device_index.query_batch(s, t, m, use_kernel=True)
    big_s = time.perf_counter() - t0
    if KERNELS["mergejoin"].launches != before + 1:
        raise AssertionError("the large batch did not launch the kernel")
    want = svc.frozen.query_batch(s, t, m)
    if not np.array_equal(got, want):
        raise AssertionError("large batch differs from the CSR join")
    log(f"large batch: Q={Q} through the kernel in {big_s:.4f} s "
        f"(host clock, copies included, 1 merge launch not counted in the "
        f"kernels line), {int(got.sum())} true, equal to the CSR join")

    # -- the dense engine's kernels against their plain versions ------- #
    torch.backends.cuda.matmul.allow_tf32 = False   # the default, stated
    results.update(check_dense_kernels(torch, g, rng))

    # -- the dense path, counted --------------------------------------- #
    t0 = time.perf_counter()
    eng, dense_counts = counted(torch, KERNELS, ("bool_matmul",
                                                 "closure_step"),
                                lambda: dense.DenseEngine.build(g, K, device="cuda"))
    dense_s = time.perf_counter() - t0
    C = len(eng.mrs)
    log(f"DenseEngine.build: {dense_s:.3f} s (host clock, reach copied to "
        f"the host), {C} MRs, {eng.num_true_pairs()} true (c, u, v); "
        f"bool_matmul launches {dense_counts['bool_matmul']}, "
        f"closure_step launches {dense_counts['closure_step']}")
    t0 = time.perf_counter()
    plain_eng = dense.DenseEngine.build(g, K, matmul=dense.bool_matmul,
                                        device="cuda")
    log(f"DenseEngine.build, plain products (torch.matmul + threshold): "
        f"{time.perf_counter() - t0:.3f} s")
    if not np.array_equal(eng.reach, plain_eng.reach):
        raise AssertionError("the kernels' reach differs from the plain "
                             "path's")
    del plain_eng

    def condensed():
        t0 = time.perf_counter()
        idx, _ = dense.build_condensed_device(
            g, K, hub_batch=HUB_BATCH, reach=eng.reach, device="cuda")
        cond_s = time.perf_counter() - t0
        csvc = RLCService(g, idx, ServiceConfig(k=K, device="cuda"))
        # 64 sources x every target x every MR through the merge kernel
        src = np.sort(rng.choice(g.num_vertices, 64, replace=False))
        qs, qt, qc = (a.ravel() for a in np.meshgrid(
            src, np.arange(g.num_vertices), np.arange(C), indexing="ij"))
        got = csvc.device_index.query_batch(qs, qt, qc, use_kernel=True)
        alg2 = svc.device_index.query_batch(qs, qt, qc, use_kernel=True)
        want = eng.reach[qc, qs, qt]
        if not (np.array_equal(got, want) and np.array_equal(alg2, want)):
            raise AssertionError(
                f"condensed index / Algorithm-2 index / reach disagree on "
                f"{int((got != want).sum())} / {int((alg2 != want).sum())} "
                f"of {len(qs)} queries")
        answers_c = csvc.query_batch(queries)
        if {a.backend for a in answers_c
                if a.disposition == "computed"} != {"cuda"} \
                or csvc.executor.fallbacks:
            raise AssertionError("the condensed service left the kernel")
        if [a.value for a in answers_c] != [a.value for a in answers]:
            raise AssertionError("the condensed service's answers differ "
                                 "from the Algorithm-2 service's")
        return idx, csvc, cond_s, (qs, qt, qc), int(want.sum())

    (idx_c, svc_c, cond_s, big_q, n_true), cond_counts = counted(
        torch, KERNELS, ("mergejoin",), condensed)
    log(f"build_condensed_device(hub_batch={HUB_BATCH}): {cond_s:.3f} s "
        f"(host clock), entries {idx_c.num_entries()} (Algorithm-2 index: "
        f"{svc.index.num_entries()}), row length E="
        f"{svc_c.device_index.row_len}; {len(big_q[0])} queries (64 "
        f"sources x all targets x {C} MRs, {n_true} true) through the merge kernel equal "
        f"reach and the Algorithm-2 index; {len(queries)} served queries "
        f"from backend cuda, fallbacks 0, equal to the first service's; "
        f"merge launches {cond_counts['mergejoin']}")
    # those two launches, timed alone (E = 40 and E = 80)
    for di, what in ((svc.device_index, "Algorithm-2 index"),
                     (svc_c.device_index, "condensed index")):
        ms, stream_ms = mergejoin_kernel_ms(torch, di, *big_q, 5)
        b, by = mergejoin_bound(di, *big_q)
        log(f"mergejoin {what} E={di.row_len} Q={len(big_q[0])}: kernel "
            f"{ms:.4f} ms (graph; {stream_ms:.4f} ms launched from Python), "
            f"bound {b:.5f} ms ({by}, {b / ms:.1%} of it "
            f"reached); answers held against reach and the CSR join above")
    del svc_c

    # -- the kernel surface's path, counted ---------------------------- #
    n_src, surface_counts = counted(
        torch, KERNELS, ("frontier_step", "frontier_steps",
                         "bitpack_matmul"),
        lambda: run_surface_path(torch, g, eng, rng))
    log(f"surface BFS: {n_src} sources along (0 1), (0 2), (2 0), (1 2) "
        f"equal reach; launches {surface_counts}")
    launches.update(dense_counts)
    launches.update(surface_counts)

    # -- the whole single-host service, counted ------------------------ #
    t0 = time.perf_counter()
    full_counts = run_full_service(torch, card, g, svc.index, queries,
                                   KERNELS, rng)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s (host clock); "
        f"launches {full_counts} (not in the kernels line)")

    # -- sharded serving, in process and over RPC, counted ------------- #
    sharded_counts = run_sharded(torch, card, g, svc.index, queries,
                                 [a.value for a in answers], KERNELS, rng)
    log(f"phase 10 merge-join launches {sharded_counts} (not in the kernels "
        f"line)")

    csrc = "src/repro_torch/kernels/csrc/"
    meta = {
        "mergejoin": (csrc + "mergejoin.cu",
                      "src/repro/kernels/mergejoin.py:40"),
        "label_frontier": (csrc + "label_frontier.cu",
                           "src/repro/kernels/label_frontier.py:76"),
        "frontier_steps": (csrc + "label_frontier.cu",
                           "src/repro/kernels/label_frontier.py:113"),
        "frontier_step": (csrc + "bool_semiring.cu",
                          "src/repro/kernels/label_frontier.py:45"),
        "bool_matmul": (csrc + "bool_semiring.cu",
                        "src/repro/kernels/bool_semiring.py:57"),
        "closure_step": (csrc + "bool_semiring.cu",
                         "src/repro/kernels/bool_semiring.py:84"),
        "bitpack_matmul": (csrc + "label_frontier.cu",
                           "src/repro/kernels/bitpack.py:64"),
    }
    for name in ("mergejoin", "label_frontier"):
        results[name].setdefault("library_ms", None)
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=meta[name][0],
             replaces=meta[name][1], launches=launches[name],
             **results[name])
        for name in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
