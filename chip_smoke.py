#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every step below
    python3 chip_smoke.py --phase N    # step N alone, N from 10 to 15

``--phase`` runs one phase with what it stands on: steps 1-7 before 10
and 11 (:func:`ad_setup`, with their checks), 13 before 14, the kernel
build before 14 and 15, nothing before 12 and 13. To compare two trees,
run each tree's own script in its own process (parent, change, change,
parent).

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
   plain path's), ``build_condensed_device`` at ``hub_batch = 8`` (two
   ``hub_cover`` launches a hub batch and two ``entry_masks`` launches a
   build, then each kernel held against its plain version, ``hub_cover``
   on one batch over the AD reach and ``entry_masks`` on a stack of the
   AD shape, and timed) and an
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
    from the host), equal to the in-process answers;
11. the parallel build and the distributed dense engine
    (:func:`run_parallel_build`, :func:`run_distributed`):
    ``RLCService.build`` with ``build_backend="parallel"`` (4 host
    workers through the process executor, spawned, not forked, since
    this process holds a CUDA context), whose entries and counters must
    equal step 3's and the ``numpy`` build's, serving step 4's queries
    from the merge kernel; then a 1 x 1 NCCL mesh on ``cuda:0``:
    ``distributed_all_mr_reach`` (one ``bool_matmul`` launch and one
    all-gather a product) equal to step 7's ``reach``,
    ``distributed_build(hub_batch=8)`` equal to step 7's condensed
    index, and ``distributed_query_batch`` on step 7's 3,767,616 queries
    (merge kernel) equal to ``reach`` and, on a sample, the CSR join;
12. the model substrate's serving path (:func:`run_model_serving`):
    ``qwen3-0.6b`` at full width and depth in bf16 serves 8 prompts of
    512 tokens for 64 steps through ``ServeEngine.generate`` (prefill and
    decode timed by CUDA events beside their bounds), held against a
    teacher-forced ``forward``; the same in f32 must be token-exact;
    chunked-attention prefill against dense; every assigned
    architecture's smoke config generates on the card what its forward
    rollout gives. Plain torch ops: no hand-written kernel runs there;
13. the model substrate's training path (:func:`run_model_training`):
    ``qwen3-0.6b`` at full width and depth in bf16 trains 20 steps of
    8 x 512 tokens through ``launch.train.run`` (finite, falling loss;
    steps timed by CUDA events beside 6 x params x tokens at 989 TFLOP/s;
    a profiler window for the busy share; peak memory); its checkpoint
    restores onto the card bit-identical; a 2-layer f32 cut at full
    width: a step on the card equals the host CPU's, microbatches 4
    equal 1; the restart drill (two injected failures, deterministic
    algorithms) ends bit-identical to the uninterrupted run. Plain torch
    ops and autograd: no hand-written kernel;
14. the dry run and the roofline (:func:`run_dry_run`):
    ``python -m repro_torch.launch.dryrun`` on the pod mesh (256 ranks of
    a ``fake`` world, meta tensors) for ``qwen3-0.6b`` x {``train_4k``,
    ``prefill_32k``, ``decode_32k``}, ``rlc-build-64k`` and
    ``rlc-query-1m``, each ``ok``, ``decode_32k`` traced twice with equal
    records; phase 13's step dry-run on a 1 x 1 mesh and held against the
    card (its flops equal ``FlopCounterMode``'s count of a real step, its
    peak within 15 % of ``max_memory_allocated``, its roofline bound at
    most the measured step); ``launch.train.run`` on a 1 x 1 ``data x
    model`` mesh with its state placed as DTensors (the placed path of a
    larger world: ``constrain``, ``local_apply``, the split lookup and
    loss, grads in their parameters' placements): the f32 cut's placed
    step equals its plain step, and 20 bf16 steps stay near phase 13's
    losses;
    the closure cell's bound at n = 6656 at most ``closure_step``'s time
    there;
15. the example twins and cross-layout checkpoints (:func:`run_examples`):
    the seven twins of ``repro_torch.examples`` but ``train_lm`` through
    ``main(device="cuda")`` at the reference scripts' sizes, each making
    its oracle checks and launching at least one kernel of its path
    (the merge join, or ``bool_matmul`` over a 1 x 1 NCCL mesh), then
    each but ``serve_lm`` again on the CPU, where the kernels' plain
    versions run, returning exactly what it returned on the card
    (entries, every answer, delta and pruning counters, plan and
    router); then
    ``train_lm`` at its 100M width (B = 8, S = 256) for 40 steps with a
    checkpoint every 10 and the failure at step 20 (one restart, 40
    effective steps, a falling loss); then a placed ``qwen3-0.6b-smoke``
    state saved and restored into a plain and a placed template,
    resharded to plain leaves and back (bit-identical), and templates
    of another shape and of another dtype refused.

Launch counts are reset to 0 right before steps 3-4, 7, 8, 9, each
configuration of 10, each part of 11, 12, 13, 14 and each twin of 15,
and read right after each;
the ``kernels`` line reports each kernel's count from the path that runs
it. The merge join, the frontier wave,
``frontier_steps`` and ``bitpack_matmul`` take less time on the card
than a launch from Python, so their kernel times are taken from a
captured CUDA graph (:func:`graph_ms`; the time launched from Python is
logged beside it); every bound counts the bytes and operations of this
run's inputs.
Any failure raises and the script exits non-zero; without a CUDA device,
or without the repository beside it, it exits non-zero before printing a
result. The last line is ``{"ok": true, "phase": N, "device": {...}}``
(``phase`` null in the full run, which prints the ``kernels`` line before
it).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np

AD = dict(num_vertices=6541, m_attach=4, num_labels=3,
          seed=zlib.crc32(b"AD") % 2**31)
K = 2
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside tensor cores
TENSOR_OPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
HUB_BATCH = 8                # distributed_build's default in the reference
PHASES = range(10, 16)       # the phases that --phase runs alone
# deterministic cuBLAS for phase 13's restart drill; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


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


def check_hub_cover(torch, eng) -> dict:
    """One hub batch of the condensed build (``HUB_BATCH`` hubs, both
    sides) through ``hub_cover`` against its plain version, over the AD
    reach and random stacks of a build half done, then timed; the bound
    reads both stacks and the hub operands at one bit an entry."""
    from repro_torch.kernels import hub_cover, ref
    C, n, _ = eng.reach.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    R = torch.from_numpy(eng.reach).cuda()
    RT = R.transpose(1, 2).contiguous()
    aid = torch.randperm(n, generator=gen, device="cuda")
    order = torch.argsort(aid)
    OUT, IN = (hub_cover.pack_stack(torch.rand(
        (C, n, n), generator=gen, device="cuda") < 0.002) for _ in range(2))
    at, B = n // 2, HUB_BATCH
    got = [OUT.clone(), IN.clone()]
    hub_cover.hub_batch_step(*got, R, RT, aid, order, at, B)
    want = [OUT.clone(), IN.clone()]
    ref.hub_cover_ref(want[0], want[1], RT, aid, order[at:at + B])
    ref.hub_cover_ref(want[1], want[0], R, aid, order[at:at + B])
    err = max(compare("hub_cover", g, w) for g, w in zip(got, want))

    def plain():
        ref.hub_cover_ref(OUT, IN, RT, aid, order[at:at + B])
        ref.hub_cover_ref(IN, OUT, R, aid, order[at:at + B])
    return timed(
        "hub_cover", err,
        lambda: hub_cover.hub_batch_step(OUT, IN, R, RT, aid, order, at, B),
        plain, None, 2 * C * n * n / 8 + 2 * C * n * B / 8,
        4.0 * C * n * n * B, 2 * TENSOR_OPS_PER_S, 20,
        f"C={C} n={n} B={B}, both sides (two launches)")


def check_entry_masks(torch, eng) -> dict:
    """One packed entry stack of the AD shape (random bits at a built
    stack's density) through ``entry_masks`` against its plain version,
    then timed; the bound reads the stack and writes the masks once."""
    from repro_torch.kernels import hub_cover, ref
    C, n, _ = eng.reach.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    words = hub_cover.pack_stack(torch.rand((C, n, n), generator=gen,
                                            device="cuda") < 0.002)
    got = hub_cover.entry_masks(words)
    if not torch.equal(got, ref.entry_masks_ref(words)):
        raise AssertionError("entry_masks differs from its plain version")
    return timed(
        "entry_masks", 0.0, lambda: hub_cover.entry_masks(words),
        lambda: ref.entry_masks_ref(words), None,
        4 * words.numel() + 8 * got.numel(), 0.0, CUDA_CORE_OPS_PER_S, 20,
        f"C={C} n={n} W={words.shape[-1]}, one stack")


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


def run_parallel_build(torch, card, g, cuda_build, numpy_build, queries,
                       want, kernels) -> dict:
    """Phase 11, part 1: ``RLCService.build`` with the ``parallel``
    backend at AD size, 4 workers through the process executor, then
    serving on the card, counted.

    ``cuda_build`` and ``numpy_build`` are step 3's service and the
    ``numpy`` build's ``(index, stats)``: the parallel build's entries and
    pruning counters must equal both. The build must have run the
    parallel protocol with process workers that were not forked (the
    caller holds a CUDA context), every computed answer to ``queries``
    must come from backend ``cuda`` with no fallback, equal to ``want``
    (step 4's answers), the merge kernel must have launched, and
    ``close()`` must leave no worker process alive. Returns the merge
    launches."""
    import multiprocessing
    import os

    from repro_torch.service import RLCService, ServiceConfig

    # the reference's default width, stated; the start method is left to
    # the backend (spawn once CUDA is up)
    os.environ["RLC_PARALLEL_WORKERS"] = "4"
    if "RLC_PARALLEL_MP_CONTEXT" in os.environ:
        raise AssertionError("RLC_PARALLEL_MP_CONTEXT is set: phase 11 "
                             "checks the backend's own start method")
    before = {p.pid for p in multiprocessing.active_children()}

    def build_and_serve():
        t0 = time.perf_counter()
        psvc = RLCService.build(g, ServiceConfig(
            k=K, device="cuda", build_backend="parallel"))
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        answers = psvc.query_batch(queries)
        torch.cuda.synchronize()
        return psvc, build_s, answers, time.perf_counter() - t0

    (psvc, build_s, answers, serve_s), counts = counted(
        torch, kernels, ("mergejoin",), build_and_serve)
    info, st = psvc.build_info, psvc.build_stats
    ref_idx, ref_stats = numpy_build
    if (info.get("mode"), info.get("executor"), info.get("workers")) != (
            "parallel", "process", 4):
        raise AssertionError(f"phase 11 parallel build ran {info}")
    if info.get("start_method") in (None, "fork"):
        raise AssertionError(f"phase 11 parallel build workers started by "
                             f"{info.get('start_method')!r}")
    got = entry_sets(psvc.index)
    if got != entry_sets(cuda_build.index) or got != entry_sets(ref_idx):
        raise AssertionError("phase 11 parallel build entries differ from "
                             "the cuda / numpy builds")
    if st.counters() != cuda_build.build_stats.counters() \
            or st.counters() != ref_stats.counters():
        raise AssertionError("phase 11 parallel build counters differ from "
                             "the cuda / numpy builds")
    computed = [a for a in answers if a.disposition == "computed"]
    if {a.backend for a in computed} != {"cuda"} or psvc.executor.fallbacks:
        raise AssertionError(
            f"phase 11 parallel-built service served from "
            f"{ {a.backend for a in computed} }, fallbacks "
            f"{psvc.executor.fallbacks}")
    if [a.value for a in answers] != want:
        raise AssertionError("phase 11 parallel-built service answers "
                             "differ from step 4's")
    psvc.close()
    alive = [p.pid for p in multiprocessing.active_children()
             if p.pid not in before]
    if alive:
        raise AssertionError(f"phase 11 build workers alive after close(): "
                             f"{alive}")
    dag = info["dag"]
    log(f"phase 11 parallel build (4 workers, process executor, start "
        f"method {info['start_method']}): {build_s:.2f} s wall for "
        f"RLCService.build (build {st.wall_time_s:.2f} s: schedule "
        f"analysis {info['dag_s']:.2f} s, worker start-up "
        f"{info['startup_s']:.2f} s, epoch loop "
        f"{st.wall_time_s - info['dag_s'] - info['startup_s']:.2f} s), "
        f"makespan {info['makespan_s']:.3f} s, epochs {info['epochs']}, stale "
        f"re-runs {info['stale_reruns']}, worker busy s "
        f"{info['worker_busy_s']}, coordinator serial "
        f"{info['parent_serial_s']:.3f} s; DAG phases {dag['phases']}, "
        f"edges {dag['edges']}, depth {dag['depth']}, serial fraction "
        f"{dag.get('serial_fraction')}"
        f"{', thinned' if info.get('thinned') else ''}; entries "
        f"{psvc.index.num_entries()} and counters equal to the cuda "
        f"and numpy builds ({card})")
    log(f"phase 11 parallel-built service: {len(queries)} queries in "
        f"{serve_s:.3f} s ({len(computed)} computed) from backend cuda, "
        f"fallbacks 0, equal to step 4's answers; merge launches "
        f"{counts['mergejoin']}; no worker alive after close() ({card})")
    return counts


def run_distributed(torch, card, g, reach, condensed, big_q, kernels,
                    rng) -> dict:
    """Phase 11, part 2: the distributed dense engine on a 1 x 1 NCCL
    mesh on ``cuda:0``, counted.

    ``distributed_all_mr_reach`` must equal ``reach`` (phase 7's
    ``DenseEngine.reach``) with one ``bool_matmul`` launch a product (the
    MR chain products and ``C x ceil(log2 n)`` doubling steps);
    ``distributed_build(hub_batch=8)``'s entries must equal
    ``condensed`` (phase 7's condensed index); ``distributed_query_batch``
    over that index on ``big_q`` (phase 7's 3,767,616 queries) must equal
    ``reach`` on every query, and the host CSR join on a sample of
    200,000 (the CSR join is a Python loop, ~30 us a query). The process
    group is destroyed at the end, also on a failure. Returns the
    launches of both kernels."""
    import math

    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.core.device_index import DeviceIndex
    from repro_torch.core.minimum_repeat import enumerate_mrs, mr_id_space

    t0 = time.perf_counter()
    mesh = tdist.make_rlc_mesh(device="cuda")
    mesh_s = time.perf_counter() - t0
    try:
        log(f"phase 11 mesh: {mesh} over {dist.get_backend()} in "
            f"{mesh_s:.2f} s")
        mm = tdist.shmap_bool_matmul(mesh)

        def reach_run():
            t0 = time.perf_counter()
            R = tdist.distributed_all_mr_reach(g, K, mesh, matmul=mm)
            return R, time.perf_counter() - t0

        (R, reach_s), counts = counted(torch, kernels, ("bool_matmul",),
                                       reach_run)
        mrs = enumerate_mrs(g.num_labels, K)
        n = g.num_vertices
        products = sum(len(mr) - 1 for mr in mrs) + len(mrs) * max(
            1, math.ceil(math.log2(max(n, 2))))
        if not np.array_equal(R, reach):
            raise AssertionError("phase 11 distributed reach differs from "
                                 "DenseEngine.reach")
        if counts["bool_matmul"] != products or mm.all_gathers != products + 1:
            raise AssertionError(
                f"phase 11 distributed reach: {counts['bool_matmul']} "
                f"bool_matmul launches and {mm.all_gathers} all-gathers, "
                f"{products} products expected")
        log(f"phase 11 distributed_all_mr_reach (1 x 1 NCCL mesh): "
            f"{reach_s:.3f} s (host clock, reach copied to the host), equal "
            f"to DenseEngine.reach; bool_matmul launches "
            f"{counts['bool_matmul']}, all-gathers {mm.all_gathers} "
            f"({mm.gathered_bytes / 1e9:.3f} GB gathered) ({card})")

        t0 = time.perf_counter()
        idx, _ = tdist.distributed_build(g, K, mesh, hub_batch=HUB_BATCH)
        build_s = time.perf_counter() - t0
        if entry_sets(idx) != entry_sets(condensed):
            raise AssertionError("phase 11 distributed_build entries differ "
                                 "from phase 7's condensed index")
        log(f"phase 11 distributed_build(hub_batch={HUB_BATCH}): "
            f"{build_s:.3f} s (host clock, reach included), entries "
            f"{idx.num_entries()} equal to phase 7's condensed index "
            f"({card})")

        dev = DeviceIndex.from_index(idx, g.num_labels, device="cuda")
        qs, qt, qc = big_q

        def query_run():
            t0 = time.perf_counter()
            got = tdist.distributed_query_batch(dev, qs, qt, qc, mesh)
            return got, time.perf_counter() - t0

        (got, query_s), qcounts = counted(torch, kernels, ("mergejoin",),
                                          query_run)
        counts.update(qcounts)
        if not np.array_equal(got, reach[qc, qs, qt]):
            raise AssertionError(
                f"phase 11 distributed_query_batch differs from reach on "
                f"{int((got != reach[qc, qs, qt]).sum())} of {len(qs)}")
        sample = rng.choice(len(qs), 200_000, replace=False)
        t0 = time.perf_counter()
        csr = idx.freeze(mr_id_space(g.num_labels, K)).query_batch(
            qs[sample], qt[sample], qc[sample])
        csr_s = time.perf_counter() - t0
        if not np.array_equal(got[sample], csr):
            raise AssertionError("phase 11 distributed_query_batch differs "
                                 "from the CSR join")
        log(f"phase 11 distributed_query_batch: {len(qs)} queries in "
            f"{query_s:.3f} s (host clock, copies and the all-gather "
            f"included), {int(got.sum())} true, equal to reach on all and "
            f"to the CSR join on 200,000 sampled ({csr_s:.1f} s on the "
            f"host); merge launches {qcounts['mergejoin']} ({card})")
    finally:
        dist.destroy_process_group()
    return counts


# -- phase 12: the model substrate's serving path ---------------------- #
SERVE_ARCH = "qwen3-0.6b"
SERVE_B, SERVE_S0, SERVE_STEPS, SERVE_MAX_LEN = 8, 512, 64, 640
F32_B, F32_STEPS = 2, 16
ARGMAX_SHARE = 0.99        # bf16 decode vs teacher-forced forward, at least
ATTN_CHUNK = 128
CHUNK_BOUND = 1e-2         # max |dlogit|, chunked vs dense f32 prefill


def greedy_check(torch, what, cfg, params, prompts, steps):
    """``ServeEngine.generate`` on the card, each prefill and decode call
    timed by CUDA events and its logits kept, then one teacher-forced
    ``forward`` over prompt + generated tokens. Returns the figures."""
    from repro_torch.models import forward
    from repro_torch.serve import ServeEngine

    class Recorder(ServeEngine):
        """The engine as a user calls it; only its two step functions are
        wrapped."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.calls = []

        def _timed(self, fn, *args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.calls.append((start, end, out[0]))
            return out

        def prefill(self, *args):
            return self._timed(super().prefill, *args)

        def decode(self, *args):
            return self._timed(super().decode, *args)

    B, S0 = prompts.shape
    engine = Recorder(cfg, params, SERVE_MAX_LEN, B, device="cuda")
    engine.generate(prompts, 2)                       # warm-up
    torch.cuda.synchronize()
    engine.calls = []
    t0 = time.perf_counter()
    out = engine.generate(prompts, steps)
    wall_s = time.perf_counter() - t0
    ms = [s.elapsed_time(e) for s, e, _ in engine.calls]
    step_logits = torch.cat([lg[:, -1:, :cfg.vocab_size]
                             for _, _, lg in engine.calls], dim=1)
    engine.calls = []
    if out.shape != (B, steps):
        raise AssertionError(f"phase 12 {what}: generate gave {out.shape}")
    if not np.array_equal(step_logits.argmax(-1).cpu().numpy(), out):
        raise AssertionError(f"phase 12 {what}: tokens are not the argmax "
                             "of the step logits")
    seq = torch.as_tensor(np.concatenate([prompts, out[:, :-1]], axis=1),
                          device="cuda")
    with torch.no_grad():
        full, _ = forward(params, cfg, seq)
    ref = full[:, S0 - 1:, :cfg.vocab_size].float()
    got = step_logits.float()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"phase 12 {what}: logits not finite")
    delta = float((got - ref).abs().max())
    agree = got.argmax(-1) == ref.argmax(-1)
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    unexplained = int((~agree & (margin >= 2 * delta)).sum())
    del full, ref, got, step_logits
    return dict(out=out, wall_s=wall_s, prefill_ms=ms[0], decode_ms=ms[1:],
                delta=delta, share=float(agree.float().mean()),
                disagree=int((~agree).sum()), unexplained=unexplained,
                min_margin=float(margin.min()))


def device_profile(torch, run, top: int = 0):
    """(kernel launches, device-busy ms) of ``run()`` from a
    ``torch.profiler`` trace: the CUDA kernels it recorded, their time
    summed (one stream, so no overlap). ``(0, None)`` when the trace holds
    no device kernel. With ``top``, a third item: the ``top`` kernel names
    by summed device ms, as (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3
            if kernels else None)
    if not top:
        return len(kernels), busy
    by_name = {}
    for e in kernels:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return len(kernels), busy, [(k, ms, c) for k, (ms, c) in ranked]


def run_model_serving(torch, card) -> dict:
    """Phase 12: the model substrate's serving path on the card.

    ``qwen3-0.6b`` at full width and depth in bf16 (a seeded
    ``torch.Generator`` on ``cuda:0``) serves B = 8 prompts of 512 tokens
    for 64 greedy steps through ``ServeEngine.generate``; each decode
    step's logits are held against a teacher-forced ``forward`` (argmax
    agreement at least 99 %, every disagreement where the forward's
    top-1/top-2 margin is below twice the max |dlogit|). The same in f32
    (TF32 off) at B = 2 and 16 steps must be token-exact; chunked
    attention (``attn_chunk=128``) prefill must stay within
    ``CHUNK_BOUND`` of the dense prefill; and every assigned
    architecture's smoke config must generate on the card, in f32, what
    its own forward rollout gives. Raises on any failed check; returns
    the figures it logs."""
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.models import (count_params, decode_step, forward,
                                    init_cache, init_model, param_bytes,
                                    prefill)
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params, _ = init_model(cfg, torch.Generator("cuda").manual_seed(SEED),
                           device="cuda")
    torch.cuda.synchronize()
    n, nbytes = count_params(params), param_bytes(params)
    if n != 596_180_992:
        raise AssertionError(f"phase 12: {SERVE_ARCH} has {n} parameters")
    log(f"phase 12 {SERVE_ARCH}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
        f"head_dim {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} padded to {cfg.padded_vocab}, {cfg.param_dtype}"
        f"; {n} parameters, {nbytes} bytes, init "
        f"{time.perf_counter() - t0:.2f} s, allocated "
        f"{torch.cuda.max_memory_allocated() - base} bytes over the phase's "
        f"start ({base} before it)")

    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (SERVE_B, SERVE_S0)).astype(np.int32)
    r = greedy_check(torch, "bf16", cfg, params, prompts, SERVE_STEPS)
    peak = torch.cuda.max_memory_allocated() - base
    B, S0, K, dh, L = (SERVE_B, SERVE_S0, cfg.num_kv_heads, cfg.head_dim_,
                       cfg.num_layers)
    prefill_bound = 2 * n * B * S0 / TENSOR_OPS_PER_S * 1e3
    kv = [2 * L * B * (S0 + i + 1) * K * dh * 2
          for i in range(SERVE_STEPS - 1)]
    decode_bound = [(nbytes + b) / HBM_BYTES_PER_S * 1e3 for b in kv]
    dec = np.array(r["decode_ms"])
    p50, p99 = float(np.percentile(dec, 50)), float(np.percentile(dec, 99))
    share = float(np.median(np.array(decode_bound) / dec))
    log(f"phase 12 generate bf16 (B={B}, S0={S0}, {SERVE_STEPS} steps, "
        f"max_len {SERVE_MAX_LEN}): {r['wall_s']:.3f} s host clock; prefill "
        f"{r['prefill_ms']:.3f} ms (CUDA events), bound "
        f"{prefill_bound:.3f} ms (2 x params x B x S0 at 989 TFLOP/s), "
        f"{prefill_bound / r['prefill_ms']:.1%} of it; decode p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms a step, bound "
        f"{decode_bound[0]:.4f}-{decode_bound[-1]:.4f} ms (params + KV at "
        f"the step's length at 3.35 TB/s), median share {share:.1%}; "
        f"decode {B * len(dec) / dec.sum() * 1e3:.1f} tokens/s; peak "
        f"{peak} bytes over the phase's start ({card})")
    # where a step's time goes: kernels and device-busy time from a trace
    toks = torch.as_tensor(prompts, device="cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        cache, _ = init_cache(cfg, B, SERVE_MAX_LEN, device="cuda")
        n_pre, busy_pre = device_profile(
            torch, lambda: prefill(params, cfg, toks, cache))
        tok = toks[:, -1:]

        def four_steps():
            for i in range(4):
                decode_step(params, cfg, cache, tok, S0 + i)
        n_dec, busy_dec = device_profile(torch, four_steps)
    del cache
    if busy_pre is None or busy_dec is None:
        log("phase 12 profile: the trace holds no device kernel; device "
            "busy time not measured")
    else:
        log(f"phase 12 profile (torch.profiler, one prefill and 4 decode "
            f"steps): prefill {n_pre} kernels, {busy_pre:.3f} ms device "
            f"busy ({busy_pre / r['prefill_ms']:.1%} of its "
            f"{r['prefill_ms']:.3f} ms above); a decode step "
            f"{n_dec / 4:.0f} kernels, "
            f"{busy_dec / 4:.3f} ms device busy, {busy_dec / 4 / p50:.1%} of "
            f"the p50 step above (idle share {1 - busy_dec / 4 / p50:.1%}); "
            f"the traced window took {time.perf_counter() - t0:.2f} s")
    if r["share"] < ARGMAX_SHARE or r["unexplained"]:
        raise AssertionError(f"phase 12 bf16: argmax agreement "
                             f"{r['share']:.4f}, {r['unexplained']} "
                             f"disagreements not at a small margin")
    log(f"phase 12 check bf16: max |dlogit| decode vs teacher-forced "
        f"forward {r['delta']:.4f}; argmax agrees at {r['share']:.2%} of "
        f"{B * SERVE_STEPS} positions; {r['disagree']} disagreements, each "
        f"where the forward's top-1/top-2 margin is below 2 x max |dlogit| "
        f"({r['unexplained']} elsewhere); smallest margin "
        f"{r['min_margin']:.4f}")

    # -- f32, TF32 off: token-exact ------------------------------------ #
    del params
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params32, _ = init_model(cfg32,
                             torch.Generator("cuda").manual_seed(SEED),
                             device="cuda")
    r32 = greedy_check(torch, "f32", cfg32, params32, prompts[:F32_B],
                       F32_STEPS)
    if r32["share"] != 1.0:
        raise AssertionError(f"phase 12 f32: {r32['disagree']} generated "
                             "tokens differ from the teacher-forced argmax")
    dec32 = np.array(r32["decode_ms"])
    log(f"phase 12 check f32 (TF32 off, B={F32_B}, {F32_STEPS} steps): "
        f"every token equals the teacher-forced argmax; max |dlogit| "
        f"{r32['delta']:.6f}, smallest margin {r32['min_margin']:.4f}; "
        f"prefill {r32['prefill_ms']:.3f} ms, decode p50 "
        f"{np.percentile(dec32, 50):.3f} ms a step")

    # -- chunked attention prefill against dense ------------------------ #
    toks = torch.as_tensor(prompts[:F32_B], device="cuda")
    with torch.no_grad():
        outs = []
        for c in (cfg32, cfg32.replace(attn_chunk=ATTN_CHUNK)):
            cache, _ = init_cache(c, F32_B, SERVE_MAX_LEN, device="cuda")
            outs.append(prefill(params32, c, toks, cache)[0].float())
            del cache
    dchunk = float((outs[0] - outs[1]).abs().max())
    if not dchunk <= CHUNK_BOUND:
        raise AssertionError(f"phase 12 chunked prefill: max |dlogit| "
                             f"{dchunk} over {CHUNK_BOUND}")
    log(f"phase 12 chunked attention (attn_chunk={ATTN_CHUNK}, cache "
        f"{SERVE_MAX_LEN}, f32, B={F32_B}, S0={S0}): max |dlogit| vs dense "
        f"prefill {dchunk:.6f} (bound {CHUNK_BOUND}; logits up to "
        f"{float(outs[0][..., :cfg.vocab_size].abs().max()):.1f})")
    del params32, outs

    # -- every block kind: the smoke configs on the card ---------------- #
    smoke_ms = {}
    for arch in ASSIGNED:
        c = get_config(arch + "-smoke")
        t0 = time.perf_counter()
        p, _ = init_model(c, torch.Generator("cuda").manual_seed(SEED),
                          device="cuda")
        toks = rng.integers(0, c.vocab_size, (2, 8)).astype(np.int32)
        fe = (rng.normal(size=(2, c.frontend_len, c.frontend_dim)).astype(
            np.float32) if c.frontend != "none" else None)
        n_prefix = (c.frontend_len if c.frontend != "none"
                    and not c.encoder_layers else 0)
        got = ServeEngine(c, p, 8 + n_prefix + 6, 2,
                          device="cuda").generate(toks, 6, fe)
        seq = torch.as_tensor(toks, device="cuda").long()
        tfe = None if fe is None else torch.as_tensor(fe, device="cuda")
        with torch.no_grad():
            for _ in range(6):
                logits, _ = forward(p, c, seq, tfe)
                seq = torch.cat([seq, logits[:, -1:, :c.vocab_size].argmax(
                    -1)], dim=1)
        if not np.array_equal(got, seq[:, 8:].cpu().numpy()):
            raise AssertionError(f"phase 12 {c.name}: generate differs from "
                                 "its forward rollout")
        smoke_ms[c.name] = (time.perf_counter() - t0) * 1e3
    log(f"phase 12 smoke configs (f32, B=2, S0=8, 6 steps) each equal to "
        f"its forward rollout on the card; ms each with init and rollout: "
        + ", ".join(f"{k} {v:.0f}" for k, v in smoke_ms.items()))
    wall = time.perf_counter() - t_phase
    log(f"phase 12: {wall:.1f} s (host clock) ({card})")
    return dict(prefill_ms=r["prefill_ms"], decode_p50_ms=p50,
                decode_p99_ms=p99, peak_bytes=peak, wall_s=wall)


# -- phase 13: the model substrate's training path --------------------- #
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 20
CUT_LAYERS = 2                   # the f32 checks' cut of TRAIN_ARCH
CUT_B, CUT_S, MB_B = 2, 128, 8
CUT_LR, CUT_EPS = 1e-2, 1e-3     # see run_model_training
CUT_RTOL, CUT_ATOL = 1e-5, 1e-6  # card step vs host step, params
MB_RTOL, MB_ATOL = 2e-4, 2e-5    # microbatches 4 vs 1 (the reference's)
DRILL_ARCH = "qwen3-0.6b-smoke"


def _leaves(state):
    from repro_torch.models.builder import tree_flatten
    return list(tree_flatten(state))


def _copy_state(state, device):
    """A copy of a train state on ``device``."""
    from repro_torch.models.builder import tree_unflatten
    return tree_unflatten(state, [x.detach().to(device, copy=True)
                                  for _, x in _leaves(state)])


def _f32_cut(cfg):
    """``cfg`` cut to ``CUT_LAYERS`` layers in float32, and its float32
    optimizer (lr ``CUT_LR``, eps ``CUT_EPS``)."""
    from repro_torch.configs.base import dense_pattern
    from repro_torch.train import OptConfig
    cut = cfg.replace(param_dtype="float32", compute_dtype="float32",
                      num_layers=CUT_LAYERS,
                      block_pattern=dense_pattern(CUT_LAYERS))
    return cut, OptConfig(lr=CUT_LR, warmup_steps=0, eps=CUT_EPS,
                          m_dtype="float32", v_dtype="float32",
                          grad_dtype="float32")


def _param_diff(torch, a, b, what=None, rtol=0.0, atol=0.0) -> float:
    """Largest |a - b| over two train states' parameters; with ``what``,
    raises unless every leaf is within ``rtol`` / ``atol``."""
    from repro_torch.models.builder import tree_leaves
    want = dict(tree_leaves(b.params))
    worst = 0.0
    for path, x in tree_leaves(a.params):
        x, y = (t.detach() for t in (x, want[path]))
        x, y = (getattr(t, "full_tensor", lambda t=t: t)().cpu()
                for t in (x, y))
        d = float((x.float() - y.float()).abs().max())
        worst = max(worst, d)
        if what and not torch.allclose(x, y, rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: {'/'.join(path)} "
                                 f"differs by up to {d} (rtol {rtol}, "
                                 f"atol {atol})")
    return worst


def run_model_training(torch, card) -> dict:
    """Phase 13: the model substrate's training path on the card.

    ``qwen3-0.6b`` at full width and depth in bf16 trains for 20 steps
    at B = 8, S = 512 through ``launch.train.run`` (``remat="full"``,
    bf16 moments and gradients, a seeded init on the card): every loss and
    grad norm finite and the last loss below the first; each step timed
    by CUDA events (the factory ``run`` calls is wrapped), beside its
    bound 6 x params x tokens at 989 TFLOP/s; two more steps under a
    ``torch.profiler`` window give the device-busy share. A
    ``CheckpointManager.save_async`` of the trained state (free space
    checked first) restores onto the card bit-identical. Then a 2-layer
    cut at full width and vocabulary in f32 (TF32 off): one
    ``make_train_step`` step on the card equals the same step on the host
    CPU (the comparison's host leg, named so), and ``microbatches=4``
    equals 1 on the card; those steps use lr 1e-2 and eps 1e-3, so that
    an update is a smooth function of its gradient (with eps 1e-8 a
    gradient near 1e-8 maps to any update in (-lr, lr)). Last, the
    restart drill: ``run`` on the smoke config with failures injected at
    steps 5 and 9 under ``torch.use_deterministic_algorithms(True)``
    must restart twice and end bit-identical to the uninterrupted run.
    Raises on any failed check; returns the figures it logs."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import train as launch_train
    from repro_torch.models import count_params
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.train_loop import init_train_state

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)

    # -- full width, bf16, through launch.train.run, each step timed ---- #
    calls = []
    factory = launch_train.make_train_step

    def timed_factory(*args, **kw):
        step = factory(*args, **kw)

        def timed(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch)
            end.record()
            calls.append((start, end, out[1]["grad_norm"]))
            return out
        return timed

    launch_train.make_train_step = timed_factory
    try:
        t0 = time.perf_counter()
        state, history, _ = launch_train.run(
            TRAIN_ARCH, TRAIN_STEPS, TRAIN_B, TRAIN_S, log_every=10,
            device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        launch_train.make_train_step = factory
    peak = torch.cuda.max_memory_allocated() - base
    n = count_params(state.params)
    if n != 596_180_992:
        raise AssertionError(f"phase 13: {TRAIN_ARCH} has {n} parameters")
    ms = [s.elapsed_time(e) for s, e, _ in calls]
    gnorms = [float(g) for _, _, g in calls]
    if len(history) != TRAIN_STEPS or len(ms) != TRAIN_STEPS:
        raise AssertionError(f"phase 13: {len(history)} losses, {len(ms)} "
                             f"timed steps")
    if not (np.isfinite(history).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"phase 13: losses {history}, grad norms "
                             f"{gnorms}")
    if not history[-1] < history[0]:
        raise AssertionError(f"phase 13: loss did not fall: {history}")
    tokens = TRAIN_B * TRAIN_S
    steady = np.array(ms[1:])
    p50, p99 = float(np.percentile(steady, 50)), float(
        np.percentile(steady, 99))
    bound = 6 * n * tokens / TENSOR_OPS_PER_S * 1e3
    log(f"phase 13 {TRAIN_ARCH} train bf16 (launch.train.run, B={TRAIN_B}, "
        f"S={TRAIN_S}, {TRAIN_STEPS} steps, remat {cfg.remat}, bf16 "
        f"moments and grads): {run_s:.2f} s host clock with init; loss "
        f"{history[0]:.4f} -> {history[-1]:.4f}, grad norm "
        f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}; step 1 {ms[0]:.3f} ms, "
        f"steps 2-{TRAIN_STEPS} p50 {p50:.3f} ms, p99 {p99:.3f} ms (CUDA "
        f"events), {tokens / p50 * 1e3:.0f} tokens/s; bound {bound:.3f} ms "
        f"(6 x {n} params x {tokens} tokens at 989 TFLOP/s), "
        f"{bound / p50:.1%} of it; peak {peak} bytes over the phase's start "
        f"({card})")
    log(f"phase 13 losses: {' '.join(f'{x:.4f}' for x in history)}")

    # two more steps under the profiler: kernels and device-busy time
    low = "bfloat16"
    oc = OptConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 5),
                   total_steps=TRAIN_STEPS, m_dtype=low, v_dtype=low,
                   grad_dtype=low)
    data = SyntheticLMData(cfg, DataConfig(TRAIN_S, TRAIN_B))
    step = make_train_step(cfg, oc)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                data.batch_at(TRAIN_STEPS + i).items()} for i in range(2)]

    def two_steps():
        for b in batches:
            step(state, b)
    t0 = time.perf_counter()
    n_k, busy, ranked = device_profile(torch, two_steps, top=8)
    if busy is None:
        log("phase 13 profile: the trace holds no device kernel; device "
            "busy time not measured")
    else:
        log(f"phase 13 profile (torch.profiler, 2 steps): {n_k / 2:.0f} "
            f"kernels a step, {busy / 2:.3f} ms device busy a step, "
            f"{busy / 2 / p50:.1%} of the p50 step above (idle share "
            f"{1 - busy / 2 / p50:.1%}); the traced window took "
            f"{time.perf_counter() - t0:.2f} s")
        for name, ms, count in ranked:
            log(f"  phase 13 kernel {ms / 2:8.3f} ms a step "
                f"({ms / busy:.1%} of busy), {count / 2:.0f} launches: "
                f"{name[:110]}")

    # -- the full-width checkpoint, restored onto the card ------------- #
    root = Path(__file__).resolve().parent / ".phase13_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    try:
        leaves = _leaves(state)
        nbytes = sum(x.numel() * x.element_size() for _, x in leaves)
        free = shutil.disk_usage(root).free
        if free < 2 * nbytes:
            raise AssertionError(f"phase 13 checkpoint: {free} bytes free "
                                 f"under {root}, the state takes {nbytes}")
        mgr = CheckpointManager(str(root / "full"))
        at = int(state.step)
        t0 = time.perf_counter()
        mgr.save_async(at, state, extra={"step": at})
        snap_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_step, restored, extra = mgr.restore_latest(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if got_step != at or extra != {"step": at}:
            raise AssertionError(f"phase 13 checkpoint: restored step "
                                 f"{got_step}, extra {extra}")
        for (path, a), (_, b) in zip(leaves, _leaves(restored)):
            if not (b.is_cuda and a.dtype == b.dtype and torch.equal(a, b)):
                raise AssertionError(f"phase 13 checkpoint: {path} differs "
                                     f"after restore")
        log(f"phase 13 checkpoint of the trained state ({len(leaves)} "
            f"leaves, {nbytes} bytes, step {at}): save_async returned in "
            f"{snap_s:.2f} s (host copy), written in {save_s:.2f} s, "
            f"restore_latest onto the card {restore_s:.2f} s, every leaf "
            f"bit-identical ({free} bytes were free)")
        del restored, leaves
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state, batches, step
    torch.cuda.empty_cache()

    # -- the f32 cut at full width: card step = host step; microbatches - #
    cut, oc32 = _f32_cut(cfg)
    init, _ = init_train_state(cut, oc32,
                               torch.Generator("cuda").manual_seed(SEED),
                               device="cuda")
    host = _copy_state(init, "cpu")
    card_state = _copy_state(init, "cuda")
    batch = SyntheticLMData(cut, DataConfig(CUT_S, CUT_B)).batch_at(0)
    t0 = time.perf_counter()
    card_state, m_card = make_train_step(cut, oc32)(card_state, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, m_host = make_train_step(cut, oc32)(host, batch)   # host CPU leg
    host_s = time.perf_counter() - t0
    for key in ("loss", "grad_norm"):
        a, b = float(m_card[key]), float(m_host[key])
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"phase 13 f32 cut: {key} on the card "
                                 f"{a}, on the host {b}")
    dcard = _param_diff(torch, card_state, host,
                        "phase 13 f32 cut, card vs host",
                        CUT_RTOL, CUT_ATOL)
    moved = _param_diff(torch, host, init)
    log(f"phase 13 f32 cut ({CUT_LAYERS} of {cfg.num_layers} layers, "
        f"d_model {cut.d_model}, vocab {cut.padded_vocab}, "
        f"{count_params(host.params)} params, TF32 off, B={CUT_B}, "
        f"S={CUT_S}, lr {CUT_LR}, eps {CUT_EPS}): one step on the card "
        f"({card_s:.2f} s host clock, first call) equals the step on the "
        f"host CPU ({host_s:.2f} s): loss {float(m_card['loss']):.6f} vs "
        f"{float(m_host['loss']):.6f}, grad norm "
        f"{float(m_card['grad_norm']):.6f} vs "
        f"{float(m_host['grad_norm']):.6f}, params max |d| {dcard:.3e} "
        f"(rtol {CUT_RTOL}, atol {CUT_ATOL}; the step moved them by up to "
        f"{moved:.3e})")
    del host, card_state
    mb_batch = SyntheticLMData(cut, DataConfig(CUT_S, MB_B)).batch_at(1)
    out = {}
    for mb in (1, 4):
        out[mb], _ = make_train_step(cut, oc32, microbatches=mb)(
            _copy_state(init, "cuda"), mb_batch)
    dmb = _param_diff(torch, out[4], out[1],
                      "phase 13 microbatches 4 vs 1",
                      MB_RTOL, MB_ATOL)
    log(f"phase 13 microbatches=4 vs 1 on the card (the f32 cut, "
        f"B={MB_B}): params max |d| {dmb:.3e} (rtol {MB_RTOL}, atol "
        f"{MB_ATOL})")
    del out, init
    torch.cuda.empty_cache()

    # -- the restart drill, deterministic ------------------------------ #
    drill = Path(__file__).resolve().parent / ".phase13_drill"
    shutil.rmtree(drill, ignore_errors=True)
    kw = dict(steps=12, batch=2, seq=32, ckpt_every=4, log_every=1000,
              device="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        s_ref, _, rep_ref = launch_train.run(DRILL_ARCH,
                                             ckpt_dir=str(drill / "ref"),
                                             **kw)
        s_inj, _, rep = launch_train.run(
            DRILL_ARCH, ckpt_dir=str(drill / "inj"),
            fail_at={5: RuntimeError("injected at step 5"),
                     9: RuntimeError("injected at step 9")}, **kw)
        drill_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(drill, ignore_errors=True)
    if rep.restarts != 2 or rep_ref.restarts != 0:
        raise AssertionError(f"phase 13 drill: {rep.restarts} restarts "
                             f"({rep_ref.restarts} uninterrupted)")
    for (path, a), (_, b) in zip(_leaves(s_ref),
                                 _leaves(s_inj)):
        if not (a.is_cuda and torch.equal(a, b)):
            raise AssertionError(f"phase 13 drill: {path} differs from "
                                 f"the uninterrupted run")
    log(f"phase 13 restart drill ({DRILL_ARCH}, 12 steps, checkpoints "
        f"every 4, failures injected at steps 5 and 9, deterministic "
        f"algorithms on): {rep.restarts} restarts, {rep.steps_run} steps "
        f"run, every leaf bit-identical to the uninterrupted run; both "
        f"runs {drill_s:.2f} s host clock")
    wall = time.perf_counter() - t_phase
    log(f"phase 13: {wall:.1f} s (host clock) ({card})")
    return dict(step_p50_ms=p50, step_p99_ms=p99, peak_bytes=peak,
                busy_ms=None if busy is None else busy / 2, wall_s=wall,
                history=history)


# -- phase 14: the dry run and the roofline ----------------------------- #
DRY_CELLS = (("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
             ("qwen3-0.6b", "decode_32k"), ("rlc-build-64k", "paper"),
             ("rlc-query-1m", "paper"),
             ("qwen3-0.6b", "decode_32k"))   # again: the record repeats
PEAK_TOL = 0.15          # predicted vs measured peak bytes of one step
LOSS_RTOL = 2e-3         # the measured (plain) run vs phase 13's losses
# The placed bf16 run vs phase 13: the placed path runs other ops (the
# vocabulary-split loss, DTensor's decompositions), which may round
# differently; bf16 gradients and moments compound such differences over
# 20 steps (6.6e-3 relative at step 20 on the H100, the first three
# losses equal). The math itself is held to CUT_RTOL / CUT_ATOL by the
# f32 placed step (bit-identical on the H100).
PLACED_RTOL = 2e-2
CLOSURE_N = 6656         # the dense engine's padded n (phase 6)


def run_dry_run(torch, card, trained, kernels) -> dict:
    """Phase 14: the dry run (``launch/dryrun.py``) and the roofline on
    the card's host, held against the card.

    1. ``python -m repro_torch.launch.dryrun`` traces ``qwen3-0.6b`` x
       {``train_4k``, ``prefill_32k``, ``decode_32k``}, ``rlc-build-64k``
       and ``rlc-query-1m`` on the pod mesh (256 ranks of a ``fake``
       world, meta tensors), one process a cell, all started together;
       each must end ``ok``; logs its per-device flops, peak bytes,
       collective bytes by kind, dominant term and trace seconds.
       ``decode_32k`` is traced twice, in processes of different hash
       seeds, and the two records must be equal but for the trace time.
    2. Phase 13's own step (``qwen3-0.6b``, B = 8, S = 512, bf16, its
       remat) dry-run on a 1 x 1 mesh, then run for real through
       ``launch.train.run`` with one step counted by
       ``FlopCounterMode`` and its peak read by
       ``torch.cuda.max_memory_allocated``: the dry run's flops must
       equal the count, its peak be within 15 % of the measured one, its
       roofline bound at most the measured step time (CUDA events, p50).
       Then ``launch.train.run`` again on a ``data x model`` mesh of
       1 x 1 with the state placed as DTensors (``dtensor=True``), so
       the step takes the placed path of a larger world: first the
       2-layer f32 cut's step, placed and plain from one state, within
       ``CUT_RTOL`` / ``CUT_ATOL``; then phase 13's 20 bf16 steps, whose
       losses stay within ``PLACED_RTOL`` of phase 13's (the measured
       run's within ``LOSS_RTOL``).
    3. The ``rlc-build-64k`` closure cell at n = 6656 on a 1 x 1 mesh:
       its roofline bound at most the ``closure_step`` kernel's time at
       that n on the card, bf16 and float32 (launches not counted).
    Raises on any failed check."""
    import shutil
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import (PARAM_RULES, place_tree,
                                                tree_shardings)
    from repro_torch.train import make_train_step
    from repro_torch.train.train_loop import init_train_state

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out_dir = root / ".phase14_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod", "--microbatches", "1",
             "--out", str(out_dir / str(i))],
            env=dict(env, PYTHONHASHSEED=str(i)), cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, (arch, shape) in enumerate(DRY_CELLS)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        sweep_s = time.perf_counter() - t0
        failed, records = [], {}
        for i, ((arch, shape), p, text) in enumerate(
                zip(DRY_CELLS, procs, outs)):
            tag = f"{arch}__{shape}__pod"
            path = out_dir / str(i) / f"{tag}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            if p.returncode != 0 or rec.get("status") != "ok":
                failed.append(f"{tag}: exit {p.returncode}, "
                              f"{rec.get('error')}\n"
                              f"{rec.get('traceback', text)[-1500:]}")
                continue
            rec_t = dict(rec, compile_seconds=None)
            if tag in records:
                if records[tag] != rec_t:
                    failed.append(f"{tag}: a second trace gave another "
                                  f"record:\n{records[tag]}\n{rec_t}")
                else:
                    log(f"phase 14 dry run {tag} traced again (hash seed "
                        f"{i}): the same record, trace "
                        f"{rec['compile_seconds']} s")
                continue
            records[tag] = rec_t
            coll = {k: v for k, v in rec["collectives"].items()
                    if not k.startswith("raw_")}
            r = rec["roofline"]
            log(f"phase 14 dry run {tag} (256 fake ranks): "
                f"{rec['cost']['flops_per_dev']:.4e} flops/dev, "
                f"{rec['cost']['bytes_per_dev']:.4e} bytes/dev, peak "
                f"{rec['memory']['peak_bytes_per_dev']} bytes/dev, "
                f"collective bytes/dev {coll}, dominant {r['dominant']} "
                f"(compute {r['compute_s']:.4e} s, memory "
                f"{r['memory_s']:.4e} s, collective "
                f"{r['collective_s']:.4e} s), traced in "
                f"{rec['compile_seconds']} s"
                + (f", useful flops {rec['useful_flops_ratio']:.3f}"
                   if "useful_flops_ratio" in rec else ""))
        if failed:
            raise AssertionError("phase 14 dry runs failed:\n"
                                 + "\n".join(failed))
        log(f"phase 14 dry runs: {len(DRY_CELLS)} traces of "
            f"{len(records)} cells in {sweep_s:.1f} s (host clock, "
            f"processes in parallel)")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # -- phase 13's step: dry run on 1 x 1, then the card --------------- #
    cfg = get_config(TRAIN_ARCH)
    cell = ShapeCell("phase13", "train", TRAIN_S, TRAIN_B)
    with dryrun.fake_world(1):
        rec = dryrun.lower_cell(TRAIN_ARCH, cell,
                                make_host_mesh(device="cuda"),
                                remat=cfg.remat)
        closure = dryrun.lower_rlc_cell("rlc-build-64k",
                                        make_host_mesh(device="cuda"),
                                        num_vertices=CLOSURE_N)
    calls, measured = [], {}
    factory = launch_train.make_train_step

    def measuring_factory(*args, **kw):
        step = factory(*args, **kw)

        def wrapped(state, batch):
            if len(calls) == 2:        # the third step: counted and peaked
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with FlopCounterMode(display=False) as fc:
                    out = step(state, batch)
                torch.cuda.synchronize()
                measured.update(flops=fc.get_total_flops(),
                                peak=torch.cuda.max_memory_allocated())
                calls.append(None)
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch)
            end.record()
            calls.append((start, end))
            return out
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    launch_train.make_train_step = measuring_factory
    try:
        t0 = time.perf_counter()
        state, history, _ = launch_train.run(
            TRAIN_ARCH, TRAIN_STEPS, TRAIN_B, TRAIN_S, log_every=1000,
            device="cuda")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        launch_train.make_train_step = factory
    del state
    torch.cuda.empty_cache()
    ms = np.array([s.elapsed_time(e) for s, e in
                   (c for c in calls[1:] if c is not None)])
    p50 = float(np.percentile(ms, 50))
    want_h = np.array(trained["history"])
    if not np.allclose(np.array(history), want_h, rtol=LOSS_RTOL, atol=0):
        raise AssertionError(f"phase 14: the measured run's losses "
                             f"{history} vs phase 13's {trained['history']}")

    # -- the placed path on a 1 x 1 mesh: every leaf a DTensor ---------- #
    # the f32 cut's step, placed and plain, from one state: the same math
    cut, oc32 = _f32_cut(cfg)
    init, axes = init_train_state(cut, oc32,
                                  torch.Generator("cuda").manual_seed(SEED),
                                  device="cuda")
    batch = SyntheticLMData(cut, DataConfig(CUT_S, CUT_B)).batch_at(0)
    plain, m_plain = make_train_step(cut, oc32)(_copy_state(init, "cuda"),
                                                batch)
    mesh = make_host_mesh(device="cuda")
    try:
        placed = place_tree(_copy_state(init, "cuda"), tree_shardings(
            init, axes, mesh, PARAM_RULES), dtensor=True)
        placed, m_placed = make_train_step(cut, oc32, mesh=mesh)(placed,
                                                                 batch)
        torch.cuda.synchronize()
        if not all(isinstance(x, DTensor) for _, x in _leaves(placed)):
            raise AssertionError("phase 14: the placed f32 step's state is "
                                 "not DTensors")
        for key in ("loss", "grad_norm"):
            a, b = float(m_placed[key]), float(m_plain[key])
            if not abs(a - b) <= CUT_RTOL * abs(b):
                raise AssertionError(f"phase 14 placed f32 step: {key} "
                                     f"{a}, plain {b}")
        dplaced = _param_diff(torch, placed, plain,
                              "phase 14 f32 cut, placed vs plain",
                              CUT_RTOL, CUT_ATOL)
    finally:
        dist.destroy_process_group()
    log(f"phase 14 placed f32 step on the card (the f32 cut of phase 13, "
        f"B={CUT_B}, S={CUT_S}, every leaf a DTensor on a 1 x 1 mesh) vs "
        f"the plain step from the same state: loss "
        f"{float(m_placed['loss']):.6f} vs {float(m_plain['loss']):.6f}, "
        f"grad norm {float(m_placed['grad_norm']):.6f} vs "
        f"{float(m_plain['grad_norm']):.6f}, params max |d| "
        f"{dplaced:.3e} (rtol {CUT_RTOL}, atol {CUT_ATOL})")
    del init, plain, placed
    torch.cuda.empty_cache()

    # launch.train.run placed, bf16, phase 13's 20 steps
    t0 = time.perf_counter()
    state, placed_h, _ = launch_train.run(
        TRAIN_ARCH, TRAIN_STEPS, TRAIN_B, TRAIN_S, log_every=1000,
        device="cuda", dtensor=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    leaves = [x for _, x in _leaves(state)]
    if not all(isinstance(x, DTensor) and x.to_local().is_cuda
               for x in leaves):
        raise AssertionError("phase 14: the placed run's state is not "
                             "DTensors on the card")
    n_leaves = len(leaves)
    del state, leaves
    torch.cuda.empty_cache()
    got_h = np.array(placed_h)
    if got_h.shape != want_h.shape or not np.allclose(
            got_h, want_h, rtol=PLACED_RTOL, atol=0):
        raise AssertionError(f"phase 14: placed losses {placed_h} vs phase "
                             f"13's {trained['history']}")
    dloss = float(np.abs(got_h / want_h - 1).max())
    flops = rec["cost"]["flops_per_dev"]
    if flops != measured["flops"]:
        raise AssertionError(f"phase 14: dry-run flops {flops} vs "
                             f"FlopCounterMode on the card "
                             f"{measured['flops']}")
    pred = rec["memory"]["peak_bytes_per_dev"]
    peak = measured["peak"] - base
    if abs(pred - peak) > PEAK_TOL * peak:
        raise AssertionError(f"phase 14: predicted peak {pred} bytes vs "
                             f"measured {peak} (tolerance {PEAK_TOL:.0%})")
    r = rec["roofline"]
    bound_ms = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
    if bound_ms > p50:
        raise AssertionError(f"phase 14: roofline bound {bound_ms:.3f} ms "
                             f"above the measured step {p50:.3f} ms")
    log(f"phase 14 {TRAIN_ARCH} step (B={TRAIN_B}, S={TRAIN_S}, bf16, remat "
        f"{cfg.remat}) on a 1 x 1 mesh: dry run {flops:.6e} flops = "
        f"FlopCounterMode on the card {measured['flops']:.6e}; predicted "
        f"peak {pred} bytes vs measured {peak} "
        f"({pred / peak - 1:+.2%}; args "
        f"{rec['memory']['argument_bytes_per_dev']}, traced "
        f"{rec['memory']['temp_bytes_per_dev'] + rec['memory']['output_bytes_per_dev']}"
        f"); roofline bound {bound_ms:.3f} ms ({r['dominant']}: compute "
        f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} "
        f"ms) vs measured p50 {p50:.3f} ms over {len(ms)} steps (CUDA "
        f"events), {bound_ms / p50:.1%} of it; traced in "
        f"{rec['compile_seconds']} s ({card})")
    log(f"phase 14 launch.train.run on a 1 x 1 data x model mesh, "
        f"{n_leaves} state leaves DTensors on the card (the placed "
        f"path, bf16): {TRAIN_STEPS} losses within rtol {PLACED_RTOL} of "
        f"phase 13's (largest relative gap {dloss:.3e}, "
        f"{'bit-identical' if dloss == 0 else 'not bit-identical'}; "
        f"losses {' '.join(f'{x:.4f}' for x in placed_h)}); "
        f"{run_s:.2f} s host clock with init (the plain run above "
        f"{plain_s:.2f} s, one step of it under FlopCounterMode)")

    log(f"phase 14 launches of the nine kernels before the closure "
        f"timing: {sum(k.launches for k in kernels.values())} (the dry run "
        f"traces plain tensor code; the training path is plain torch ops)")

    # -- the closure cell at n = 6656 against the kernel --------------- #
    g = torch.Generator("cuda").manual_seed(SEED)
    M = (torch.rand((CLOSURE_N, CLOSURE_N), generator=g, device="cuda")
         < 0.01).float()
    Mb, out = M.to(torch.bfloat16), torch.empty_like(M)
    outb = torch.empty_like(Mb)
    kernel_bf16 = cuda_ms(lambda: ops.closure_step(Mb, out=outb), 10)
    kernel_f32 = cuda_ms(lambda: ops.closure_step(M, out=out), 10)
    rc = closure["roofline"]
    c_bound = max(rc["compute_s"], rc["memory_s"], rc["collective_s"]) * 1e3
    if c_bound > min(kernel_bf16, kernel_f32):
        raise AssertionError(f"phase 14: closure cell bound {c_bound:.4f} "
                             f"ms above the kernel ({kernel_bf16:.4f} ms "
                             f"bf16, {kernel_f32:.4f} ms f32)")
    log(f"phase 14 rlc-build-64k closure cell at n={CLOSURE_N} on a 1 x 1 "
        f"mesh: {closure['cost']['flops_per_dev']:.4e} flops, "
        f"{closure['cost']['bytes_per_dev']:.4e} bytes (plain version), "
        f"bound {c_bound:.4f} ms ({rc['dominant']}); closure_step kernel "
        f"{kernel_bf16:.4f} ms bf16, {kernel_f32:.4f} ms f32 (CUDA events, "
        f"not counted) ({card})")
    del M, Mb, out, outb
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"phase 14: {wall:.1f} s (host clock) ({card})")
    return dict(step_p50_ms=p50, wall_s=wall)


# -- phase 15: the eight example twins and cross-layout checkpoints ------ #
# the kernels on each twin's path; the hybrid build sends a hub's waves
# to the frontier kernel only above GATHER_THRESHOLD of two-hop work,
# which no hub of these 250-300-vertex graphs reaches, so a twin must
# launch at least one of its kernels, not each
EXAMPLE_KERNELS = {
    "online_service": ("label_frontier", "mergejoin"),
    "quickstart": (),
    "fraud_detection": ("mergejoin",),
    "delta_updates": ("label_frontier", "mergejoin"),
    "sharded_service": ("label_frontier", "mergejoin"),
    "distributed_index": ("bool_matmul", "mergejoin"),
    "serve_lm": (),
}
# each twin but serve_lm runs again on the CPU, where the kernels' plain
# versions run: its returned dict (entries, every answer, delta and
# pruning counters, plan and router) must equal the card's but for the
# answering backend's name. serve_lm's bf16 tokens follow each device's
# arithmetic; phase 12 holds the model
PLAIN_RERUN = [n for n in EXAMPLE_KERNELS if n != "serve_lm"]
DEVICE_KEYS = {"backends"}
TRAIN_LM = dict(steps=40, batch=8, seq=256, ckpt_every=10)
C9_ARCH = "qwen3-0.6b-smoke"


def _same_bits(torch, what, want, got, dtensor: bool) -> None:
    """Every leaf of ``got`` equal, bit for bit, to ``want``'s (full
    values), a DTensor where ``dtensor`` says, else a plain tensor on
    the card."""
    from torch.distributed.tensor import DTensor
    for (path, a), (_, b) in zip(_leaves(want), _leaves(got)):
        if isinstance(b, DTensor) != dtensor or not b.is_cuda:
            raise AssertionError(f"phase 15 {what}: {path} is "
                                 f"{type(b).__name__} on {b.device}")
        full = lambda x: x.full_tensor() if isinstance(x, DTensor) else x  # noqa: E731
        a, b = full(a), full(b)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"phase 15 {what}: {path} differs")


def run_cross_layout(torch, card) -> None:
    """C9 on one card: a placed ``qwen3-0.6b-smoke`` train state (every
    leaf a DTensor of a 1 x 1 NCCL mesh) saved, restored into a plain
    template and into a placed one; ``ElasticMeshManager.reshard`` to
    plain leaves and back; a template of another shape or dtype must
    raise."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import init_world
    from repro_torch.ft import ElasticMeshManager
    from repro_torch.sharding.partition import (PARAM_RULES, place_tree,
                                                tree_shardings)
    from repro_torch.train import OptConfig
    from repro_torch.train.train_loop import init_train_state
    import torch.distributed as dist

    t0 = time.perf_counter()
    started = init_world("cuda")
    root = tempfile.TemporaryDirectory()
    try:
        cfg = get_config(C9_ARCH)
        low = "float32" if cfg.param_dtype == "float32" else "bfloat16"
        oc = OptConfig(m_dtype=low, v_dtype=low, grad_dtype=low)

        def fresh(seed):
            return init_train_state(cfg, oc, torch.Generator(
                "cuda").manual_seed(seed), device="cuda")

        em = ElasticMeshManager(model_parallel=1, device="cuda")
        mesh = em.build()
        state, axes = fresh(SEED)
        sh = tree_shardings(state, axes, mesh, PARAM_RULES)
        placed = place_tree(state, sh, dtensor=True)
        _same_bits(torch, "placement", state, placed, dtensor=True)
        d = root.name
        CheckpointManager(d).save(3, placed, extra={"step": 3})
        plain_t, _ = fresh(SEED + 1)
        got, extra = restore_pytree(d, 3, plain_t)
        if extra != {"step": 3}:
            raise AssertionError(f"phase 15 restore: extra {extra}")
        _same_bits(torch, "restore into a plain template", state, got,
                   dtensor=False)
        placed_t = place_tree(fresh(SEED + 1)[0], sh, dtensor=True)
        got, _ = restore_pytree(d, 3, placed_t)
        _same_bits(torch, "restore into a placed template", state, got,
                   dtensor=True)
        plain = em.reshard(placed, sh)
        _same_bits(torch, "reshard to plain leaves", state, plain,
                   dtensor=False)
        back = em.reshard(plain, sh, dtensor=True)
        _same_bits(torch, "reshard back to DTensors", state, back,
                   dtensor=True)
        embed = plain_t.params["embed"]
        refused = []
        for what, leaf in (("shape", torch.zeros(3, 5, device="cuda")),
                           ("dtype", embed.to(torch.float64))):
            wrong = dict(plain_t.params, embed=leaf)
            try:
                restore_pytree(d, 3, type(plain_t)(wrong, plain_t.opt,
                                                   plain_t.step))
            except ValueError as e:
                refused.append(str(e))
            else:
                raise AssertionError(f"phase 15: a template of another "
                                     f"{what} was restored")
            if "embed" not in refused[-1] or what not in refused[-1]:
                raise AssertionError(f"phase 15: the refusal names no key "
                                     f"or {what}: {refused[-1]}")
        n = len(_leaves(state))
        log(f"phase 15 cross-layout checks ({C9_ARCH}, {n} leaves, 1 x 1 "
            f"{dist.get_backend()} mesh): a placed state saved, restored "
            f"into a plain and into a placed template, resharded to plain "
            f"leaves and back, every leaf bit-identical; templates of "
            f"another shape and of another dtype refused ({refused}); "
            f"{time.perf_counter() - t0:.2f} s (host clock)")
    finally:
        root.cleanup()
        if started:
            dist.destroy_process_group()


def run_examples(torch, card, kernels) -> dict:
    """Phase 15: the eight example twins (``repro_torch.examples``) on
    the card through their ``main(device="cuda")``, each at the
    reference's own size but ``train_lm``: its 100M width (B = 8, S =
    256) for 40 steps, a checkpoint every 10 and the failure at step 20
    (one restart, a falling loss, 40 effective steps). Each twin's launch
    counts start at 0; a twin whose path names kernels must launch at
    least one of them. Each twin of ``PLAIN_RERUN`` then runs on the CPU,
    where the plain versions run, and must return what it returned on the
    card. Then the cross-layout checks of :func:`run_cross_layout`. Logs
    each twin's wall time and launches; returns the launches by twin."""
    import contextlib
    import importlib
    import io
    t_phase = time.perf_counter()
    launches = {}
    for name, want in EXAMPLE_KERNELS.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        for kern in kernels.values():
            kern.launches = 0
        log(f"phase 15 {name}: the twin's report follows")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            got = mod.main(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: kern.launches for k, kern in kernels.items()
                  if kern.launches}
        launches[name] = counts
        if want and not any(counts.get(k) for k in want):
            raise AssertionError(f"phase 15 {name}: none of {want} "
                                 f"launched: {counts}")
        log(f"phase 15 {name}: {wall:.2f} s (host clock), launches "
            f"{counts or 'none'} (path names {list(want) or 'none'}) "
            f"({card})")
        if name in PLAIN_RERUN:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                plain = mod.main(device="cpu")
            keys = sorted((got.keys() | plain.keys()) - DEVICE_KEYS)
            diff = [k for k in keys if got.get(k) != plain.get(k)]
            if diff:
                raise AssertionError(
                    f"phase 15 {name}: the card's {diff} differ from the "
                    f"CPU's: " + "; ".join(f"{k} {got.get(k)} vs "
                                           f"{plain.get(k)}" for k in diff))
            log(f"phase 15 {name}: equal to its run on the CPU (plain "
                f"versions) in {keys}, {time.perf_counter() - t0:.2f} s")

    from repro_torch.examples import train_lm
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        got = train_lm.main(device="cuda", **TRAIN_LM)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    history = got.pop("history")
    if got["restarts"] != 1 or got["steps_run"] != TRAIN_LM["steps"] \
            or len(history) != TRAIN_LM["steps"] + 1:
        raise AssertionError(f"phase 15 train_lm: {got}, {len(history)} "
                             f"losses")
    if not np.all(np.isfinite(history)) or history[-1] >= history[0]:
        raise AssertionError(f"phase 15 train_lm: losses {history}")
    launches["train_lm"] = {k: kern.launches for k, kern in kernels.items()
                            if kern.launches}
    log(f"phase 15 train_lm ({got['params']} parameters, f32, B="
        f"{TRAIN_LM['batch']}, S={TRAIN_LM['seq']}, {TRAIN_LM['steps']} "
        f"steps, a checkpoint every {TRAIN_LM['ckpt_every']}, failure at "
        f"step {TRAIN_LM['steps'] // 2}): {wall:.2f} s (host clock), "
        f"restarts {got['restarts']}, effective steps {got['steps_run']}, "
        f"loss {history[0]:.4f} -> {history[-1]:.4f}, stragglers "
        f"{got['stragglers']}, launches {launches['train_lm'] or 'none'} "
        f"({card})")
    log(f"phase 15 train_lm losses: "
        f"{' '.join(f'{x:.4f}' for x in history)}")
    run_cross_layout(torch, card)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s (host clock) "
        f"({card})")
    return launches


def build_kernels() -> None:
    """Step 1: every kernel source built, one ``nvcc`` each, all started
    together; each kernel's registers and spills logged."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(["mergejoin", "label_frontier", "bool_semiring",
                         "hub_cover"])
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


def ad_setup(torch) -> SimpleNamespace:
    """Steps 2-7 at AD size, each with its checks: the graph and its
    ``numpy`` build, the kernels against their plain versions, the
    service's ``cuda`` build and its answers, the dense engine's reach and
    the condensed index. Returns what steps 8-11 read (the seeded
    generator too, as these steps left it), and the rows and launch
    counts of the kernels line."""
    from repro_torch.build import build_rlc_index_with_stats
    from repro_torch.build.cuda_backend import CudaEngine
    from repro_torch.core import dense
    from repro_torch.core.baselines import bibfs_rlc
    from repro_torch.core.device_index import DeviceIndex
    from repro_torch.core.queries import biased_true_queries
    from repro_torch.graphgen import barabasi_albert
    from repro_torch.kernels import KERNELS
    from repro_torch.service import RLCService, ServiceConfig

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
        torch, KERNELS, ("mergejoin", "hub_cover", "entry_masks"),
        condensed)
    if cond_counts["hub_cover"] != 2 * -(-g.num_vertices // HUB_BATCH) \
            or cond_counts["entry_masks"] != 2:
        raise AssertionError(f"launches {cond_counts}: not two hub_cover "
                             "a hub batch and two entry_masks a build")
    for name in ("hub_cover", "entry_masks"):
        launches[name] = cond_counts[name]
    results["hub_cover"] = check_hub_cover(torch, eng)
    results["entry_masks"] = check_entry_masks(torch, eng)
    log(f"build_condensed_device(hub_batch={HUB_BATCH}): {cond_s:.3f} s "
        f"(host clock), entries {idx_c.num_entries()} (Algorithm-2 index: "
        f"{svc.index.num_entries()}), row length E="
        f"{svc_c.device_index.row_len}; {len(big_q[0])} queries (64 "
        f"sources x all targets x {C} MRs, {n_true} true) through the merge kernel equal "
        f"reach and the Algorithm-2 index; {len(queries)} served queries "
        f"from backend cuda, fallbacks 0, equal to the first service's; "
        f"merge launches {cond_counts['mergejoin']}, hub_cover launches "
        f"{cond_counts['hub_cover']}, entry_masks launches "
        f"{cond_counts['entry_masks']}")
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

    launches.update(dense_counts)
    return SimpleNamespace(
        g=g, numpy_build=(ref_idx, ref_stats), svc=svc, queries=queries,
        want=[a.value for a in answers], eng=eng, condensed=idx_c,
        big_q=big_q, rng=rng, results=results, launches=launches)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", type=int, choices=PHASES,
                        help="run this phase alone (with 13 before 14, "
                             "and steps 1-7 before 10 and 11)")
    phase = parser.parse_args(argv).phase
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import KERNELS

    def runs(p: int) -> bool:
        return phase in (None, p)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card)
    if phase not in (12, 13):
        build_kernels()
    if phase in (None, 10, 11):
        ad = ad_setup(torch)
        rng = ad.rng

    if phase is None:
        # -- the kernel surface's path, counted ------------------------ #
        n_src, surface_counts = counted(
            torch, KERNELS, ("frontier_step", "frontier_steps",
                             "bitpack_matmul"),
            lambda: run_surface_path(torch, ad.g, ad.eng, rng))
        log(f"surface BFS: {n_src} sources along (0 1), (0 2), (2 0), "
            f"(1 2) equal reach; launches {surface_counts}")
        ad.launches.update(surface_counts)

        # -- the whole single-host service, counted -------------------- #
        t0 = time.perf_counter()
        full_counts = run_full_service(torch, card, ad.g, ad.svc.index,
                                       ad.queries, KERNELS, rng)
        log(f"phase 9: {time.perf_counter() - t0:.1f} s (host clock); "
            f"launches {full_counts} (not in the kernels line)")

    if runs(10):
        # -- sharded serving, in process and over RPC, counted --------- #
        sharded_counts = run_sharded(torch, card, ad.g, ad.svc.index,
                                     ad.queries, ad.want, KERNELS, rng)
        log(f"phase 10 merge-join launches {sharded_counts} (not in the "
            f"kernels line)")

    if runs(11):
        # -- the parallel build and the distributed dense engine ------- #
        t0 = time.perf_counter()
        par_counts = run_parallel_build(torch, card, ad.g, ad.svc,
                                        ad.numpy_build, ad.queries, ad.want,
                                        KERNELS)
        dist_counts = run_distributed(torch, card, ad.g, ad.eng.reach,
                                      ad.condensed, ad.big_q, KERNELS, rng)
        log(f"phase 11: {time.perf_counter() - t0:.1f} s (host clock); "
            f"launches: parallel-built service {par_counts}, distributed "
            f"{dist_counts} (not in the kernels line) ({card})")

    if runs(12):
        # -- the model substrate's serving path ------------------------ #
        for kern in KERNELS.values():
            kern.launches = 0
        run_model_serving(torch, card)
        torch.cuda.synchronize()
        log(f"phase 12 launches of the nine kernels: "
            f"{sum(k.launches for k in KERNELS.values())} (the model path "
            f"has no hand-written kernel: plain torch ops)")

    if phase in (None, 13, 14):
        # -- the model substrate's training path ----------------------- #
        for kern in KERNELS.values():
            kern.launches = 0
        trained = run_model_training(torch, card)
        torch.cuda.synchronize()
        log(f"phase 13 launches of the nine kernels: "
            f"{sum(k.launches for k in KERNELS.values())} (the training "
            f"path has no hand-written kernel: plain torch ops and "
            f"autograd)")

    if runs(14):
        # -- the dry run and the roofline, held against the card ------- #
        for kern in KERNELS.values():
            kern.launches = 0
        run_dry_run(torch, card, trained, KERNELS)

    if runs(15):
        # -- the example twins and cross-layout checkpoints ------------ #
        run_examples(torch, card, KERNELS)

    if phase is None:
        results, launches = ad.results, ad.launches
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
            "hub_cover": (csrc + "hub_cover.cu", None),
            "entry_masks": (csrc + "hub_cover.cu", None),
        }
        for name in ("mergejoin", "label_frontier"):
            results[name].setdefault("library_ms", None)
        log(json.dumps({"kernels": [
            dict(name=name, route="cuda", source=meta[name][0],
                 replaces=meta[name][1], launches=launches[name],
                 **results[name])
            for name in KERNELS]}))
    log(json.dumps({"ok": True, "phase": phase, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
