#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once at the published size of the paper's
Advogato graph (AD: 6,541 vertices, 3 labels, k = 2) through the entry
points a user calls:

1. builds the two CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, and times both with CUDA events;
3. ``RLCService.build`` on the card with the default build backend, which
   there is the ``cuda`` one (frontier kernel); its entries and pruning
   counters must equal the ``numpy`` build's;
4. ``RLCService.query_batch`` on ~4k distinct queries plus a repeated
   pass: every computed answer must come from the ``cuda`` backend (merge
   kernel), with no fallback, equal to the host CSR join and, on a
   sample, to the BiBFS oracle;
5. one ``DeviceIndex.query_batch`` of 65,536 queries through the kernel,
   compared in full with the CSR join.

Launch counts are reset to 0 right before steps 3-4 and read right after
step 4; the ``kernels`` line reports those counts.
Any failure raises and the script exits non-zero; without a CUDA device,
or without the repository beside it, it exits non-zero before printing a
result. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_mergejoin(torch, dev_index, rng, windowed: bool) -> dict:
    """Merge-join kernel vs its plain version at Q = 65,536 queries."""
    from repro_torch.kernels import mergejoin, ref

    d = dev_index
    n, E = d.out_hub.shape
    Q = 65_536
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
    out = torch.empty(Q, dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in (d.out_hub, d.out_mr, d.in_hub, d.in_mr,
                                   ts, tt, tm, out)]
    kernel = lambda: mergejoin.KERNEL(  # noqa: E731
        *ptrs, Q, E, lo, lo, stream)
    ms = cuda_ms(kernel, 50)
    plain_ms = cuda_ms(plain, 5)
    # bytes: the ids and answers, plus each stored row a query touches
    rows = len(np.unique(s)) + len(np.unique(t))
    nbytes = 3 * 4 * Q + Q + rows * E * 4 * 2
    # operations: 2E Case-2 compares per query, E compares per out entry
    # carrying the queried MR
    om, oh = d.out_mr.cpu().numpy(), d.out_hub.cpu().numpy()
    match = ((om[s - lo] == mr[:, None]) & (oh[s - lo] != -1)).sum()
    ops = 2 * E * Q + int(match) * E
    b, by = bound_ms(nbytes, ops)
    log(f"mergejoin windowed={windowed} rows={n} E={E} Q={Q}: max abs err "
        f"{err}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b:.5f} ms ({by})")
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
    stream = torch.cuda.current_stream().cuda_stream
    kernel = lambda: label_frontier.KERNEL(  # noqa: E731
        tF.data_ptr(), A.data_ptr(), tl.data_ptr(), out.data_ptr(), R, Vp,
        W, stream)
    ms = cuda_ms(kernel, 50)
    plain_ms = cuda_ms(plain, 3)
    # bytes: F, labels and the output once, plus the packed adjacency
    # row of every distinct (label, frontier vertex) pair
    nz_r, nz_u = np.nonzero(F)
    pairs = len(np.unique(labels[nz_r].astype(np.int64) * Vp + nz_u))
    nbytes = F.nbytes + labels.nbytes + R * W * 4 + pairs * W * 4
    ops = len(nz_r) * W + R * Vp   # word ORs + frontier compares
    b, by = bound_ms(nbytes, ops)
    log(f"frontier R={R} Vp={Vp} |L|={nl} nnz={len(nz_r)}: max abs err "
        f"{err}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b:.5f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by)


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
    logs = _build.build(["mergejoin", "label_frontier"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

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
    engine = CudaEngine(g, device="cuda")
    results["label_frontier"] = check_frontier(torch, engine, rng, R=300,
                                               density=0.01)
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
    launches = {name: kern.launches for name, kern in KERNELS.items()}
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

    meta = {
        "mergejoin": ("src/repro_torch/kernels/csrc/mergejoin.cu",
                      "src/repro/kernels/mergejoin.py:40"),
        "label_frontier": ("src/repro_torch/kernels/csrc/label_frontier.cu",
                           "src/repro/kernels/label_frontier.py:76"),
    }
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=meta[name][0],
             replaces=meta[name][1], launches=launches[name],
             library_ms=None, **results[name])
        for name in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
