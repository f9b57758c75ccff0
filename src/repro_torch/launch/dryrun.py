"""Multi-pod dry run (``repro.launch.dryrun``): trace every (architecture x
input shape x mesh) cell as one rank of a 256- or 512-rank world, with
nothing allocated, and record memory / cost / collective analyses for the
roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh pod            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR

How a cell is traced: a world of 256 (``pod``) or 512 (``multipod``)
ranks starts on torch's ``fake`` process-group backend (every collective
returns at once), ``make_production_mesh`` lays the reference's mesh over
it, and the cell's step runs ONCE as rank 0: the train step (forward,
backward, AdamW), ``prefill`` or ``decode_step``, with parameters,
optimizer state, caches and inputs placed as ``PARAM_RULES`` /
``ACT_RULES`` say (DTensors over the mesh; plain tensors on a one-rank
mesh). Every local shard is a ``meta`` tensor: shapes and dtypes, no
storage and no card. (``FakeTensorMode`` would do the same, but under
it DTensor's planner for strided splits — two split dimensions merged by
a matmul's reshape — makes a tensor and reads it back, which a fake mode
refuses as data-dependent.)
:class:`~repro_torch.roofline.trace_tools.StepTrace` records what rank 0
runs: per-device flops and bytes from its local shards, the collectives
DTensor issues, and the live bytes over the step. The port sets no
``XLA_FLAGS`` and compiles nothing: ``compile_seconds`` holds the trace
time.

Cells also cover the paper's own workloads (``--arch rlc-build-64k`` /
``rlc-query-1m`` / ``rlc-query-1m-sorted``): one log-doubling closure
step ``R | (R @ R > 0)`` on a row-sharded bf16 matrix and the batched
query join (plain and sorted-key) on replicated rows, as plain tensor
code — not the CUDA kernels, as the reference lowers plain array code
and not its Pallas kernels.

Record keys are the reference's, except where they have no meaning
here: ``memory.alias_bytes_per_dev`` (the state is updated in place and
counted once, as an argument) and ``cost.xla_flops_per_dev`` /
``cost.xla_bytes_per_dev`` (no XLA cost analysis) are dropped;
``collectives.network`` is added (the bytes of groups that span
8-GPU nodes). ``memory.peak_bytes_per_dev`` is the argument bytes plus
the most bytes the step's own tensors held at once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, cell_supported, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.rlc_paper import RLC_CELLS
from repro_torch.core.device_index import (_query_batch_rows,
                                           _query_batch_sorted_rows)
from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.models import decode_step, init_cache, init_model, prefill
from repro_torch.models.builder import (count_params, tree_flatten,
                                        tree_unflatten)
from repro_torch.roofline.analysis import (active_params, model_flops,
                                           roofline_terms)
from repro_torch.roofline.trace_tools import StepTrace, trace_totals
from repro_torch.sharding.partition import (ACT_RULES, PARAM_RULES,
                                            NamedSharding, constrain,
                                            local_apply,
                                            logical_to_sharding,
                                            tree_shardings)
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.train_loop import init_train_state

_QUERY_RULES = {"act_batch": ("pod", "data"), "act_heads": "model"}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A world of ``world_size`` ranks on the ``fake`` backend, this
    process rank 0, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _abstract(shape, dtype, sharding: NamedSharding, device):
    """An empty tensor of ``shape`` placed as ``sharding`` says: this
    rank's shard (on ``meta``), a DTensor on a mesh of more than one
    rank."""
    local = torch.empty(sharding.local_shape(shape), dtype=dtype,
                        device=device)
    if sharding.mesh.size() == 1:
        return local
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _abstract_tree(tree, shardings, device):
    """``tree`` (meta tensors) placed by ``shardings``."""
    sh = [s for _, s in tree_flatten(
        shardings, is_leaf=lambda s: isinstance(s, NamedSharding))]
    return tree_unflatten(tree, [
        _abstract(tuple(x.shape), x.dtype, s, device)
        for (_, x), s in zip(tree_flatten(tree), sh)])


def _input(shape, dtype, axes, mesh, device):
    return _abstract(shape, dtype, logical_to_sharding(
        shape, axes, mesh, ACT_RULES), device)


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for _, x in tree_flatten(tree))


# ------------------------------------------------------------------ #
# Input specs (meta stand-ins; placed, no allocation)
# ------------------------------------------------------------------ #
def input_specs(cfg, shape, mesh, device="meta") -> Dict:
    """Abstract inputs of one (arch x shape) cell. Train batches are global
    (the train step places each microbatch itself); prefill and decode
    inputs are placed by ``act_batch``."""
    B, S = shape.global_batch, shape.seq_len
    out = {"kind": shape.kind}
    fe = None
    if shape.kind == "train":
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                       device=device),
                 "labels": torch.zeros((B, S), dtype=torch.int32,
                                       device=device)}
        if cfg.frontend != "none":
            batch["frontend"] = torch.zeros(
                (B, cfg.frontend_len, cfg.frontend_dim), device=device)
        out.update(batch=batch)
        return out
    if cfg.frontend != "none":
        fe = _input((B, cfg.frontend_len, cfg.frontend_dim), torch.float32,
                    ("act_batch", None, None), mesh, device)
    if shape.kind == "prefill":
        out.update(tokens=_input((B, S), torch.int32, ("act_batch", None),
                                 mesh, device), frontend=fe)
    else:  # decode: one new token against a seq_len cache
        out.update(token=_input((B, 1), torch.int32, ("act_batch", None),
                                mesh, device))
    return out


def _batch_share(batch, mesh) -> int:
    """Bytes of this rank's share of a global train batch."""
    total = 0
    for v in batch.values():
        sh = logical_to_sharding(v.shape, ("act_batch",) + (None,) * (
            v.ndim - 1), mesh, ACT_RULES)
        total += math.prod(sh.local_shape(v.shape)) * v.element_size()
    return total


def _decode_cache_specs(cfg, shape, mesh, params, device="meta"):
    """The cache of a decode cell, placed by ``ACT_RULES``; enc-dec archs
    carry the encoder's K/V in it."""
    # VLM prefix tokens extend the cached sequence (early fusion)
    max_len = shape.seq_len + (cfg.frontend_len
                               if cfg.frontend == "patch_stub" else 0)
    cache, cache_axes = init_cache(cfg, shape.global_batch, max_len,
                                   abstract=True)
    cache = _abstract_tree(cache, tree_shardings(cache, cache_axes, mesh,
                                                 ACT_RULES), device)
    if cfg.encoder_layers:
        from repro_torch.models.lm import _enc_kv_tree
        enc_out = _input((shape.global_batch, cfg.frontend_len,
                          cfg.d_model), cfg.dtype("compute"),
                         ("act_batch", None, None), mesh, device)
        with torch.no_grad():
            kv = _enc_kv_tree(params, cfg, enc_out)
        cache["enc_kv"] = {
            key: tuple(constrain(x, ("layers",) * (x.ndim - 4) + (
                "act_batch", None, "kv", None), ACT_RULES) for x in pair)
            for key, pair in kv.items()}
    return cache, max_len


# ------------------------------------------------------------------ #
# Cell tracing
# ------------------------------------------------------------------ #
def _record(arch, shape_name, mesh, seconds, tr, args_bytes, out_bytes,
            extra):
    """The reference's record from one traced step; ``out_bytes``: what
    the step's own outputs held when it returned."""
    totals = trace_totals(tr)
    coll = {k[5:]: int(v) for k, v in totals.items()
            if k.startswith("coll_")}
    n_chips = mesh.size()
    flops_dev = float(totals["flops"])
    bytes_dev = float(totals["hbm_bytes_est"])
    rec = {
        "arch": arch, "shape": shape_name, "skipped": False,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "chips": n_chips, "compile_seconds": round(seconds, 1),
        "memory": {
            "argument_bytes_per_dev": args_bytes,
            "output_bytes_per_dev": out_bytes,
            "temp_bytes_per_dev": tr.peak_bytes - out_bytes,
            "peak_bytes_per_dev": args_bytes + tr.peak_bytes,
        },
        "cost": {"flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
                 "hlo_flops_total": flops_dev * n_chips},
        "collectives": coll,
        "roofline": roofline_terms(flops_dev, bytes_dev,
                                   float(coll["total"]),
                                   network_bytes_per_dev=float(
                                       coll["network"])),
    }
    rec.update(extra)
    return rec


def lower_cell(arch: str, shape_name, mesh, microbatches: int = 1,
               remat: Optional[str] = None, ssm_chunk: int = 0,
               moe_combine: Optional[str] = None, attn_chunk: int = 0
               ) -> Dict:
    """Trace one cell as rank 0 of ``mesh``'s world; returns the roofline
    record. ``shape_name`` names a cell of ``SHAPES`` or is a
    ``ShapeCell``."""
    if arch.startswith("rlc-"):
        return lower_rlc_cell(arch, mesh)
    cfg = get_config(arch)
    if ssm_chunk:
        cfg = cfg.replace(ssm_chunk=ssm_chunk)
    if moe_combine:
        cfg = cfg.replace(moe_combine=moe_combine)
    if attn_chunk:
        cfg = cfg.replace(attn_chunk=attn_chunk)
    if remat:
        cfg = cfg.replace(remat=remat)
    shape = (shape_name if isinstance(shape_name, ShapeCell)
             else SHAPES[shape_name])
    shape_name = shape.name
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": reason}

    dev = torch.device("meta")
    with mesh_context(mesh):
        specs = input_specs(cfg, shape, mesh, dev)
        tr = StepTrace()
        if shape.kind == "train":
            oc = OptConfig()
            state, state_axes = init_train_state(cfg, oc, abstract=True)
            state = _abstract_tree(state, tree_shardings(
                state, state_axes, mesh, PARAM_RULES), dev)
            step_fn = make_train_step(cfg, oc, microbatches=microbatches,
                                      mesh=mesh)
            args_bytes = _tree_bytes(state) + _batch_share(specs["batch"],
                                                           mesh)
            t0 = time.perf_counter()
            with tr:
                out = step_fn(state, specs["batch"])
        else:
            params, axes = init_model(cfg, abstract=True)
            params = _abstract_tree(params, tree_shardings(
                params, axes, mesh, PARAM_RULES), dev)
            cache, max_len = _decode_cache_specs(cfg, shape, mesh, params,
                                                 dev)
            if shape.kind == "prefill":
                cache.pop("enc_kv", None)
                args = (params, specs["tokens"], cache, specs["frontend"])
                fn = lambda: prefill(params, cfg, specs["tokens"],  # noqa
                                     cache, specs["frontend"])
            else:
                args = (params, cache, specs["token"])
                fn = lambda: decode_step(params, cfg, cache,  # noqa: E731
                                         specs["token"], max_len - 1)
            args_bytes = sum(_tree_bytes(a) if isinstance(a, dict)
                             else (_nbytes(a) if a is not None else 0)
                             for a in args)
            t0 = time.perf_counter()
            with torch.no_grad(), tr:
                out = fn()
        seconds = time.perf_counter() - t0
        out_bytes = tr.live_bytes
        del out

    params_abs, _ = init_model(cfg, abstract=True)
    n_params = count_params(params_abs)
    n_active = active_params(cfg, n_params)
    embed_params = cfg.padded_vocab * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    mf = model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch,
                     n_active, embed_params)
    rec = _record(arch, shape_name, mesh, seconds, tr, args_bytes,
                  out_bytes, {"params": n_params, "params_active": n_active})
    total = rec["cost"]["hlo_flops_total"]
    rec["model_flops"] = mf
    rec["useful_flops_ratio"] = mf / total if total else 0.0
    return rec


# ------------------------------------------------------------------ #
# The paper's own cells
# ------------------------------------------------------------------ #
def closure_step(r: torch.Tensor) -> torch.Tensor:
    """One log-doubling closure step ``R | (R @ R > 0)`` in ``r``'s dtype
    (a sum of 0/1 products is positive in bf16 exactly when it is)."""
    rr = (torch.matmul(r, r) > 0).to(r.dtype)
    return torch.maximum(r, rr)


def lower_rlc_cell(name: str, mesh, num_vertices: Optional[int] = None
                   ) -> Dict:
    """Trace the RLC engine's two hot steps on ``mesh``: the closure step
    on an (n, n) bf16 matrix, rows over ("pod", "data") and columns over
    "model", its result constrained back to that layout; or the batched
    query join on replicated (n, E) rows with the queries split over
    ("pod", "data"). ``num_vertices`` overrides the cell's n."""
    cell = RLC_CELLS[name]
    n = num_vertices or cell.num_vertices
    dev = torch.device("meta")
    with mesh_context(mesh):
        tr = StepTrace()
        if cell.hub_batch:
            row_sh = logical_to_sharding((n, n), ("act_batch", "act_heads"),
                                         mesh, _QUERY_RULES)
            R = _abstract((n, n), torch.bfloat16, row_sh, dev)
            args_bytes = _nbytes(R)
            t0 = time.perf_counter()
            with tr:
                out = closure_step(R)
                if isinstance(out, DTensor):
                    out = out.redistribute(mesh, row_sh.placements)
        else:
            Q, E = cell.query_batch, cell.row_len
            rep = logical_to_sharding((n, E), (None, None), mesh,
                                      ACT_RULES)
            qsh = logical_to_sharding((Q,), ("act_batch",), mesh, ACT_RULES)
            qs = [_abstract((Q,), torch.int32, qsh, dev) for _ in range(3)]
            if name.endswith("-sorted"):
                rows = [_abstract((n, E), torch.int32, rep, dev)
                        for _ in range(2)]
                join = lambda ok, ik, s, t, mr: (  # noqa: E731
                    _query_batch_sorted_rows(ok, ik, s, t, s, t, mr,
                                             num_mrs=72))
            else:
                rows = [_abstract((n, E), torch.int32, rep, dev)
                        for _ in range(4)]
                join = lambda oh, om, ih, im, s, t, mr: (  # noqa: E731
                    _query_batch_rows(oh, om, ih, im, s, t, s, t, mr))
            args_bytes = sum(map(_nbytes, rows + qs))
            t0 = time.perf_counter()
            with tr:
                # each rank joins its queries against its replica of the
                # rows (no sharding strategy for searchsorted / gathers)
                out = local_apply(join, rows + qs,
                                  [(None, None)] * len(rows)
                                  + [("act_batch",)] * 3,
                                  out_like=len(rows))
        seconds = time.perf_counter() - t0
        out_bytes = tr.live_bytes
        del out
    return _record(name, "paper", mesh, seconds, tr, args_bytes, out_bytes,
                   {})


# ------------------------------------------------------------------ #
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default="train_4k",
                    choices=list(SHAPES) + ["paper"])
    ap.add_argument("--mesh", type=str, default="pod",
                    choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell on this mesh")
    ap.add_argument("--out", type=str,
                    default="benchmarks/artifacts/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="grad-accum microbatches for train cells")
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="override SSD chunk length (perf iteration)")
    ap.add_argument("--moe-combine", type=str, default=None,
                    choices=[None, "gather", "scatter"],
                    help="override MoE combine formulation")
    ap.add_argument("--attn-chunk", type=int, default=0,
                    help="chunked online-softmax attention block size")
    ap.add_argument("--remat", type=str, default=None)
    args = ap.parse_args(argv)
    multi = args.mesh == "multipod"
    os.makedirs(args.out, exist_ok=True)

    def run_one(mesh, arch, shape_name):
        tag = f"{arch}__{shape_name}__{args.mesh}"
        if args.remat:
            tag += f"__remat-{args.remat}"
        if args.microbatches != 1:
            tag += f"__mb{args.microbatches}"
        if args.ssm_chunk:
            tag += f"__chunk{args.ssm_chunk}"
        if args.moe_combine:
            tag += f"__{args.moe_combine}"
        if args.attn_chunk:
            tag += f"__attnchunk{args.attn_chunk}"
        path = os.path.join(args.out, tag + ".json")
        try:
            rec = lower_cell(arch, shape_name, mesh,
                             microbatches=args.microbatches,
                             remat=args.remat, ssm_chunk=args.ssm_chunk,
                             moe_combine=args.moe_combine,
                             attn_chunk=args.attn_chunk)
            rec["status"] = "ok" if not rec.get("skipped") else "skipped"
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            r = rec.get("roofline", {})
            extra = (f" dom={r.get('dominant')} "
                     f"frac={r.get('roofline_fraction', 0):.3f} "
                     f"compile={rec.get('compile_seconds')}s")
        elif status == "skipped":
            extra = f" ({rec.get('reason', '')[:60]})"
        else:
            extra = f" !! {rec.get('error', '')[:160]}"
        print(f"[dryrun] {tag}: {status}{extra}", flush=True)
        return rec

    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cuda")
        if args.all:
            from repro_torch.configs import ASSIGNED
            ok = True
            for arch in ASSIGNED:
                for shape_name in SHAPES:
                    rec = run_one(mesh, arch, shape_name)
                    ok &= rec.get("status") in ("ok", "skipped")
            for rlc in RLC_CELLS:
                rec = run_one(mesh, rlc, "paper")
                ok &= rec.get("status") in ("ok", "skipped")
            code = 0 if ok else 1
        else:
            rec = run_one(mesh, args.arch, args.shape)
            if rec.get("status") == "ok":
                print(json.dumps(
                    {k: rec[k] for k in ("memory", "cost", "collectives",
                                         "roofline") if k in rec},
                    indent=1))
            code = 0 if rec.get("status") in ("ok", "skipped") else 1
    sys.exit(code)


if __name__ == "__main__":
    main()
