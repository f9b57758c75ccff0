"""End-to-end training driver: data -> train_step -> checkpoint/restart,
on the ranks of the world (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 512 [--ckpt-dir DIR] [--device cpu]

Restart-safe: re-running the same command with ``--ckpt-dir`` resumes
from the latest checkpoint (the data pipeline is a pure function of the
step). Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.devices import resolve_device
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.ft import StragglerMonitor, resilient_loop
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.partition import (PARAM_RULES, place_tree,
                                            tree_shardings)
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.train_loop import init_train_state


def run(arch: str, steps: int, batch: int, seq: int,
        ckpt_dir: Optional[str] = None, lr: float = 3e-4,
        microbatches: int = 1, ckpt_every: int = 25,
        model_parallel: int = 1, log_every: int = 10,
        seed: int = 0, fail_at=None, device="cuda", dtensor: bool = False):
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    from a seeded init. Returns (state, loss history, report — None
    without ``ckpt_dir``). Moments and gradients are float32 for a
    float32 config, else bfloat16, as the reference derives them. Starts
    (and tears down) a world of one rank when none exists. The state is
    placed as ``PARAM_RULES`` say: DTensors on a world of more than one
    rank, or on one rank with ``dtensor=True`` (the placed path of a
    larger world, on one device); plain tensors otherwise."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    low = "float32" if cfg.param_dtype == "float32" else "bfloat16"
    oc = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                   total_steps=steps, m_dtype=low, v_dtype=low,
                   grad_dtype=low)
    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh(model=model_parallel, device=dev)
        dc = DataConfig(seq_len=seq, global_batch=batch, seed=seed)
        data = SyntheticLMData(cfg, dc)
        state, state_axes = init_train_state(
            cfg, oc, torch.Generator(dev).manual_seed(seed), device=dev)
        state = place_tree(state, tree_shardings(state, state_axes, mesh,
                                                 PARAM_RULES), dtensor)
        step_fn = make_train_step(cfg, oc, microbatches=microbatches,
                                  mesh=mesh)
        return _loop(arch, step_fn, state, data, steps, ckpt_dir,
                     ckpt_every, log_every, fail_at, dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _loop(arch, step_fn, state, data, steps, ckpt_dir, ckpt_every,
          log_every, fail_at, dev):
    monitor = StragglerMonitor()
    history = []

    def batch_at(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data.batch_at(step).items()}

    if ckpt_dir:
        def wrapped(state, b):
            s, m = step_fn(state, b)
            history.append(float(m["loss"]))
            if len(history) % log_every == 0:
                print(f"[train {arch}] step={len(history)} "
                      f"loss={history[-1]:.4f} "
                      f"lr={float(m['lr']):.2e} "
                      f"gnorm={float(m['grad_norm']):.3f}", flush=True)
            return s, m

        state, report = resilient_loop(
            wrapped, state, batch_at, steps, ckpt_dir,
            ckpt_every=ckpt_every, monitor=monitor, fail_at=fail_at)
        return state, history, report

    for step in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_at(step))
        history.append(float(metrics["loss"]))   # waits for the step
        monitor.record(step, time.perf_counter() - t0)
        if (step + 1) % log_every == 0:
            print(f"[train {arch}] step={step+1} "
                  f"loss={history[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e}", flush=True)
    return state, history, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, history, report = run(
        args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
        args.lr, args.microbatches, args.ckpt_every, args.model_parallel,
        seed=args.seed, device=args.device)
    print(f"[train {args.arch}] done: loss {history[0]:.4f} -> "
          f"{history[-1]:.4f} over {len(history)} steps")
    if report:
        print(f"[train {args.arch}] restarts={report.restarts} "
              f"stragglers={len(report.straggler_steps)}")


if __name__ == "__main__":
    main()
