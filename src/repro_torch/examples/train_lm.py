"""End-to-end example: train a ~100M-param LM for a few hundred steps with
checkpoint/restart and straggler monitoring
(``examples/train_lm.py`` of the JAX package).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

Uses a 100M-param qwen3-family config (12L, d=768, float32) on synthetic
data; prints the loss curve and survives a failure injected at
``steps // 2``. Checkpoints go to a fresh temporary directory, removed
at the end, so every run starts from step 0 (the reference's fixed
directory makes a second run resume at its last step).
"""
from __future__ import annotations

import shutil
import tempfile

from repro_torch.configs.base import ArchConfig, dense_pattern, register
from repro_torch.core.devices import resolve_device
from repro_torch.examples._cli import parser
from repro_torch.launch.train import run
from repro_torch.models import count_params, init_model

CFG_100M = register(ArchConfig(
    name="examples-lm-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    block_pattern=dense_pattern(12),
    qk_norm=True,
    vocab_pad_multiple=128,
    param_dtype="float32",
    compute_dtype="float32",
))


def main(device="cuda", steps=300, batch=8, seq=256, arch=CFG_100M.name,
         ckpt_every=50) -> dict:
    """Train ``arch`` (the 100M config unless a test names a smaller one)
    with a failure injected after step ``steps // 2`` computes;
    ``ckpt_every`` must land a checkpoint before it."""
    dev = resolve_device(device)
    from repro_torch.configs import get_config
    params, _ = init_model(get_config(arch), abstract=True)
    print(f"model: {count_params(params)/1e6:.1f}M params")

    ckpt = tempfile.mkdtemp(prefix="train_lm_ckpt_")
    try:
        _, history, report = run(
            arch, steps=steps, batch=batch, seq=seq, ckpt_dir=ckpt,
            ckpt_every=ckpt_every, lr=6e-4, log_every=20,
            fail_at={steps // 2: RuntimeError("injected node failure")},
            device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"\nloss: {history[0]:.3f} -> {history[-1]:.3f} "
          f"({len(history)} effective steps)")
    print(f"restarts survived: {report.restarts}, "
          f"stragglers flagged: {len(report.straggler_steps)}")
    assert history[-1] < history[0]
    return {"params": count_params(params), "history": history,
            "steps_run": report.steps_run, "restarts": report.restarts,
            "stragglers": len(report.straggler_steps)}


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    main(args.device, args.steps, args.batch, args.seq)
