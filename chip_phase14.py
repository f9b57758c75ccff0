"""Phases 13 and 14 of one tree's ``chip_smoke.py`` alone: the training
path (whose loss history phase 14 holds its placed run against), then
the dry run and the roofline held against the card.

    python3 chip_phase14.py TREE    # TREE holds chip_smoke.py and src/

Builds ``bool_semiring.cu`` (phase 14 times ``closure_step`` beside the
closure cell's bound), runs TREE's ``run_model_training`` and
``run_dry_run``, which print their lines and raise if a check fails.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

# deterministic cuBLAS for phase 13's restart drill; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phase14: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    cs = importlib.import_module("chip_smoke")
    from repro_torch.kernels import KERNELS, _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree.name}: torch {torch.__version__} ({card})",
          flush=True)
    _build.build(["bool_semiring"])
    trained = cs.run_model_training(torch, card)
    for kern in KERNELS.values():
        kern.launches = 0
    cs.run_dry_run(torch, card, trained, KERNELS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
