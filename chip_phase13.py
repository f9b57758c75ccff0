"""Phase 13 of one tree's ``chip_smoke.py`` alone: the model substrate's
training path (``qwen3-0.6b`` at full width trained in bf16 through
``launch.train.run``, its checkpoint, a 2-layer f32 cut against the host
CPU and across microbatches, the restart drill), to compare two trees in
one call on one card.

    python3 chip_phase13.py TREE    # TREE holds chip_smoke.py and src/

Runs TREE's ``run_model_training``, which prints its lines and raises if a
check fails. It builds no kernel: the training path is plain torch ops. Run
each tree in its own process, for example each unpacked with
``git archive`` under ``.trees/``.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

# deterministic cuBLAS for the restart drill; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phase13: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    cs = importlib.import_module("chip_smoke")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree.name}: torch {torch.__version__} ({card})",
          flush=True)
    cs.run_model_training(torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
