"""Phase 12 of one tree's ``chip_smoke.py`` alone: the model substrate's
serving path (``qwen3-0.6b`` at full width in bf16 and f32, chunked
attention, the ten smoke configs), to compare two trees in one call on
one card.

    python3 chip_phase12.py TREE    # TREE holds chip_smoke.py and src/

Runs TREE's ``run_model_serving``, which prints its lines and raises if a
check fails. It builds no kernel: the model path is plain torch ops. Run
each tree in its own process, for example each unpacked with
``git archive`` under ``.trees/``.
"""
import importlib
import subprocess
import sys
from pathlib import Path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phase12: no CUDA device", file=sys.stderr)
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
    cs.run_model_serving(torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
