"""Phase 15 of one tree's ``chip_smoke.py`` alone: the eight example
twins on the card and the cross-layout checkpoint checks.

    python3 chip_phase15.py TREE    # TREE holds chip_smoke.py and src/

Builds the three kernel sources (one ``nvcc`` each, all started
together), runs TREE's ``run_examples``, which prints its lines and
raises if a check fails.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

# deterministic cuBLAS, as chip_smoke.py sets it; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phase15: no CUDA device", file=sys.stderr)
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
    _build.build(["mergejoin", "label_frontier", "bool_semiring"])
    cs.run_examples(torch, card, KERNELS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
