"""Run one cell of the benchmark once and print its result line.

    python3 rlcbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for. See ``rlcbench/README.md``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``rlcbench``) and ``src`` (for the program),
# in place of this script's own folder
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from rlcbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
