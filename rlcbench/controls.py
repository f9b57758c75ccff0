"""Controls: the plain reference put in the program's place with one of
the configuration's guarantees broken, driven through a run's window and
check, to show that the check fails it.

The controls of an entry point sit in its file
(``rlcbench/entrypoints/<entry>.py``, ``CONTROLS``). The configurations
state no floating-point precision: the builds compute
OR-AND products of 0/1 values, whose answers are exact in any float type
that holds the sums' sign, so a lower precision is not what a later change
would get wrong. They state two guarantees, and each control breaks one:

* ``short_closure``: every reach closed one squaring short of its fixed
  point, as a closure with a guessed, too small number of doubling steps
  would be (breaks the exact reach);
* ``no_case1`` (``condensed`` only): the labeling with PR1's hub join (the
  coverage product) left out, as a build that skipped the costly product
  would be (breaks the exact labeling: entries that PR1 prunes stay in).

Run on the card at a cell's own size, one process for several seeds:

    python3 rlcbench/controls.py --workload ad-rlc-build --seeds 1 2 3

Each line printed is one control on one seed, with every number the check
compared and its limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    _root = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(_root), str(_root / "src")]

from rlcbench import harness  # noqa: E402


def run_controls(cell: harness.Cell, seeds, device: str = "cuda",
                 names=None):
    """Yield one reading per control (of ``names``, default all) and seed:
    the run's ``correct`` and the numbers its check compared. Each
    control runs one window build (``seconds=0``)."""
    for name, cls in harness.load_entrypoint(
            cell.traffic["entry"]).CONTROLS.items():
        if names is not None and name not in names:
            continue
        for seed in seeds:
            t = time.perf_counter()
            line = harness.run_cell(cell, seed, 0.0, False, device,
                                    entry_cls=cls)
            yield {"workload": cell.name, "control": name, "seed": seed,
                   "correct": line["correct"], "checks": line["checks"],
                   "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    for reading in run_controls(cell, args.seeds):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
