"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to a cell is found by name: the configuration's
file (``configs[].file``), the traffic file ``rlcbench/traffic/<traffic>
.json``, the entry point it names, ``rlcbench/entrypoints/<entry>.py``,
and for each per-layer metric its reader ``rlcbench/metrics/<metric>.py``
(or, where there is none, ``metrics/<stem>.py``, the stem being the name
before its first dot). A new cell, configuration, traffic, entry point or
metric is a new file and an entry in ``BENCHMARK.json``; nothing here
changes.

A run: set-up (the graph from the seed, the entry point's program state
and warm-up), then the entry's window for ``seconds``, then, with the
window closed and the program's device state released, the check of a
seeded sample of the window's results against the plain reference. The
end-to-end values are the entry's own (``Window.values``) and the two
the harness measures for every cell: ``setup_s`` and ``peak_gib``; a
metric is read under its name or, where there is none, its stem
(``build_s.etc`` reads the entry's ``build_s``). With
``trace`` the window runs under ``torch.profiler`` and the line carries
the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import functools
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SAMPLES = 2     # window results kept for the check, drawn from the seed


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@functools.lru_cache(maxsize=None)
def _load(path: Path):
    """The module in ``path``, loaded once by its file path."""
    spec = importlib.util.spec_from_file_location(
        "rlcbench_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
        .replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str) -> Callable:
    """The ``read(ctx)`` of ``rlcbench/metrics/<name>.py``, else of
    ``metrics/<stem>.py`` (``device_idle_share.rlc`` reads with
    ``device_idle_share.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return _load(path).read


def load_entrypoint(name: str):
    """The module ``rlcbench/entrypoints/<name>.py``: its ``ENTRY`` class
    and its ``CONTROLS``."""
    return _load(HERE / "entrypoints" / f"{name}.py")


def resolve(bench: Mapping, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``, with its files read."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return Cell(workload, int(cell["chips"]), config, traffic, e2e, layer,
                {m["name"]: load_reader(m["name"]) for m in layer})


@dataclass
class Context:
    """What a per-layer reader gets: the trace, the cell's configuration
    and traffic, and the shapes the work is counted from."""
    trace: object
    config: dict
    traffic: dict
    n: int
    k: int
    hub_batch: int
    mr_lengths: List[int]


class Reservoir:
    """A uniform sample of ``size`` results of the window, drawn from the
    seed (reservoir sampling), so the check needs no list of them all."""

    def __init__(self, size: int, seed: int):
        self.size, self.kept, self.seen = size, [], 0
        self.rng = np.random.default_rng([int(seed) % 2 ** 64, 7])

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.kept[j] = item


def forbidden_modules(names=None) -> List[str]:
    """Of ``names`` (default: the loaded modules), the top-level names of
    JAX, its relatives, the JAX package or its benchmarks (compared whole:
    ``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             entry_cls=None) -> dict:
    """One run; returns the result line as a dict. ``device="cpu"`` runs
    the program's plain versions (the tests' rehearsal); ``entry_cls``
    puts another entry (a control) in the program's place."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.graph import LabeledGraph
    from rlcbench import tracing
    from rlcbench.gen.graphs import make_edges
    from rlcbench.reference import plain

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, g = cell.config, cell.config["graph"]
    edges = make_edges(g, seed)
    graph = LabeledGraph.from_edges(g["num_vertices"], g["num_labels"],
                                    edges)
    entry = (entry_cls or load_entrypoint(cell.traffic["entry"]).ENTRY)(
        graph, edges, cfg, cell.traffic, dev)
    entry.setup()
    sync()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- the window ---------------------------------------------------- #
    kept = Reservoir(SAMPLES, seed)
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with record_function(tracing.WINDOW):
        t0 = time.perf_counter()
        win = entry.window(seconds, kept.offer)
        t1 = time.perf_counter()
    sync()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if prof is not None:
        prof.__exit__(None, None, None)
    phases = {"setup": setup_s, "window": t1 - t0,
              "trace_stop": time.perf_counter() - t1}

    metrics: Dict[str, dict] = {}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    breakdown = None
    if trace:
        tr = tracing.from_profiler(prof)
        del prof
        w = tr.window() or (0.0, t1 - t0)
        device_info["busy_s"] = tracing.busy_s(tr, *w)
        device_info["window_s"] = w[1] - w[0]
        mrs = plain.minimum_repeats(g["num_labels"], int(cfg["k"]))
        ctx = Context(tr, cfg, cell.traffic, int(g["num_vertices"]),
                      int(cfg["k"]), int(cfg["hub_batch"]),
                      [len(m) for m in mrs])
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        breakdown = tracing.breakdown(tr)
        phases["trace_read"] = time.perf_counter() - t1 - phases["trace_stop"]
    else:
        values = {**win.values, "peak_gib": window_peak / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            name = m["name"]
            value = values.get(name, values.get(name.split(".")[0]))
            if value is None:
                raise KeyError(f"the window measured no {name!r}")
            metrics[name] = {"value": float(value), "unit": m["unit"]}

    # ---- the check, with the program's device state released ----------- #
    samples = [entry.canonical(r) for r in kept.kept]
    kept.kept.clear()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, bad = entry.check(samples)
    phases["check"] = time.perf_counter() - t_check
    print("rlcbench: phases_s " + json.dumps(phases) + " window "
          + json.dumps(win.log), file=sys.stderr)
    correct = win.attempted > 0 and all(v <= lim
                                        for v, lim in checks.values())
    line = {"correct": correct, "attempted": win.attempted, "failed": bad,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="rlcbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    try:
        bench = load_benchmark()
        cell = resolve(bench, args.workload)
    except (OSError, KeyError, StopIteration, json.JSONDecodeError) as e:
        print(f"rlcbench: cannot resolve {args.workload!r}: {e!r}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"rlcbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"rlcbench: the program (src/repro_torch) is missing: {e}",
              file=sys.stderr)
        return 4
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"rlcbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
