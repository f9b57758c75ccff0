"""What every program entry point of the benchmark shares: the
:class:`Entry` base class, the window it drives by default, and the
comparisons of its results with the plain reference.

A traffic file (``rlcbench/traffic/<name>.json``) names an entry point
under ``"entry"``; the harness loads ``rlcbench/entrypoints/<entry>.py``
by that name and takes its ``ENTRY`` class (and ``CONTROLS``, the
reference with a guarantee broken, for ``controls.py``). A new entry point
is a new file there; this module does not change for it.

An entry makes its program state in ``setup`` (which also warms up every
shape the window uses), drives the program in ``window`` and returns the
end-to-end values it measured, turns a kept result into the form the
reference gives in ``canonical``, and compares in ``check`` once the
window has closed and the program's device state is released.

The program is reached through module attributes at call time
(``dense.DenseEngine.build``), so a test can break it underneath.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from rlcbench import tracing
from rlcbench.reference import plain

Check = Dict[str, Tuple[float, float]]   # name -> (value, limit)
Verdict = Tuple[Check, int]   # the checks, and the samples found wrong


@dataclass
class Window:
    """What a window did: the units of work it ran (``attempted``), the
    end-to-end values it measured (by metric name), and seconds worth
    printing on standard error."""
    attempted: int
    values: Dict[str, float]
    log: Dict[str, object] = field(default_factory=dict)


def dense():
    from repro_torch.core import dense as module
    return module


def reach_diff(mrs, reach, ref_mrs, ref_R: torch.Tensor) -> int:
    """Cells ``(c, u, v)`` on which a reach stack indexed by ``mrs``
    differs from the reference's; an MR on one side only counts its true
    cells."""
    ref_id = plain.mr_index(ref_mrs)
    diff, seen = 0, set()
    for c, word in enumerate(mrs):
        got = torch.from_numpy(np.ascontiguousarray(reach[c])).to(
            ref_R.device)
        word = tuple(word)
        if word in ref_id and word not in seen:
            seen.add(word)
            diff += int((got != ref_R[ref_id[word]]).sum())
        else:
            diff += int(got.sum())
    for word, c in ref_id.items():
        if word not in seen:
            diff += int(ref_R[c].sum())
    return diff


def mr_diff(mrs, ref_mrs) -> int:
    """MRs in one list and not the other."""
    return len({tuple(w) for w in mrs} ^ {tuple(w) for w in ref_mrs})


def index_keys(idx, ref_mrs, n: int) -> np.ndarray:
    """The entries of an ``RLCIndex`` as :func:`plain.entry_keys` keys; an
    MR the reference does not know gets an id no reference key has."""
    ref_id = plain.mr_index(ref_mrs)
    C = len(ref_mrs)
    keys = []
    for side, rows in enumerate((idx.l_out, idx.l_in)):
        for y, row in enumerate(rows):
            for hub, words in row.items():
                for word in words:
                    c = ref_id.get(tuple(word), 2 * C)
                    keys.append(((side * C + c) * n + y) * n + hub)
    return np.sort(np.asarray(keys, np.int64))


def entry_diff(keys: np.ndarray, ref_keys: np.ndarray) -> int:
    """Entries in one labeling and not the other."""
    return int(np.setxor1d(keys, ref_keys).size)


class Entry:
    """One program entry point driven by a traffic file. By default the
    window runs ``build`` back to back and measures ``build_s``."""

    def __init__(self, graph, edges: np.ndarray, config: Mapping,
                 traffic: Mapping, device: torch.device):
        self.graph, self.edges, self.device = graph, edges, device
        self.traffic = traffic
        self.k = int(config["k"])
        self.hub_batch = int(config["hub_batch"])
        self.n = int(config["graph"]["num_vertices"])
        self.num_labels = int(config["graph"]["num_labels"])

    def setup(self) -> None:
        self.build()

    def build(self):
        raise NotImplementedError

    def window(self, seconds: float, keep: Callable) -> Window:
        """Builds back to back, each in a ``tracing.BUILD`` range; the last
        build that starts before ``seconds`` are up runs to its end.
        ``build_s`` is the window from the first build's start to the last
        one's return over the builds. Each result goes to ``keep``; the
        collector then freezes what is alive, so no build pays for
        scanning the results kept for the check."""
        ends = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            with record_function(tracing.BUILD):
                result = self.build()
            ends.append(time.perf_counter())
            keep(result)
            del result
            gc.freeze()
            if ends[-1] >= deadline:
                break
        return Window(len(ends), {"build_s": (ends[-1] - t0) / len(ends)},
                      {"builds_s": list(np.diff([t0] + ends))})

    def canonical(self, result):
        return result

    def check(self, samples: List) -> Verdict:
        raise NotImplementedError

    def reference_reach(self):
        return plain.reach(self.edges, self.n, self.num_labels, self.k,
                           self.device)
