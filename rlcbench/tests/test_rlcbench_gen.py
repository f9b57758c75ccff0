"""The graph recipes: the edges of each configuration pinned by their
SHA-256, so that moving or extending the generator cannot change a cell's
workload unseen, and the look-up of a recipe by name."""
import hashlib

import numpy as np
import pytest

from rlcbench import harness
from rlcbench.gen import graphs

BENCH = harness.load_benchmark()
# (rows, SHA-256 of the int32 rows' bytes), as the generator gave them
# before recipes could be found by name
PINNED = {
    1: (49118, "199762b788afcc966441d6eb08df93b3"
               "70780845a8a8853188cefba29838176c"),
    2 ** 33 + 7: (49066, "a8f10ab951bcd406655ffadce6b64b2a"
                         "b10978429e5405f2bc25a535c9374dc5"),
}


@pytest.mark.parametrize("seed", sorted(PINNED))
@pytest.mark.parametrize("config", ["advogato-k2", "advogato-k3"])
def test_barabasi_albert_edges_are_pinned(config, seed):
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["config"] == config)
    edges = graphs.make_edges(harness.resolve(BENCH, cell).config["graph"],
                              seed)
    rows, digest = PINNED[seed]
    assert edges.dtype == np.int32 and edges.shape == (rows, 3)
    assert hashlib.sha256(edges.tobytes()).hexdigest() == digest


@pytest.mark.parametrize("name", ["no_such_recipe", "../harness", "graphs/x"])
def test_an_unknown_recipe_is_refused_by_name(name):
    with pytest.raises(KeyError, match="no graph recipe"):
        graphs.make_edges({"generator": name, "num_vertices": 8}, 1)
