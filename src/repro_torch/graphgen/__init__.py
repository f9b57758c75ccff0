from .generators import (barabasi_albert, erdos_renyi, fig1_graph,
                         fig2_graph, random_delta, random_labeled_graph,
                         zipf_labels)

__all__ = ["erdos_renyi", "barabasi_albert", "zipf_labels",
           "random_labeled_graph", "random_delta", "fig2_graph",
           "fig1_graph"]
