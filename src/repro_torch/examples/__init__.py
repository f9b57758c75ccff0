"""The eight scripts of the JAX package's ``examples/``, on the port.

Each runs as ``python -m repro_torch.examples.<name>`` (on the card; add
``--device cpu`` for the host) and has a ``main(device="cuda", ...)``
that prints the reference's report, makes its checks against the
BiBFS/BFS oracle and returns a small dict of what it checked. Asking for
``cuda`` without a card raises before anything is built.
"""
