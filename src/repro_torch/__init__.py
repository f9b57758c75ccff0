"""PyTorch/CUDA port of the RLC reachability index (see README.md).

Mirrors the module tree of the JAX package ``repro``, which stays the
reference: the same graphs, builds and queries give the same entries,
counters and answers. Device state lives in torch tensors; the two
kernels of the main path are hand-written CUDA for Hopper
(:mod:`repro_torch.kernels`).
"""
