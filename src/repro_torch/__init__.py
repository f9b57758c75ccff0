"""PyTorch/CUDA port of the RLC reachability index (see README.md).

Mirrors the module tree of the JAX package ``repro``, which stays the
reference: the same graphs, builds and queries give the same entries,
counters and answers. Device state lives in torch tensors; the two
kernels of the main path are hand-written CUDA for Hopper
(:mod:`repro_torch.kernels`). Beside the index it carries ``repro``'s
model substrate for serving (:mod:`repro_torch.configs`,
:mod:`repro_torch.models`, :mod:`repro_torch.serve`) and training
(:mod:`repro_torch.train`, :mod:`repro_torch.data`,
:mod:`repro_torch.checkpoint`, :mod:`repro_torch.ft`,
:mod:`repro_torch.sharding`, :mod:`repro_torch.launch`), plain torch
ops.
"""
