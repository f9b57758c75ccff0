"""Hand-written Hopper kernels of the RLC engine, with their plain versions.

Layout: ``csrc/<name>.cu`` holds a CUDA kernel behind a plain C entry
point, ``<name>.py`` its wrapper (checks, launch, launch count),
``ref.py`` the plain PyTorch versions and ``_build.py`` the ``nvcc``
build and ``ctypes`` binding. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches its kernel or raises.
"""
from . import bitpack, label_frontier, mergejoin, ref

#: every kernel of the package, by name (``launches`` counts each)
KERNELS = {"mergejoin": mergejoin.KERNEL,
           "label_frontier": label_frontier.KERNEL}

__all__ = ["KERNELS", "bitpack", "label_frontier", "mergejoin", "ref"]
