"""Hand-written Hopper kernels of the RLC engine, with their plain versions.

Layout: ``csrc/<name>.cu`` holds CUDA kernels behind plain C entry
points, ``<name>.py`` their wrappers (checks, launch, launch count),
``ref.py`` the plain PyTorch versions, ``ops.py`` the JAX package's
kernel surface and ``_build.py`` the ``nvcc`` build and ``ctypes``
binding. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises.
"""
from . import (bitpack, bool_semiring, hub_cover, label_frontier, mergejoin,
               ops, ref)

#: every kernel entry point of the package, by name (``launches`` counts
#: each)
KERNELS = {"mergejoin": mergejoin.KERNEL,
           "label_frontier": label_frontier.KERNEL,
           "frontier_steps": label_frontier.STEPS_KERNEL,
           "frontier_step": label_frontier.STEP_KERNEL,
           "bool_matmul": bool_semiring.MATMUL_KERNEL,
           "closure_step": bool_semiring.CLOSURE_KERNEL,
           "bitpack_matmul": bitpack.KERNEL,
           "hub_cover": hub_cover.KERNEL,
           "entry_masks": hub_cover.MASKS_KERNEL}

__all__ = ["KERNELS", "bitpack", "bool_semiring", "hub_cover",
           "label_frontier", "mergejoin", "ops", "ref"]
