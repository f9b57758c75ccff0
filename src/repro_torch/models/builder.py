"""Parameter builder: define each parameter once, get (params, logical axes).

Model code calls ``b.param(name, shape, axes)`` inside nested scopes; the
builder produces either initialised tensors, drawn from one
``torch.Generator`` on the target device, or tensors on the ``meta``
device (``abstract=True``: nothing is allocated, so the largest configs
can be counted), plus a matching tree of logical axis tuples. The tree
layout, the init rules and the axes are ``repro.models.builder``'s; the
draws are torch's, so the values differ from the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

PyTree = Any


class Builder:
    def __init__(self, generator: Optional[torch.Generator],
                 abstract: bool = False, dtype=torch.float32):
        if not abstract and generator is None:
            raise ValueError("a concrete build needs a torch.Generator")
        self._gen = generator
        self.abstract = abstract
        self.default_dtype = dtype
        self.device = (torch.device("meta") if abstract
                       else generator.device)
        self.params: Dict[str, Any] = {}
        self.axes: Dict[str, Any] = {}
        self._scopes: list = []

    # ---------------------------------------------------------------- #
    @contextlib.contextmanager
    def scope(self, name: str):
        self._scopes.append(str(name))
        try:
            yield self
        finally:
            self._scopes.pop()

    def _place(self, tree: Dict, name: str, value) -> None:
        d = tree
        for s in self._scopes:
            d = d.setdefault(s, {})
        if name in d:
            raise ValueError(
                f"duplicate param {'/'.join(self._scopes + [name])}")
        d[name] = value

    # ---------------------------------------------------------------- #
    def param(self, name: str, shape: Sequence[int], axes: Sequence,
              init: str = "fan_in", fan_axis: int = -2,
              dtype=None, scale: float = 1.0) -> torch.Tensor:
        """Register one parameter.

        init: 'fan_in' (normal, std=scale/sqrt(fan_in)), 'normal'
        (std=scale), 'zeros', 'ones'. ``fan_axis`` picks the fan-in dim
        for stacked (layers-first) params. Draws are float32 normals
        scaled, then cast to ``dtype``.
        """
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} vs axes {axes}")
        dtype = dtype or self.default_dtype
        kw = dict(dtype=dtype, device=self.device)
        if self.abstract:
            value = torch.empty(shape, **kw)
        elif init == "zeros":
            value = torch.zeros(shape, **kw)
        elif init == "ones":
            value = torch.ones(shape, **kw)
        else:
            if init == "fan_in":
                fan = shape[fan_axis] if len(shape) >= 2 else shape[0]
                std = scale / math.sqrt(max(fan, 1))
            else:
                std = scale
            value = (torch.randn(shape, generator=self._gen,
                                 dtype=torch.float32, device=self.device)
                     * std).to(dtype)
        self._place(self.params, name, value)
        self._place(self.axes, name, axes)
        return value

    def build(self) -> Tuple[PyTree, PyTree]:
        return self.params, self.axes


def tree_leaves(tree: PyTree):
    """``(path, leaf)`` pairs of a tree of nested dicts, depth first in
    key order; a path is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in tree_leaves(tree[k]):
                yield (k,) + path, leaf
    else:
        yield (), tree


def tree_from_leaves(pairs) -> Dict:
    """The nested dicts whose :func:`tree_leaves` are ``pairs``."""
    out: Dict = {}
    for path, leaf in pairs:
        d = out
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = leaf
    return out


def _children(tree):
    """(key, child) pairs of a tree node, or None for a leaf: dict keys
    sorted; list, tuple and dataclass children by index."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def tree_flatten(tree: PyTree, is_leaf=None):
    """``(path, leaf)`` pairs of a tree of dicts, lists, tuples and
    dataclasses, in the order ``jax.tree_util.tree_flatten_with_path``
    gives (dict keys sorted; a dataclass's fields in order); a path is a
    tuple of strings (keys, or indices). ``None`` holds no leaf."""
    if tree is None:
        return
    kids = None if is_leaf is not None and is_leaf(tree) else \
        _children(tree)
    if kids is None:
        yield (), tree
        return
    for key, child in kids:
        for path, leaf in tree_flatten(child, is_leaf):
            yield (key,) + path, leaf


def tree_unflatten(template: PyTree, leaves, is_leaf=None) -> PyTree:
    """``template``'s structure holding ``leaves`` in
    :func:`tree_flatten` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)
    return build(template)


def tree_map(fn, tree: PyTree) -> PyTree:
    """``fn`` applied to every leaf of nested dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def count_params(params: PyTree) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in tree_leaves(params))


def param_bytes(params: PyTree) -> int:
    return sum(math.prod(leaf.shape) * leaf.element_size()
               for _, leaf in tree_leaves(params))
