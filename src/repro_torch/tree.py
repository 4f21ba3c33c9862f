"""Trees of tensors: nested dicts and lists whose other values are leaves.

Every walk keeps the nesting, visits a dict's leaves in sorted key order
(the order of ``jax.tree.leaves``) and a list's in index order.  The
hybrid step, the optimizers, the train step and the model builder share
these walks.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree: Tree) -> List[Any]:
    """The leaves of ``tree`` in walk order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree: Tree, flat: Iterator[Any]) -> Tree:
    """``tree``'s nesting with its leaves taken from ``flat`` in
    :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: unflatten(tree[k], flat) for k in sorted(tree)}
    if isinstance(tree, list):
        return [unflatten(v, flat) for v in tree]
    return next(flat)


def unzip(tree: Tree, n: int) -> Tuple[Tree, ...]:
    """A tree whose leaves are ``n``-tuples as ``n`` trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def grad_leaves(tree: Tree) -> Tree:
    """Fresh autograd leaves over the storage of ``tree``'s tensors."""
    return tree_map(lambda v: v.detach().requires_grad_(True), tree)


def grad(loss: torch.Tensor, tree: Tree,
         grad_output: Optional[torch.Tensor] = None) -> Tree:
    """d ``loss`` / d every leaf of ``tree`` (zeros where a leaf is
    unused), in ``tree``'s nesting; ``grad_output`` is the cotangent of a
    non-scalar ``loss``."""
    xs = leaves(tree)
    gs = torch.autograd.grad(loss, xs, grad_outputs=grad_output,
                             allow_unused=True)
    return unflatten(tree, iter(torch.zeros_like(x) if g is None else g
                                for x, g in zip(xs, gs)))
