"""Framework compat in a torch training loop (counterpart of
`embeddingtables_tpu/compat.py`).

JAX's module lets embedding tables ride a stock optax loop; this one gives
each of its names a meaning in a torch loop:

1. Autograd through a lookup: `nn.Embed` holds its table as a parameter
   and gets the dense scatter-add gradient, fine for small tables; for big
   ones use the lazy path (`nn.SparseEmbed`).
2. `sparse_gradient_transform(sparse_opt)`: a `GradientTransformation`
   `(init, update)` over a nest of dicts, lists and tuples of gradients
   whose leaves are tensors (dense) or `SparseEmbeddingUpdate`s (lazy table
   gradients). `update(grads, state, params)` runs the fused
   one-write-per-unique-row `sparse_opt.apply` on each sparse leaf's table
   in `params`, IN PLACE, and gives None as its update; a dense leaf's
   update is `-lr * g` (plain SGD at `sparse_opt.lr`).
   `apply_updates(params, updates)` adds the dense updates into `params` in
   place and skips the Nones: the pair leaves `params` where JAX's
   `params + updates` leaves them, without a table-sized difference.
3. `split_sparse(grads) -> (dense, sparse)` carves a grads nest into its
   dense and sparse parts with None holes (a `torch.optim` optimizer for
   the towers, the fused path for the tables); `merge_sparse` puts them
   back together.

Where the torch meaning is not JAX's, one to one (ROADMAP.md queue 3): a
sparse leaf's update is applied by `update` and comes back as None, where
JAX returns the table-sized `new - p`; `apply_updates` writes in place;
`merge_sparse` is named by JAX's docstring and defined here as the inverse
of `split_sparse` (JAX's module has no such function).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .ops.sparse_update import SparseEmbeddingUpdate
from .optim import SparseOptState, SparseSGD


class GradientTransformation(NamedTuple):
    """`(init, update)`, the shape of an optax transformation."""

    init: Any
    update: Any


def _is_node(x) -> bool:
    """Dicts, lists and plain tuples are nodes; NamedTuples (optimizer
    states) and everything else are leaves."""
    return isinstance(x, (dict, list)) or (
        isinstance(x, tuple) and not hasattr(x, "_fields"))


def _map(fn, tree, *rest):
    """`fn(leaf, *matching leaves)` over `tree`'s leaves, the other trees
    read at the same positions; the result has `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class _Out:
    """One leaf's `(update, state)`, a leaf of `_map` itself."""

    def __init__(self, update, state):
        self.update, self.state = update, state


def sparse_gradient_transform(sparse_opt=None) -> GradientTransformation:
    """The fused sparse update on `SparseEmbeddingUpdate` leaves and plain
    SGD on dense leaves (module docstring). `init(params)`: `sparse_opt`'s
    state for every 2-D tensor (a table, or a tower matrix whose state is
    never used), an empty `SparseOptState` elsewhere. `update` needs
    `params` (the tables)."""
    sparse_opt = sparse_opt or SparseSGD()

    def init(params):
        def leaf_state(p):
            if torch.is_tensor(p) and p.dim() == 2:
                return sparse_opt.init(p)
            return SparseOptState(accum=torch.zeros((0,)))
        return _map(leaf_state, params)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError(
                "sparse_gradient_transform requires params (the tables)")

        def one(g, s, p):
            if isinstance(g, SparseEmbeddingUpdate):
                _, s = sparse_opt.apply(p, g, s)
                return _Out(None, s)
            lr = getattr(sparse_opt, "lr", 0.01)
            return _Out(None if g is None else -lr * g, s)

        out = _map(one, grads, state, params)
        return _map(lambda o: o.update, out), _map(lambda o: o.state, out)

    return GradientTransformation(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates):
    """`p <- (p + u)` in `p`'s dtype, in place, for every tensor update
    (None: nothing to add, as for a sparse leaf `update` already applied).
    Returns `params`."""
    def one(p, u):
        if u is not None:
            p.copy_((p + u).to(p.dtype))
        return p
    return _map(one, params, updates)


def split_sparse(grads):
    """`(dense_only, sparse_only)`: the grads nest twice, with None where
    the other kind of leaf was."""
    dense = _map(lambda g: None if isinstance(g, SparseEmbeddingUpdate)
                 else g, grads)
    sparse = _map(lambda g: g if isinstance(g, SparseEmbeddingUpdate)
                  else None, grads)
    return dense, sparse


def merge_sparse(dense, sparse):
    """The inverse of `split_sparse`: each position's non-None leaf."""
    return _map(lambda d, s: s if d is None else d, dense, sparse)
