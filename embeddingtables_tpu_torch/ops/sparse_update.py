"""Lazy sparse gradients and the fused sparse-SGD update (counterpart of
`embeddingtables_tpu/ops/sparse_update.py`).

  - The cotangent of a lookup is `(delta, indices[, weights])`: no scatter
    happens at pullback time.
  - Duplicate ids accumulate; the update writes each unique row once.
  - SGD: `table[r] -= lr * sum over the occurrences of r of delta`.

`sgd_update` accepts the JAX method names (`auto`, `scatter`, `dedup`,
`pallas`); all four compute the same contract, the one-write-per-unique-row
run-scatter of `ops/cuda/scatter.py` (its kernel on a CUDA table, its plain
version on a CPU table). Ids follow JAX's `.at[]` contract: `[-V, 0)` wraps,
any other out-of-range id is dropped. Updates happen in place: the port's
counterpart of JAX's donated buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..tables import SimpleEmbedding, as_table
from .cuda.scatter import scatter_update

_METHODS = ("auto", "scatter", "dedup", "pallas")


@dataclasses.dataclass
class SparseEmbeddingUpdate:
    """Lazy lookup cotangent.

    delta:   `(B, dim)` per-output gradient rows.
    indices: the lookup's ids, `(B,)` (non-reducing) or `(B, bag)` (one delta
             row fans out to every id of its bag).
    weights: optional per-occurrence scale (`(B,)` or `(B, bag)`), carrying
             weighted, mean and padded bags.
    """

    delta: torch.Tensor
    indices: torch.Tensor
    weights: Optional[torch.Tensor] = None

    @property
    def reducing(self) -> bool:
        return self.indices.dim() == 2


def occurrence_values(upd: SparseEmbeddingUpdate) -> tuple:
    """Per-occurrence `(rows int32, values)` streams: bag deltas repeat once
    per occurrence, weights scale in the same pass."""
    vals = upd.delta
    if upd.indices.dim() == 2:
        vals = torch.repeat_interleave(vals, upd.indices.shape[1], dim=0)
    if upd.weights is not None:
        vals = vals * upd.weights.reshape(-1, 1).to(vals.dtype)
    return upd.indices.reshape(-1).to(torch.int32), vals


def accumulate_updates(upds: Sequence[SparseEmbeddingUpdate]
                       ) -> SparseEmbeddingUpdate:
    """Merge K lazy updates into one by concatenation (gradient
    accumulation): no scatter and no table-sized buffer. Mixed bag widths
    are refused; missing weights become ones when others have weights."""
    if len(upds) == 1:
        return upds[0]
    ndims = {u.indices.dim() for u in upds}
    if len(ndims) != 1:
        raise ValueError("cannot merge reducing and non-reducing updates")
    if ndims == {2} and len({u.indices.shape[1] for u in upds}) != 1:
        raise ValueError("bag widths differ; pad to a common width first")
    delta = torch.cat([u.delta for u in upds], dim=0)
    indices = torch.cat([u.indices for u in upds], dim=0)
    weights = None
    if any(u.weights is not None for u in upds):
        weights = torch.cat(
            [u.weights if u.weights is not None
             else torch.ones(u.indices.shape, dtype=torch.float32,
                             device=u.indices.device) for u in upds], dim=0)
    return SparseEmbeddingUpdate(delta=delta, indices=indices,
                                 weights=weights)


def uncompress(upd: SparseEmbeddingUpdate, num_rows: int,
               dtype=None) -> torch.Tensor:
    """Scatter-add the lazy update into a dense `(num_rows, dim)` matrix: the
    test oracle. Ids follow JAX's `.at[].add`: `[-V, 0)` wraps, others are
    dropped."""
    rows, vals = occurrence_values(upd)
    return dense_scatter(rows, vals if dtype is None else vals.to(dtype),
                         num_rows)


def dense_scatter(rows: torch.Tensor, vals: torch.Tensor,
                  num_rows: int) -> torch.Tensor:
    """`zeros((num_rows, D)).at[rows].add(vals)` in `vals`' dtype, with
    `.at[]`'s ids (`resolve_rows`): dropped ids go to a spare row that is
    cut off."""
    safe = resolve_rows(rows, num_rows).long()
    dense = torch.zeros((num_rows + 1, vals.shape[-1]), dtype=vals.dtype,
                        device=vals.device)
    dense.index_add_(0, torch.where(safe < 0, num_rows, safe), vals)
    return dense[:num_rows]


def resolve_rows(rows: torch.Tensor, v: int) -> torch.Tensor:
    """int32 rows under JAX's `.at[]` contract: an id in `[-V, 0)` wraps to
    `id + V`, any other out-of-range id becomes -1 (the run-scatter's
    padding)."""
    r = rows.long()
    r = torch.where(r < 0, r + v, r)
    return torch.where((r >= 0) & (r < v), r, -1).to(torch.int32)


def sgd_update(table, upd: SparseEmbeddingUpdate, lr, *, indexer=None,
               idx_result=None, view=None, method: str | None = None):
    """Fused sparse SGD step on a `SimpleEmbedding` or a raw `(V, D)` tensor,
    in place; returns `table`. `table[r] -= lr * sum of the deltas of r`,
    one write per unique row through the run-scatter. Protocol tables go
    through their own `scatter_apply(rows, -lr * vals)`.

    method: None or one of "auto", "scatter", "dedup", "pallas" (the JAX
    names; all compute the same contract here). `indexer`, `idx_result` and
    `view` need the port's `ops/indexer.py`, which does not exist yet."""
    method = method or "auto"
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    if indexer is not None or idx_result is not None or view is not None:
        raise NotImplementedError(
            "indexer=, idx_result= and view= wait for the port's "
            "ops/indexer.py")
    t = as_table(table)
    rows, vals = occurrence_values(upd)
    if isinstance(t, SimpleEmbedding):
        data = t.data
        rows = resolve_rows(rows.to(data.device), data.shape[0])
        scatter_update(data, rows, vals.to(data.device, torch.float32),
                       -float(lr))
        return table
    return table.scatter_apply(rows, -lr * vals)


def ensemble_update(opt, tables: Sequence, upds: Sequence[SparseEmbeddingUpdate],
                    states: Sequence | None = None, *, telemetry_cb=None):
    """Multi-table sparse update with any sparse optimizer (`optim.SparseSGD`,
    `optim.SparseRowWiseAdaGrad`); returns `(tables, states)`. Tables and
    states are updated in place. `telemetry_cb` fires between building the
    states and applying the updates. Protocol tables take plain stateless
    SGD through their `scatter_apply`; anything else on them raises."""
    if len(tables) != len(upds):
        raise ValueError("tables and updates must have equal length")
    ts = [as_table(t) for t in tables]
    if states is None:
        states = [opt.init(t.data if isinstance(t, SimpleEmbedding)
                           else t.rows(torch.arange(t.spec.vocab,
                                                    device=t.example().device)))
                  for t in ts]
    if telemetry_cb is not None:
        telemetry_cb()
    new_tables, new_states = [], []
    for t, u, s in zip(ts, upds, states):
        if isinstance(t, SimpleEmbedding):
            t.data, ns = opt.apply(t.data, u, s)
            nt = t
        else:
            # A protocol table exposes only a scatter: right for plain
            # stateless SGD (a linear update), wrong for state or
            # regularization, which would silently degrade to plain SGD.
            accum = getattr(s, "accum", None)
            stateless = accum is not None and accum.numel() == 0
            plain = (stateless and hasattr(opt, "lr")
                     and getattr(opt, "weight_decay", 0.0) == 0.0
                     and getattr(opt, "clipnorm", None) is None)
            if not plain:
                raise TypeError(
                    f"{type(opt).__name__} is stateful or regularized; "
                    f"applying it through {type(t).__name__}'s scatter "
                    "protocol would silently degrade to plain SGD. Use a "
                    "SimpleEmbedding/SplitEmbedding, or "
                    "parallel.ShardedStackedTables for sharded tables.")
            rows, vals = occurrence_values(u)
            nt = t.scatter_apply(rows, -opt.lr * vals)
            ns = s
        new_tables.append(nt)
        new_states.append(ns)
    return new_tables, new_states
