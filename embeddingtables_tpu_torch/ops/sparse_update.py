"""Lazy sparse gradients and the fused sparse-SGD update (counterpart of
`embeddingtables_tpu/ops/sparse_update.py`).

  - The cotangent of a lookup is `(delta, indices[, weights])`: no scatter
    happens at pullback time.
  - Duplicate ids accumulate; the update writes each unique row once.
  - SGD: `table[r] -= lr * sum over the occurrences of r of delta`.

`sgd_update` accepts the JAX method names (`auto`, `scatter`, `dedup`,
`pallas`); all four compute the same contract, the one-write-per-unique-row
run-scatter of `ops/cuda/scatter.py` (its kernel on a CUDA table, its plain
version on a CPU table). The rows are always the update's own ids; an
`IndexerView` turns the occurrences of the groups outside it into padding.
Ids follow JAX's `.at[]` contract: `[-V, 0)` wraps, any other out-of-range
id is dropped. Updates happen in place: the port's counterpart of JAX's
donated buffers.

`ensemble_sgd_update` and `ensemble_update` update many tables; a stateful
optimizer on a `SplitEmbedding` runs shard by shard
(`_split_stateful_apply`), never on the materialized table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..tables import SimpleEmbedding, SplitEmbedding, as_table
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
    if upd.indices.dim() not in (1, 2):
        raise ValueError("indices must be 1-D or 2-D, got shape "
                         f"{tuple(upd.indices.shape)}")
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


def view_rows(rows: torch.Tensor, view, idx_result=None) -> torch.Tensor:
    """`rows` with the occurrences of the groups outside `view`'s
    `[lo, hi)` made padding (-1); the groups are those of `idx_result`,
    else of the view's parent."""
    ir = view.parent if idx_result is None else idx_result
    dev = rows.device
    group = ir.group_of.to(dev)
    inside = (group >= view.lo.to(dev)) & (group < view.hi.to(dev))
    return torch.where(inside, rows, -1)


def sgd_update(table, upd: SparseEmbeddingUpdate, lr, *, indexer=None,
               idx_result=None, view=None, method: str | None = None):
    """Fused sparse SGD step on a `SimpleEmbedding` or a raw `(V, D)` tensor,
    in place; returns `table`. `table[r] -= lr * sum of the deltas of r`,
    one write per unique row through the run-scatter. Protocol tables go
    through their own `scatter_apply(rows, -lr * vals)`.

    method: None or one of "auto", "scatter", "dedup", "pallas" (the JAX
    names; all compute the same contract here). `indexer` and `idx_result`
    name JAX's dedup realization; the run-scatter dedups by itself, so the
    rows are always the update's own ids. Only `view` reads an indexer
    result (`idx_result`, else the view's parent): it restricts the update
    to one slice of the unique rows, so the updates of all the slices of a
    result add up to the whole update."""
    method = method or "auto"
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    t = as_table(table)
    rows, vals = occurrence_values(upd)
    if not isinstance(t, SimpleEmbedding):
        return table.scatter_apply(rows, -lr * vals)
    data = t.data
    rows = resolve_rows(rows, data.shape[0])
    if view is not None:
        rows = view_rows(rows, view, idx_result)
    scatter_update(data, rows.to(data.device),
                   vals.to(data.device, torch.float32), -float(lr))
    return table


def _split_stateful_apply(opt, t: SplitEmbedding, u: SparseEmbeddingUpdate,
                          state):
    """A stateful optimizer on a `SplitEmbedding`, shard by shard, without
    materializing the `(V, D)` table: extra memory is one shard.

    Each shard's apply sees the whole occurrence stream. Occurrences of
    other shards go to ONE padding row appended to the shard (with fresh
    zero state), which is cut off after the apply: a zero-delta touch still
    advances a stateful optimizer (lazy Adam decays a touched row's
    moments), so they may not be masked onto row 0.

    `state` is the whole table's state: leaves whose leading dim is the
    vocabulary are row-wise and sliced per shard; any other leaf (Adam's
    `count`) goes whole to every shard and comes back from the first. The
    shards and the row-wise state are updated in place."""
    vocab, dim = t.spec.vocab, t.spec.dim
    rps = t.rows_per_shard
    shard_of = torch.div(u.indices.long(), rps, rounding_mode="floor")

    def rowwise(leaf):
        return leaf.dim() >= 1 and leaf.shape[0] == vocab and vocab > 1

    first = None
    for si, shard in enumerate(t.shards):
        lo, nrows, dev = si * rps, shard.shape[0], shard.device
        lidx = torch.where(shard_of == si, u.indices.long() - lo, nrows)
        lupd = SparseEmbeddingUpdate(
            delta=u.delta.to(dev), indices=lidx.to(dev, torch.int32),
            weights=None if u.weights is None else u.weights.to(dev))
        sdata = torch.cat([shard, shard.new_zeros((1, dim))])
        sstate = type(state)(*[
            torch.cat([leaf[lo:lo + nrows].to(dev),
                       leaf.new_zeros((1,) + leaf.shape[1:], device=dev)])
            if rowwise(leaf) else leaf.clone() for leaf in state])
        sdata, ns = opt.apply(sdata, lupd, sstate)
        shard.copy_(sdata[:nrows])
        for leaf, new in zip(state, ns):
            if rowwise(leaf):
                leaf[lo:lo + nrows].copy_(new[:nrows])
        if first is None:
            first = ns
    new_state = type(state)(*[leaf if rowwise(leaf) else f
                              for leaf, f in zip(state, first)])
    return t, new_state


def ensemble_update(opt, tables: Sequence, upds: Sequence[SparseEmbeddingUpdate],
                    states: Sequence | None = None, *, telemetry_cb=None):
    """Multi-table sparse update with any sparse optimizer of `optim`;
    returns `(tables, states)`. Tables and states are updated in place.
    `telemetry_cb` fires between building the states and applying the
    updates. Protocol tables take plain stateless SGD through their
    `scatter_apply`; a `SplitEmbedding` takes any other optimizer shard by
    shard; anything else on another protocol table raises."""
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
            if plain:
                rows, vals = occurrence_values(u)
                nt = t.scatter_apply(rows, -opt.lr * vals)
                ns = s
            elif isinstance(t, SplitEmbedding):
                nt, ns = _split_stateful_apply(opt, t, u, s)
            else:
                raise TypeError(
                    f"{type(opt).__name__} is stateful or regularized; "
                    f"applying it through {type(t).__name__}'s scatter "
                    "protocol would silently degrade to plain SGD. Use a "
                    "SimpleEmbedding or a SplitEmbedding.")
        new_tables.append(nt)
        new_states.append(ns)
    return new_tables, new_states


def ensemble_sgd_update(tables: Sequence, upds: Sequence[SparseEmbeddingUpdate],
                        lr, *, indexer=None, num_splits: int = 4,
                        telemetry_cb=None, method: str | None = None):
    """Multi-table sparse SGD, in place; returns the tables. JAX's phase 1
    indexes every table under "dedup" and "pallas"; here it has no work,
    because the run-scatter dedups each table's ids itself and nothing reads
    an indexer result without a view. `telemetry_cb` fires, then each
    table's update is applied. `indexer` and `num_splits` are accepted for
    the JAX signature: the run-scatter already gives each unique row one
    writer."""
    if len(tables) != len(upds):
        raise ValueError("tables and updates must have equal length")
    if telemetry_cb is not None:
        telemetry_cb()
    return [sgd_update(t, u, lr, method=method) for t, u in zip(tables, upds)]
