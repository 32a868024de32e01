"""Ensemble (multi-table) lookup (counterpart of
`embeddingtables_tpu/ops/ensemble.py`).

  - `maplookup([strategy], tables, indices)`: one lookup per table. The
    Default and SimpleParallel strategies return a list of `(B, dim_i)`
    outputs; `PreallocationStrategy(prependrows, dtype)` one fused
    `(B, prependrows + sum dim_i)` tensor whose first `prependrows` columns
    are zeros (reserved for the dense tower's output), cast to `dtype`
    after the gathers.
  - `maplookup_vjp`: the same, plus a lazy pullback to one
    `SparseEmbeddingUpdate` per table; the Preallocation pullback carves
    the fused delta with a `Slicer` that starts at `prependrows`.
  - Index containers (`normalize_indices`): a list of `(B,)` or `(B, bag)`
    tensors, or one `(T, B)` or `(T, B, bag)` tensor (slice t -> table t).
  - `StackedTables`: N same-width tables concatenated along the vocab axis
    into one `(sum vocab_i, dim)` tensor with per-table row offsets, so an
    ensemble lookup is ONE gather with offset-shifted ids.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..tables import SimpleEmbedding, as_table
from ..types import featuresize
from .cuda.gather import BagLayout
from .lookup import effective_weights, lookup
from .sparse_update import SparseEmbeddingUpdate


class StackedTables(nn.Module):
    """`data` is a buffer (the sparse optimizers update it outside autograd);
    `offsets` is the Python tuple of T+1 row offsets."""

    def __init__(self, data: torch.Tensor, offsets: Sequence[int], dim: int):
        super().__init__()
        self.register_buffer("data", data)
        self.offsets = tuple(int(o) for o in offsets)
        self.dim = dim
        self.register_buffer("_starts", torch.tensor(
            self.offsets[:-1], dtype=torch.int32, device=data.device),
            persistent=False)
        self._bag_layout = None

    @classmethod
    def stack(cls, tables: Sequence) -> "StackedTables":
        ts = [as_table(t) for t in tables]
        dims = {t.spec.dim for t in ts}
        if len(dims) != 1:
            raise ValueError(f"StackedTables requires equal feature dims, got {dims}")
        datas = [t.data if isinstance(t, SimpleEmbedding) else
                 t.rows(torch.arange(t.spec.vocab, device=t.example().device))
                 for t in ts]
        offs, acc = [0], 0
        for d in datas:
            acc += d.shape[0]
            offs.append(acc)
        return cls(torch.cat(datas, dim=0), tuple(offs), ts[0].spec.dim)

    @property
    def ntables(self) -> int:
        return len(self.offsets) - 1

    @property
    def vocabs(self) -> tuple:
        return tuple(self.offsets[i + 1] - self.offsets[i]
                     for i in range(self.ntables))

    def shift_indices(self, idx_list, bag_sizes=None) -> torch.Tensor:
        """Per-table local ids -> global rows of the stacked array, stacked
        to `(T, B[, bag])` int32. Accepts a sequence of T tensors or one
        `(T, B[, bag])` tensor. With `bag_sizes` (one width a table), one
        multi-hot `(S, B)` tensor whose slot rows belong to the tables in
        turn, `bag_sizes[t]` rows each (`bag_layout`)."""
        idx = torch.stack(list(idx_list)) if not torch.is_tensor(idx_list) \
            else idx_list
        idx = idx.to(device=self._starts.device, dtype=torch.int32)
        starts = self._starts if bag_sizes is None \
            else self.bag_layout(bag_sizes).starts
        return idx + starts.view(-1, *([1] * (idx.dim() - 1)))

    def bag_layout(self, bag_sizes) -> BagLayout:
        """The `BagLayout` of multi-hot batches with one bag width a table,
        each slot row shifted by its table's offset; built once, and again
        only for other widths or after the stack moves."""
        widths = tuple(int(w) for w in bag_sizes)
        lay, dev = self._bag_layout, self._starts.device
        if lay is None or lay.widths != widths or lay.meta.device != dev:
            if len(widths) != self.ntables:
                raise ValueError(f"need one bag width for each of the "
                                 f"{self.ntables} tables, got {widths}")
            lay = self._bag_layout = BagLayout(widths, dev, self._starts)
        return lay

    def table(self, t: int) -> SimpleEmbedding:
        return SimpleEmbedding(self.data[self.offsets[t]:self.offsets[t + 1]])


# ---------------------------------------------------------------------------
# Execution strategies
# ---------------------------------------------------------------------------

class AbstractExecutionStrategy:
    pass


@dataclasses.dataclass(frozen=True)
class DefaultStrategy(AbstractExecutionStrategy):
    """One lookup per table, in order."""


@dataclasses.dataclass(frozen=True)
class SimpleParallelStrategy(AbstractExecutionStrategy):
    """One lookup per table; the launches queue on the stream and the card
    runs them as it can."""


@dataclasses.dataclass(frozen=True)
class PreallocationStrategy(AbstractExecutionStrategy):
    """One fused output: `prependrows` zero columns first, then every
    table's features; `dtype` (a torch dtype) overrides the output dtype."""

    prependrows: int = 0
    dtype: Optional[torch.dtype] = None


# ---------------------------------------------------------------------------
# Index containers
# ---------------------------------------------------------------------------

def normalize_indices(indices, ntables: int) -> List[torch.Tensor]:
    """A list of per-table id tensors from a list/tuple of `(B,)` or
    `(B, bag)` ids, or one `(T, B)` or `(T, B, bag)` tensor or array."""
    if isinstance(indices, (list, tuple)):
        if len(indices) != ntables:
            raise ValueError(f"got {len(indices)} index sets for {ntables} tables")
        return [torch.as_tensor(i) for i in indices]
    arr = torch.as_tensor(indices)
    if arr.dim() not in (2, 3):
        raise ValueError(f"unsupported index container with ndim={arr.dim()}")
    if arr.shape[0] != ntables:
        raise ValueError(
            f"index array has leading dim {arr.shape[0]}, expected {ntables}")
    return list(arr.unbind(0))


def normalize_weights(weights, ntables: int) -> List[Optional[torch.Tensor]]:
    """Per-table bag weights: None, a list/tuple of per-table `(B, bag)`
    weights (None entries allowed), or one `(T, B, bag)` tensor."""
    if weights is None:
        return [None] * ntables
    if isinstance(weights, (list, tuple)):
        if len(weights) != ntables:
            raise ValueError(
                f"got {len(weights)} weight sets for {ntables} tables")
        return [None if w is None else torch.as_tensor(w) for w in weights]
    arr = torch.as_tensor(weights)
    if arr.dim() != 3 or arr.shape[0] != ntables:
        raise ValueError(
            f"weights array must be (T, B, bag) with T={ntables}, "
            f"got shape {tuple(arr.shape)}")
    return list(arr.unbind(0))


class Slicer:
    """Carves consecutive feature slices off the last axis: each call takes
    `width` columns at the running offset and advances it."""

    def __init__(self, start: int = 0, step: int = 1):
        self.offset = start
        self.step = step

    def __call__(self, width: int, arr: torch.Tensor) -> torch.Tensor:
        sl = arr[..., self.offset:self.offset + width]
        self.offset += width * self.step
        return sl


# ---------------------------------------------------------------------------
# maplookup
# ---------------------------------------------------------------------------

def _parse_args(a, b, c):
    if isinstance(a, AbstractExecutionStrategy):
        return a, b, c
    return DefaultStrategy(), a, b


def _fuse_outputs(strategy: PreallocationStrategy, outs):
    dtype = strategy.dtype or functools.reduce(
        torch.promote_types, [o.dtype for o in outs])
    pieces = []
    if strategy.prependrows:
        pieces.append(torch.zeros((outs[0].shape[0], strategy.prependrows),
                                  dtype=dtype, device=outs[0].device))
    pieces.extend(o.to(outs[0].device, dtype) for o in outs)
    return torch.cat(pieces, dim=-1)


def maplookup(strategy_or_tables, tables_or_indices=None, maybe_indices=None,
              *, combiner: str = "sum", weights=None,
              pad_idx: int | None = None):
    """`maplookup([strategy], tables, indices)`: a list of `(B, dim_i)`
    outputs (Default, SimpleParallel) or one fused tensor (Preallocation).
    `combiner`, `weights` (same containers as the ids) and `pad_idx` follow
    the single-table `lookup`. A `StackedTables` takes one gather for the
    whole ensemble."""
    strategy, tables, indices = _parse_args(strategy_or_tables,
                                            tables_or_indices, maybe_indices)
    if isinstance(tables, StackedTables):
        return _maplookup_stacked(strategy, tables, indices,
                                  combiner=combiner, weights=weights,
                                  pad_idx=pad_idx)
    tables = list(tables)
    idx = normalize_indices(indices, len(tables))
    w = normalize_weights(weights, len(tables))
    outs = [lookup(t, i, combiner=combiner, weights=wt, pad_idx=pad_idx)
            for t, i, wt in zip(tables, idx, w)]
    if isinstance(strategy, PreallocationStrategy):
        return _fuse_outputs(strategy, outs)
    return outs


def maplookup_vjp(strategy_or_tables, tables_or_indices=None,
                  maybe_indices=None, *, combiner: str = "sum", weights=None,
                  pad_idx: int | None = None) -> Tuple[object, Callable]:
    """`maplookup` plus the lazy pullback to one `SparseEmbeddingUpdate` per
    table (no scatter). Default/SimpleParallel: `pullback(deltas)` takes one
    `(B, dim_i)` delta per table; Preallocation: `pullback(delta)` takes the
    fused delta and carves it with a `Slicer(prependrows)`. Combiners,
    weights and pads fold into each update's weights."""
    strategy, tables, indices = _parse_args(strategy_or_tables,
                                            tables_or_indices, maybe_indices)
    out = maplookup(strategy, tables, indices, combiner=combiner,
                    weights=weights, pad_idx=pad_idx)
    if isinstance(tables, StackedTables):
        ntables = tables.ntables
        dims = [tables.dim] * ntables
        devices = [tables.data.device] * ntables
    else:
        ntables = len(tables)
        dims = [featuresize(as_table(t)) for t in tables]
        devices = [as_table(t).example().device for t in tables]
    idx = [i.to(dev, torch.int32)
           for i, dev in zip(normalize_indices(indices, ntables), devices)]
    w = normalize_weights(weights, ntables)
    effs = [effective_weights(i, combiner, wt, pad_idx)
            for i, wt in zip(idx, w)]

    if isinstance(strategy, PreallocationStrategy):
        def pullback(delta: torch.Tensor) -> List[SparseEmbeddingUpdate]:
            slicer = Slicer(strategy.prependrows)
            return [SparseEmbeddingUpdate(delta=slicer(d, delta), indices=i,
                                          weights=e)
                    for d, i, e in zip(dims, idx, effs)]
    else:
        def pullback(deltas) -> List[SparseEmbeddingUpdate]:
            return [SparseEmbeddingUpdate(delta=d, indices=i, weights=e)
                    for d, i, e in zip(deltas, idx, effs)]

    return out, pullback


def _maplookup_stacked(strategy, st: StackedTables, indices, *,
                       combiner: str = "sum", weights=None,
                       pad_idx: int | None = None):
    """The ensemble lookup as one gather on the stacked tensor. Pads are
    found before the offset shift (a shifted pad no longer matches the
    sentinel) and remapped to local row 0; then their weight is 0 (bags) or
    their gathered row is multiplied by 0 (one id per output)."""
    dev = st.data.device
    idx = [i.to(dev) for i in normalize_indices(indices, st.ntables)]
    pad_mask_1d = None
    if pad_idx is not None:
        valid = [i != pad_idx for i in idx]
        idx = [torch.where(v, i, 0) for v, i in zip(valid, idx)]
        w0 = normalize_weights(weights, st.ntables)
        if idx[0].dim() == 2:
            weights = [v.float() if wt is None
                       else wt.to(dev, torch.float32) * v.float()
                       for v, wt in zip(valid, w0)]
        else:
            pad_mask_1d = torch.stack([v.float() for v in valid])  # (T, B)
    g = st.shift_indices(idx)                     # (T, B) or (T, B, bag)
    w = normalize_weights(weights, st.ntables)
    flat_w = None
    if g.dim() == 2:
        flat = g.reshape(-1)
    else:
        flat = g.reshape(-1, g.shape[-1])
        if any(wt is not None for wt in w):
            flat_w = torch.cat(
                [wt.to(dev) if wt is not None
                 else torch.ones(g.shape[1:], dtype=torch.float32, device=dev)
                 for wt in w], dim=0)
    out = lookup(SimpleEmbedding(st.data), flat, combiner=combiner,
                 weights=flat_w)                  # (T*B, dim) in ONE gather
    if pad_mask_1d is not None:
        out = out * pad_mask_1d.reshape(-1, 1).to(out.dtype)
    b = g.shape[1]
    per_table = out.reshape(st.ntables, b, st.dim)
    if isinstance(strategy, PreallocationStrategy):
        dtype = strategy.dtype or out.dtype
        fused = per_table.permute(1, 0, 2).reshape(b, st.ntables * st.dim)
        if strategy.prependrows:
            fused = torch.cat(
                [torch.zeros((b, strategy.prependrows), dtype=dtype,
                             device=dev), fused.to(dtype)], dim=-1)
        return fused.to(dtype)
    return list(per_table.unbind(0))
