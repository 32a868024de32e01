"""Indexer: deduplication of a gradient's ids into a CSR-like structure
(counterpart of `embeddingtables_tpu/ops/indexer.py`).

  - `SparseIndexer`: a stable sort of the id stream, O(n log n), independent
    of the vocabulary.
  - `DenseIndexer`: the same result (JAX builds it from a vocabulary-sized
    histogram); it needs the vocabulary.
  - `flatten_indices`: `(B,)` or `(B, bag)` ids -> per-occurrence
    `(rows, cols)` streams; with bags one delta row (column) fans out to
    every id of its bag, in column-major bag order.
  - `IndexerView` / `indexer_view`: a contiguous slice of the unique-row
    range, so writers of different slices never touch one row.

Contract: unique rows are ordered by their first position in the stream,
and within a row the occurrences keep stream order. Every array is padded
to `n` (the number of occurrences, the most unique rows there can be);
`num_unique` is a 0-d int32 tensor and `unique[num_unique:]` is -1.

Everything is integer tensor work on the ids' device (a stable sort,
`scatter_reduce` with `amin`/`amax`, `index_add_`, `cumsum`, `argsort`): no
kernel, and nothing that waits for the device (no `bincount`, no boolean
mask), so a CUDA stream of many tables' indexers queues without a stall.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class IndexerResult:
    """With `n` the number of occurrences, all int32:

    unique:     (n,) unique ids in first-occurrence order, then -1.
    num_unique: () the number of unique ids.
    offsets:    (n+1,) the occurrences of `unique[g]` are
                `map[offsets[g]:offsets[g+1]]`.
    map:        (n,) occurrence -> gradient column, grouped by unique id,
                stream order within an id.
    group_of:   (n,) the group of each occurrence, in stream order.
    """

    unique: torch.Tensor
    num_unique: torch.Tensor
    offsets: torch.Tensor
    map: torch.Tensor
    group_of: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.unique.shape[0]


def flatten_indices(indices):
    """`(B,)` or `(B, bag)` ids -> int32 `(rows, cols)` per occurrence, where
    `cols[o]` is the delta row that occurrence `o` fans out from; the stream
    runs through the bag of output 0, then output 1, ..."""
    indices = torch.as_tensor(indices)
    if indices.dim() == 1:
        cols = torch.arange(indices.shape[0], dtype=torch.int32,
                            device=indices.device)
        return indices.to(torch.int32), cols
    if indices.dim() == 2:
        b, bag = indices.shape
        cols = torch.arange(b, dtype=torch.int32, device=indices.device)
        return (indices.reshape(-1).to(torch.int32),
                torch.repeat_interleave(cols, bag))
    raise ValueError(
        f"indices must be 1-D or 2-D, got shape {tuple(indices.shape)}")


def _index_from_value_groups(rows, cols, gid_val, perm, is_start, sorted_rows):
    """From value-ordered group ids over the sorted stream: re-rank the
    groups by first occurrence and build the CSR structure."""
    n = rows.shape[0]
    dev = rows.device
    arange = torch.arange(n, device=dev)
    num_unique = is_start.sum().to(torch.int32)
    gid_val = gid_val.long()
    # First stream position of each value group (scatter-min; the stable
    # sort keeps `perm` ascending within a group). Padding groups keep n.
    firstpos = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid_val, perm, "amin")
    # Insertion rank of each value group: groups sorted by first position.
    rank = torch.argsort(torch.argsort(firstpos, stable=True), stable=True)
    gid_ins = rank[gid_val]                        # sorted occurrence -> group
    unique = torch.full((n,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, gid_ins, sorted_rows, "amax")
    unique = torch.where(arange < num_unique, unique, -1)
    counts = torch.zeros((n,), dtype=torch.int64, device=dev).index_add_(
        0, gid_ins, torch.ones_like(gid_ins))
    offsets = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    # Position of each sorted occurrence inside its group (stream order kept
    # by the stable sort), then its gradient column to the CSR slot.
    start = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid_val, arange, "amin")
    dest = offsets[gid_ins] + arange - start[gid_val]
    map_ = torch.zeros((n,), dtype=torch.int32, device=dev)
    map_[dest] = cols[perm]
    group_of = torch.zeros((n,), dtype=torch.int32, device=dev)
    group_of[perm] = gid_ins.to(torch.int32)
    return IndexerResult(unique=unique, num_unique=num_unique,
                         offsets=offsets.to(torch.int32), map=map_,
                         group_of=group_of)


def _empty(device) -> IndexerResult:
    z = torch.zeros((0,), dtype=torch.int32, device=device)
    return IndexerResult(unique=z, num_unique=torch.zeros((), dtype=torch.int32,
                                                          device=device),
                         offsets=torch.zeros((1,), dtype=torch.int32,
                                             device=device),
                         map=z, group_of=z)


@dataclasses.dataclass(frozen=True)
class SparseIndexer:
    """Sort-based dedup, independent of the vocabulary size."""

    def __call__(self, indices, vocab: int | None = None) -> IndexerResult:
        rows, cols = flatten_indices(indices)
        if rows.numel() == 0:
            return _empty(rows.device)
        sorted_rows, perm = torch.sort(rows, stable=True)
        is_start = torch.ones_like(sorted_rows, dtype=torch.bool)
        is_start[1:] = sorted_rows[1:] != sorted_rows[:-1]
        gid_val = torch.cumsum(is_start, 0) - 1
        return _index_from_value_groups(rows, cols, gid_val, perm, is_start,
                                        sorted_rows)


@dataclasses.dataclass(frozen=True)
class DenseIndexer:
    """The JAX package's vocabulary-sized histogram indexer. Its result is
    `SparseIndexer`'s on every stream, ids outside `[0, vocab)` included,
    so it runs the sort path; it keeps the rule that it needs `vocab`."""

    def __call__(self, indices, vocab: int) -> IndexerResult:
        return SparseIndexer()(indices, vocab)


# The default indexer is the sort-based one.
Indexer = SparseIndexer


def index(indices, vocab: int | None = None,
          indexer: SparseIndexer | DenseIndexer | None = None) -> IndexerResult:
    """The dedup structure of an id container (default `SparseIndexer`)."""
    if indexer is None:
        indexer = SparseIndexer()
    if isinstance(indexer, DenseIndexer) and vocab is None:
        raise ValueError("DenseIndexer requires vocab")
    return indexer(indices, vocab)


@dataclasses.dataclass
class IndexerView:
    """Unique groups `[lo, hi)` of `parent`: one writer's share of a table's
    update (0-d int32 tensors)."""

    parent: IndexerResult
    lo: torch.Tensor
    hi: torch.Tensor


def cdiv_dynamic(a, b):
    return -(-a // b)


def indexer_view(result: IndexerResult, num_splits: int, j: int) -> IndexerView:
    """Chunk `j` of the unique range cut into `num_splits` chunks of
    `cdiv(num_unique, num_splits)` groups."""
    per = cdiv_dynamic(result.num_unique, num_splits)
    lo = torch.minimum(per * j, result.num_unique)
    hi = torch.minimum(per * (j + 1), result.num_unique)
    return IndexerView(parent=result, lo=lo, hi=hi)
