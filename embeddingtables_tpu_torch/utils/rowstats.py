"""Row lifecycle: frequency tracking, stale-row eviction and
frequency-ordered relayout (counterpart of
`embeddingtables_tpu/utils/rowstats.py`).

  - `FrequencyTracker`: host-side exponentially decayed per-row counts, fed
    from the host batches the input pipeline already holds (numpy, the JAX
    package's code).
  - Eviction: `evict_rows` reinitializes rows that went cold and
    `reset_rows_state` zeroes their optimizer state; `evict_rows_sharded`
    zeroes both on the rank that owns them in a mod-row-sharded table.
  - Frequency ordering: `relayout` puts hot rows first; the loader maps
    incoming ids through `inverse_permutation` (`remap_batch`).

The tensor operations update in place and return what they updated (the
port's counterpart of JAX's functional updates). Ids follow JAX's
`.at[].set(mode="drop")`: an id in `[-V, 0)` wraps, any other out-of-range
id is dropped, and of duplicate ids the first occurrence's value is written.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.sparse_update import resolve_rows


class FrequencyTracker:
    """Exponentially decayed per-row occurrence counts for one table.

    decay: per-observation multiplier on the running EMA (0.99 with one
    `observe()` a step is a window of about 100 steps). Counts are raw
    occurrence sums within a batch, so hot rows accumulate fast.
    """

    def __init__(self, vocab: int, decay: float = 0.99):
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        self.vocab = vocab
        self.decay = decay
        self.counts = np.zeros(vocab, np.float64)
        self.seen = np.zeros(vocab, bool)   # appeared since last eviction
        self.observations = 0

    def observe(self, indices) -> None:
        """Fold one batch of ids (any shape; a host array)."""
        flat = np.asarray(indices).reshape(-1)
        self.counts *= self.decay
        self.counts += np.bincount(flat, minlength=self.vocab).astype(
            np.float64)
        self.seen[flat] = True
        self.observations += 1

    def top_rows(self, k: int) -> np.ndarray:
        """Ids of the k most frequent rows, hottest first."""
        k = min(k, self.vocab)
        if k <= 0:
            return np.zeros(0, np.int32)
        part = np.argpartition(self.counts, -k)[-k:]
        return part[np.argsort(self.counts[part])[::-1]].astype(np.int32)

    def cold_rows(self, threshold: float) -> np.ndarray:
        """Ids that appeared since the last `pop_cold` and whose decayed
        count fell to or below `threshold`. Never-seen and already-evicted
        rows are left out: they sit at their init values."""
        return np.nonzero(self.seen & (self.counts <= threshold))[0].astype(
            np.int32)

    def pop_cold(self, threshold: float) -> np.ndarray:
        """`cold_rows`, marked unseen so that the next interval evicts them
        again only if they reappear."""
        cold = self.cold_rows(threshold)
        self.seen[cold] = False
        return cold

    def frequency_permutation(self) -> np.ndarray:
        """(V,) permutation with `perm[rank] = old_id`, hottest first;
        `inverse_permutation(perm)[old_id] = rank` is what the loader
        applies to incoming ids after a relayout."""
        return np.argsort(-self.counts, kind="stable").astype(np.int32)

    def coverage(self, k: int) -> float:
        """Fraction of the (decayed) traffic covered by the top-k rows."""
        total = self.counts.sum()
        if total <= 0:
            return 0.0
        return float(np.sort(self.counts)[::-1][:k].sum() / total)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def _kept_rows(rows, v: int, device) -> tuple:
    """(distinct rows to write, int64, and the position of each one's first
    occurrence in `rows`) under `.at[].set(mode="drop")`'s id contract."""
    r = resolve_rows(torch.as_tensor(rows).to(device).reshape(-1), v).long()
    n = r.numel()
    pos = torch.arange(n, device=device)
    keep = r >= 0
    r, pos = r[keep], pos[keep]
    uniq, inv = torch.unique(r, return_inverse=True)
    first = torch.full((uniq.numel(),), n, dtype=torch.long,
                       device=device).scatter_reduce_(0, inv, pos, "amin")
    return uniq, first


def evict_rows(data: torch.Tensor, rows, *,
               init_fn: Optional[Callable] = None,
               generator: Optional[torch.Generator] = None,
               value: float = 0.0) -> torch.Tensor:
    """Reinitialize the given rows of a `(V, D)` table in place; returns it.

    `init_fn(generator, (n, D), dtype)` draws the replacements (pass
    `generator`); without it the rows are set to `value`. Duplicate and
    out-of-range ids are dropped (module docstring)."""
    n = int(torch.as_tensor(rows).numel())
    if n == 0:
        return data
    if init_fn is not None:
        if generator is None:
            raise ValueError("init_fn needs a generator")
        fresh = init_fn(generator, (n, data.shape[1]), data.dtype)
    else:
        fresh = torch.full((n, data.shape[1]), value, dtype=data.dtype,
                           device=data.device)
    uniq, first = _kept_rows(rows, data.shape[0], data.device)
    data.index_copy_(0, uniq, fresh.to(data.device)[first])
    return data


def reset_rows_state(state, rows):
    """Zero an optimizer state at evicted rows, in place; returns it.

    The JAX leaf rule: every tensor of the state whose leading dimension is
    more than 1 is taken as vocab-indexed and zeroed at `rows` (row-wise
    AdaGrad's `(V,)` accumulator, lazy Adam's and FTRL's `(V, D)` moments);
    scalars (Adam's `count`) and SGD's `(0,)` placeholder pass through. Zero
    state is the evicted fixed point of every built-in optimizer."""
    for leaf in state:
        if torch.is_tensor(leaf) and leaf.dim() >= 1 and leaf.shape[0] > 1:
            uniq, _ = _kept_rows(rows, leaf.shape[0], leaf.device)
            leaf.index_fill_(0, uniq, 0)
    return state


def evict_rows_sharded(tables, accum, global_rows):
    """Evict global rows of a mod-row-sharded table
    (`parallel.ShardedStackedTables`: global row r on the rank of index
    `r % n`, slot `r // n`), in place on the owning rank: the rows and
    their optimizer state cells are zeroed. Every rank calls it with the
    same rows; each zeroes the ones it owns (no collective). `accum` is any
    state `parallel.shard_row_accum` gives (AdaGrad's accumulator, Adam's
    moments, FTRL's z and n are zeroed at the evicted slots, to 0, not to
    `initial_accum`, as in JAX; Adam's count and SGD's empty placeholder
    pass through), or None. Ids whose slot is past the shard are dropped.
    Returns `(tables, accum)`."""
    ex, rps = tables.exchange, tables.rows_local
    rows = torch.as_tensor(np.asarray(global_rows) if not torch.is_tensor(
        global_rows) else global_rows).to(tables.data.device).long()
    rows = rows.reshape(-1)
    if not rows.numel():
        return tables, accum
    slots = torch.div(rows, ex.n, rounding_mode="floor")
    keep = (rows >= 0) & (torch.remainder(rows, ex.n) == ex.me) & \
        (slots < rps)
    slots = torch.unique(slots[keep])
    with torch.no_grad():
        tables.data.index_fill_(0, slots, 0)
        for leaf in (accum if accum is not None else ()):
            if torch.is_tensor(leaf) and leaf.dim() >= 1 and \
                    leaf.shape[0] == rps and leaf.numel():
                leaf.index_fill_(0, slots, 0)
    return tables, accum


def relayout(data: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """The rows reordered so that `new[rank] = old[perm[rank]]` (hot rows
    first under `FrequencyTracker.frequency_permutation`), as a new tensor.
    The loader must then map incoming ids through
    `inverse_permutation(perm)`."""
    return data.index_select(0, torch.as_tensor(
        np.asarray(perm), dtype=torch.long).to(data.device))


def remap_batch(cat: np.ndarray, inverse_perms: Sequence[np.ndarray]
                ) -> np.ndarray:
    """Apply per-table id remaps to a `(T, B[, bag])` host batch: the
    loader's half of a relayout."""
    out = np.empty_like(cat)
    for t in range(cat.shape[0]):
        out[t] = inverse_perms[t][cat[t]]
    return out
