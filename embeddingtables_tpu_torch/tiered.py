"""Tiered embedding tables: the hot head on the card, the cold tail in pinned
host memory (counterpart of `embeddingtables_tpu/tiered.py`).

With skewed (Zipf) traffic a small hot set serves most lookups, so those rows
stay in device memory and the long tail in host memory. After
`utils.rowstats.relayout` under a frequency permutation the hottest rows are
ids `[0, hot_rows)`, so the tier of an id is one compare, `idx < hot_rows`.
`retier()` re-splits the table under a new permutation as traffic drifts.

Ids are clamped into `[0, V-1]`, the table's own contract as in JAX.
Forward: each tier gathers the whole id stream with the other tier's
occurrences pointed at its row 0, the hot tier through `gather_rows` (the
hand kernel on the card) and the cold tier on the host into a pinned staging
buffer (`offload.host_rows`), and one `where` on the compare picks; only
`(B, D)` rows cross PCIe. Update: the delta adds into both tiers, each with
the other tier's occurrences turned into an out-of-range id that the add
drops (JAX's `mode="drop"` sentinels).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .offload import _host_tensor, host_put, host_rows
from .tables import SimpleEmbedding, _as_spec, normal, take_rows
from .types import TableSpec


@dataclasses.dataclass
class TieredEmbedding:
    """`(vocab, dim)` table split at `hot_rows`: rows `[0, hot_rows)` on the
    card, rows `[hot_rows, vocab)` in pinned host memory (a plain host
    tensor when the hot tier is on the CPU).

    Implements the table protocol (`spec`, `rows`, `example`), so `lookup`,
    `lookup_vjp`, `maplookup` and `sgd_update` take it. Pair it with
    `utils.rowstats` so that the hot ids are the low ids."""

    hot: torch.Tensor        # (hot_rows, dim), on the device
    cold: torch.Tensor       # (vocab - hot_rows, dim), host
    spec: TableSpec
    hot_rows: int

    @classmethod
    def from_array(cls, data, hot_rows: int, *, name: Optional[str] = None,
                   device=None) -> "TieredEmbedding":
        """The table of `data` (a tensor or a numpy array; the tiers are
        copies) with its hot tier on `device` (CUDA unless given)."""
        device = resolve_device(device)
        data = _host_tensor(data)
        spec = _as_spec(data, None, name)
        if not 0 < hot_rows < spec.vocab:
            raise ValueError(
                f"hot_rows must be in (0, vocab={spec.vocab}), got {hot_rows}")
        hot = data[:hot_rows].to(device, copy=True)
        cold = host_put(data[hot_rows:], device)
        return cls(hot=hot, cold=cold, spec=spec, hot_rows=hot_rows)

    @classmethod
    def create(cls, generator, vocab: int, dim: int, hot_rows: int, *,
               dtype=torch.float32, name: Optional[str] = None,
               device=None) -> "TieredEmbedding":
        """Random tiered table, rows `N(0, 1/dim)` drawn on `device` (CUDA
        unless given) from `generator`."""
        data = normal(generator, (vocab, dim), dtype, device) / (dim ** 0.5)
        return cls.from_array(data, hot_rows, name=name, device=data.device)

    @property
    def shape(self):
        return (self.spec.vocab, self.spec.dim)

    @property
    def dtype(self):
        return self.spec.dtype

    def example(self) -> torch.Tensor:
        return self.hot

    def _split(self, idx):
        """(clamped ids on the device, the hot mask)."""
        idx = torch.as_tensor(idx).to(self.hot.device)
        idx = idx.clamp(0, self.spec.vocab - 1)
        return idx, idx < self.hot_rows

    def rows(self, idx, context=None) -> torch.Tensor:
        """Tier-routed gather: `(*idx.shape, dim)` on the hot tier's
        device."""
        idx, is_hot = self._split(idx)
        hot_got = take_rows(self.hot, torch.where(is_hot, idx, 0))
        cold_idx = torch.where(is_hot, 0, idx - self.hot_rows)
        cold_got = host_rows(self.cold, cold_idx.to("cpu"),
                             self.hot.device).reshape(hot_got.shape)
        return torch.where(is_hot[..., None], hot_got, cold_got)

    def scatter_apply(self, idx, delta: torch.Tensor) -> "TieredEmbedding":
        """Duplicate-accumulating add, tier-routed and in place: the hot
        rows add on the card, the delta rows ship host-ward for the cold
        ones. Returns the table."""
        idx, is_hot = self._split(idx)
        delta = delta.reshape(idx.numel(), self.spec.dim)
        SimpleEmbedding(self.hot).scatter_apply(
            torch.where(is_hot, idx, self.hot_rows), delta)
        cold_idx = torch.where(is_hot, self.spec.vocab - self.hot_rows,
                               idx - self.hot_rows)
        SimpleEmbedding(self.cold).scatter_apply(
            cold_idx.to("cpu"), delta.to(self.cold.dtype).to("cpu"))
        return self

    def zeros_like(self) -> "TieredEmbedding":
        return dataclasses.replace(
            self, hot=torch.zeros_like(self.hot),
            cold=host_put(torch.zeros_like(self.cold), self.hot.device))

    def materialize(self) -> torch.Tensor:
        """The dense `(vocab, dim)` table on the hot tier's device (a test
        oracle), through the tiered gather."""
        return self.rows(torch.arange(self.spec.vocab, device=self.hot.device))

    def hot_fraction(self, idx) -> float:
        """Fraction of an id stream that the hot tier serves (on the
        host)."""
        flat = (idx.cpu().numpy() if torch.is_tensor(idx)
                else np.asarray(idx)).reshape(-1)
        return float((flat < self.hot_rows).mean())

    def retier(self, perm: np.ndarray,
               hot_rows: Optional[int] = None) -> "TieredEmbedding":
        """Re-split under a new frequency permutation (`perm[rank] =
        old_id`, hottest first: `FrequencyTracker.frequency_permutation`).
        The rows are reordered on the host (the whole table never sits on
        the card); the loader must then map incoming ids through
        `rowstats.inverse_permutation(perm)`."""
        new_h = self.hot_rows if hot_rows is None else hot_rows
        if not 0 < new_h < self.spec.vocab:
            raise ValueError(f"hot_rows out of range: {new_h}")
        perm = np.asarray(perm)
        if perm.shape != (self.spec.vocab,):
            raise ValueError(
                f"perm must be (vocab,)={self.spec.vocab}, got {perm.shape}")
        full = torch.cat([self.hot.to("cpu"), self.cold])
        new = full.index_select(0, torch.from_numpy(perm.astype(np.int64)))
        device = self.hot.device
        return dataclasses.replace(self, hot=new[:new_h].to(device, copy=True),
                                   cold=host_put(new[new_h:], device),
                                   hot_rows=new_h)
