"""Synthetic Criteo-shaped click logs for DLRM training (the port's copy of
`SyntheticCriteo` from `embeddingtables_tpu/data.py`).

The code is the JAX package's numpy code, so the same seed gives bitwise the
same batches in both packages. Batches are dicts of host numpy arrays:

  dense:  (B, num_dense) float32   log1p-normalized
  cat:    (T, B) int32             per-table local row ids ((T, B, bag) bags)
  label:  (B,) float32             {0, 1}
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

# Criteo Kaggle display-advertising shape.
CRITEO_NUM_DENSE = 13
CRITEO_NUM_SPARSE = 26


@dataclasses.dataclass
class SyntheticCriteo:
    """Seeded synthetic click-log generator with Zipf-skewed categoricals."""

    vocab_sizes: Sequence[int]
    num_dense: int = CRITEO_NUM_DENSE
    batch_size: int = 8192
    zipf_a: float = 1.1          # power-law exponent; ~1.1 matches CTR logs
    bag: Optional[int] = None    # multi-hot bag size (None = one-hot (T,B))
    # Variable-length bags: each (table, example) bag keeps a uniform
    # Uniform{1..bag} number of valid entries; the rest are right-padded
    # with `pad_idx` (pairs with the models' cfg.pad_idx — pads contribute
    # nothing to the hidden label model either).
    pad_idx: Optional[int] = None
    seed: int = 0
    # Separate stream for the sample draw (None = `seed`): parallel workers
    # use one `seed` (shared ground-truth label model) and distinct
    # `stream_seed`s (disjoint example streams).
    stream_seed: Optional[int] = None

    def __post_init__(self):
        if self.pad_idx is not None:
            if self.bag is None:
                raise ValueError("pad_idx requires bag= (variable-length "
                                 "bags pad a fixed bag width)")
            if 0 <= self.pad_idx < max(self.vocab_sizes):
                raise ValueError(
                    f"pad_idx={self.pad_idx} collides with real ids; use an "
                    "out-of-vocab sentinel (e.g. -1) — an in-vocab sentinel "
                    "would make genuine draws of that id read as pads")
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        t = len(self.vocab_sizes)
        # Hidden ground-truth model: per-(table,row) logit contributions drawn
        # from a sparse prior + dense linear weights.
        self._w_dense = rng.normal(0, 1.0, self.num_dense).astype(np.float32)
        self._row_logit = [rng.normal(0, 1.5, v).astype(np.float32)
                           for v in self.vocab_sizes]
        self._bias = -1.5  # skew toward negatives like real CTR data
        self._t = t

    def _zipf_tables(self, vocab: int):
        """Walker alias tables for rank-r probability ∝ r^-a: O(V) build
        (cached per vocab), O(1) vectorized sampling — the inverse-CDF
        searchsorted version made host data generation slower than the
        device step (35.7 vs 20.5 ms/batch measured)."""
        cache = getattr(self, "_alias_cache", None)
        if cache is None:
            cache = self._alias_cache = {}
        entry = cache.get(vocab)
        if entry is None:
            p = np.arange(1, vocab + 1, dtype=np.float64) ** (-self.zipf_a)
            p /= p.sum()
            scaled = p * vocab
            alias = np.zeros(vocab, np.int32)
            prob = np.ones(vocab, np.float64)
            small = [i for i in range(vocab) if scaled[i] < 1.0]
            large = [i for i in range(vocab) if scaled[i] >= 1.0]
            while small and large:
                s, l = small.pop(), large.pop()
                prob[s] = scaled[s]
                alias[s] = l
                scaled[l] = scaled[l] - (1.0 - scaled[s])
                (small if scaled[l] < 1.0 else large).append(l)
            perm = np.random.default_rng(
                self.seed ^ vocab).permutation(vocab).astype(np.int32)
            entry = cache[vocab] = (prob, alias, perm)
        return entry

    def _zipf_indices(self, rng, vocab: int, shape) -> np.ndarray:
        prob, alias, perm = self._zipf_tables(vocab)
        k = rng.integers(0, vocab, shape)
        take_alias = rng.random(shape) >= prob[k]
        idx = np.where(take_alias, alias[k], k).astype(np.int32)
        # Random rank->id permutation so hot rows are spread over the vocab.
        return perm[idx]

    def batches(self, num_batches: Optional[int] = None) -> Iterator[dict]:
        rng = np.random.default_rng(
            self.seed if self.stream_seed is None else self.stream_seed)
        b = self.batch_size
        i = 0
        while num_batches is None or i < num_batches:
            dense_raw = rng.lognormal(0.0, 1.0, (b, self.num_dense)).astype(np.float32)
            dense = np.log1p(dense_raw)
            if self.bag is None:
                cat = np.stack([self._zipf_indices(rng, v, (b,))
                                for v in self.vocab_sizes])           # (T, B)
                row_contrib = sum(self._row_logit[t][cat[t]] for t in range(self._t))
            else:
                cat = np.stack([self._zipf_indices(rng, v, (b, self.bag))
                                for v in self.vocab_sizes])           # (T, B, bag)
                if self.pad_idx is not None:
                    # Right-pad each bag beyond a Uniform{1..bag} length.
                    lengths = rng.integers(1, self.bag + 1,
                                           (self._t, b, 1))
                    pad_mask = np.arange(self.bag) >= lengths  # (T, B, bag)
                    cat = np.where(pad_mask, self.pad_idx, cat)
                    valid = ~pad_mask
                    row_contrib = sum(
                        (self._row_logit[t][np.where(valid[t], cat[t], 0)]
                         * valid[t]).sum(-1) / np.maximum(
                             valid[t].sum(-1), 1)
                        for t in range(self._t))
                else:
                    row_contrib = sum(
                        self._row_logit[t][cat[t]].sum(-1) / self.bag
                        for t in range(self._t))
            logit = (dense @ self._w_dense) / np.sqrt(self.num_dense) \
                + row_contrib / np.sqrt(self._t) + self._bias
            prob = 1.0 / (1.0 + np.exp(-logit))
            label = (rng.random(b) < prob).astype(np.float32)
            yield dict(dense=dense, cat=cat, label=label)
            i += 1
