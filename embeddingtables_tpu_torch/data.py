"""Training data (the port's copy of `embeddingtables_tpu/data.py`).

The code is the JAX package's numpy code, so the same seed gives bitwise the
same batches in both packages. `SyntheticCriteo` batches (CTR models) are
dicts of host numpy arrays:

  dense:  (B, num_dense) float32   log1p-normalized
  cat:    (T, B) int32             per-table local row ids ((T, B, bag) bags)
  label:  (B,) float32             {0, 1}

`SyntheticRetrieval` batches (the two-tower model): `dense (B, num_dense)`
float32, `q_cat (T, B)` int32 and `item_ids (B,)` int32.

`criteo_kaggle_batches` reads a Criteo Kaggle `train.txt` in pure Python
(the semantic oracle of the native parser in `io/loader.py`), and
`csr_to_padded` / `padded_to_csr` convert between CSR bags and the fixed
width padded layout; all three are the JAX package's numpy code.
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


def csr_to_padded(values, offsets, *, bag: Optional[int] = None,
                  pad_idx: int = -1):
    """CSR/offsets bags (torch `EmbeddingBag(input, offsets)` format) ->
    the engine's fixed-width `(B, bag)` padded layout.

    values:  (nnz,) concatenated ids; offsets: (B,) bag start positions
    (bag i = values[offsets[i]:offsets[i+1]], last bag runs to the end —
    torch's include_last_offset=False convention).
    bag: fixed width (default: the longest bag). Longer bags TRUNCATE to
    the first `bag` entries (returned `n_truncated` counts the dropped
    occurrences — never truncate silently); shorter bags right-pad with
    `pad_idx`. Returns `(padded (B, bag) int32, n_truncated int)`.

    Feed the result to any lookup/model with the same `pad_idx`: pads
    contribute zero rows, no mean mass, no gradient (ops/lookup.py).
    """
    values = np.asarray(values)
    offsets = np.asarray(offsets, np.int64)
    if offsets.ndim != 1 or values.ndim != 1:
        raise ValueError("values and offsets must be 1-D")
    if offsets.size and (offsets[0] != 0 or np.any(np.diff(offsets) < 0)
                         or offsets[-1] > values.size):
        raise ValueError("offsets must be nondecreasing, start at 0, and "
                         "stay within values")
    b = offsets.size
    ends = np.append(offsets[1:], values.size)
    lengths = ends - offsets
    width = int(bag if bag is not None else max(int(lengths.max()), 1)) \
        if b else int(bag or 1)
    padded = np.full((b, width), pad_idx, values.dtype)
    kept = np.minimum(lengths, width)
    for i in range(b):
        padded[i, :kept[i]] = values[offsets[i]:offsets[i] + kept[i]]
    n_truncated = int((lengths - kept).sum())
    return padded.astype(np.int32), n_truncated


def padded_to_csr(padded, *, pad_idx: int = -1):
    """Inverse of `csr_to_padded`: `(B, bag)` padded bags -> (values,
    offsets) with pads dropped (ragged export / torch interop)."""
    padded = np.asarray(padded)
    if padded.ndim != 2:
        raise ValueError("padded must be (B, bag)")
    valid = padded != pad_idx
    values = padded[valid].astype(np.int64)
    lengths = valid.sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    return values, offsets


def criteo_kaggle_batches(path: str, vocab_sizes: Sequence[int],
                          batch_size: int = 8192,
                          max_batches: Optional[int] = None) -> Iterator[dict]:
    """Stream batches from a Criteo Kaggle `train.txt` TSV.

    Row format: label \\t I1..I13 (ints, may be empty) \\t C1..C26 (8-hex
    tokens, may be empty). Missing dense -> 0; categoricals hash (FNV-1a) into
    `vocab_sizes[t]`. Dense is log1p'd (standard DLRM preprocessing).
    """
    t = len(vocab_sizes)
    assert t == CRITEO_NUM_SPARSE, f"Criteo has 26 sparse features, got {t}"

    def fnv1a(s: str) -> int:
        h = 0xCBF29CE484222325
        for ch in s.encode():
            h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h

    dense_buf = np.zeros((batch_size, CRITEO_NUM_DENSE), np.float32)
    cat_buf = np.zeros((t, batch_size), np.int32)
    label_buf = np.zeros((batch_size,), np.float32)
    n = 0
    emitted = 0
    with open(path, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 1 + CRITEO_NUM_DENSE + CRITEO_NUM_SPARSE:
                continue
            # Malformed-input policy (matches native/criteo_parser.cpp): an
            # unparseable label skips the row; an unparseable dense field
            # becomes 0 — one bad record must not abort the whole stream.
            try:
                label = float(parts[0])
            except ValueError:
                continue
            label_buf[n] = label
            for j in range(CRITEO_NUM_DENSE):
                v = parts[1 + j]
                try:
                    x = float(v) if v else 0.0
                except ValueError:
                    x = 0.0
                dense_buf[n, j] = np.log1p(max(x, 0.0))
            for j in range(CRITEO_NUM_SPARSE):
                v = parts[1 + CRITEO_NUM_DENSE + j]
                cat_buf[j, n] = fnv1a(v) % vocab_sizes[j] if v else 0
            n += 1
            if n == batch_size:
                yield dict(dense=dense_buf.copy(), cat=cat_buf.copy(),
                           label=label_buf.copy())
                n = 0
                emitted += 1
                if max_batches is not None and emitted >= max_batches:
                    return


@dataclasses.dataclass
class SyntheticRetrieval:
    """Seeded synthetic retrieval stream for two-tower training.

    Planted structure: item j "belongs to" query feature cluster `j % vocab`
    per query table, so queries carrying those features click that item and
    recall@k is learnable far above chance. `unique_items=True` samples each
    batch's positives without replacement (a duplicate positive is a false
    negative under the in-batch softmax)."""

    query_vocab_sizes: Sequence[int]
    item_vocab: int
    num_dense: int = 4
    batch_size: int = 512
    unique_items: bool = True
    seed: int = 0

    def batches(self, num_batches: Optional[int] = None) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        b = self.batch_size
        i = 0
        while num_batches is None or i < num_batches:
            if self.unique_items and b <= self.item_vocab:
                items = rng.choice(self.item_vocab, b,
                                   replace=False).astype(np.int32)
            else:
                items = rng.integers(0, self.item_vocab, b).astype(np.int32)
            q_cat = np.stack([items % v for v in self.query_vocab_sizes]
                             ).astype(np.int32)
            dense = rng.normal(size=(b, self.num_dense)).astype(np.float32)
            yield dict(dense=dense, q_cat=q_cat, item_ids=items)
            i += 1
