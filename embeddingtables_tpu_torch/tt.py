"""TT-Rec (tensor-train) compressed embedding tables (counterpart of
`embeddingtables_tpu/tt.py`; Yin et al., "TT-Rec: Tensor Train Compression
of Deep Learning Recommendation Models", MLSys 2021).

The vocab factors as `V <= v1*...*vK` and the dim as `D = d1*...*dK`; a
`(V, D)` table becomes K small cores

    G_k : (v_k, r_{k-1}, d_k, r_k)        r_0 = r_K = 1

and row `v`, with row-major mixed-radix digits `i1..iK`, is the rank-space
product `G_1[i1] @ G_2[i2] @ ... @ G_K[iK]`, flattened to `(D,)`.

A lookup gathers each core as a `(v_k, r*d*r')` table through `gather_rows`
(the hand kernel on the card) and folds the slices with K-1 batched matmuls,
which stay torch matmuls as JAX leaves its einsum chain to XLA. Training:
each core is an embedding table of `(v_k, r*d*r')` rows (`core_tables`, views
of the cores), and the pullback of a lookup is K `SparseEmbeddingUpdate`s on
the digit streams, the fold's VJP taken with `torch.autograd`.

Cores of any width take the run-scatter: at rank 32 and D = 128 the middle
core is 4,096 wide, which the kernel's wide class takes in one pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .ops.sparse_update import SparseEmbeddingUpdate
from .tables import SimpleEmbedding, normal, take_rows
from .types import Dynamic, TableSpec


def _balanced_factors(n: int, k: int) -> Tuple[int, ...]:
    """k integer factors with product >= n, as balanced as possible (the
    vocab factorization: a product past `n` pads the id space)."""
    if k == 1:
        return (n,)
    root = max(1, round(n ** (1.0 / k)))
    best: Optional[Tuple[int, ...]] = None
    for f in range(max(1, root - 2), root + 3):
        rest = _balanced_factors(-(-n // f), k - 1)
        cand = tuple(sorted((f,) + rest, reverse=True))
        prod = 1
        for c in cand:
            prod *= c
        if prod >= n and (best is None or cand < best):
            best = cand
    if best is None:
        raise ValueError(f"no {k} factors of {n}")
    return best


def _exact_factors(n: int, k: int) -> Tuple[int, ...]:
    """k integer factors with product exactly n, as balanced as the divisors
    allow (the dim factorization); a prime n gives (n, 1, ..., 1)."""
    if k == 1:
        return (n,)
    root = round(n ** (1.0 / k))
    for delta in range(0, n):
        for f in (root - delta, root + delta):
            if 1 <= f <= n and n % f == 0:
                return tuple(sorted(
                    (f,) + _exact_factors(n // f, k - 1), reverse=True))
    return (n,) + (1,) * (k - 1)


def _digits(idx: torch.Tensor, vocab_factors: Sequence[int]
            ) -> List[torch.Tensor]:
    """Row-major mixed-radix int32 digits of `idx` (floor division and a
    non-negative modulo, as JAX's `//` and `%`)."""
    out = []
    rem = idx.to(torch.int32)
    for k in range(len(vocab_factors)):
        stride = 1
        for f in vocab_factors[k + 1:]:
            stride *= f
        out.append(torch.div(rem, stride, rounding_mode="floor"))
        rem = torch.remainder(rem, stride)
    return out


def _fold(slices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract gathered core slices `(B, r_{k-1}, d_k, r_k)` over the rank
    dims -> `(B, D)`, the dim axis row-major in core order."""
    b = slices[0].shape[0]
    acc = slices[0].reshape(b, slices[0].shape[2], slices[0].shape[3])
    for s in slices[1:]:
        _, r, d, r2 = s.shape
        m = acc.shape[1]
        acc = torch.bmm(acc, s.reshape(b, r, d * r2)).reshape(b, m * d, r2)
    return acc.reshape(b, acc.shape[1])


@dataclasses.dataclass
class TTEmbedding:
    """Tensor-train `(vocab, dim)` table backed by K small cores."""

    cores: Tuple[torch.Tensor, ...]   # core k: (v_k, r_{k-1}, d_k, r_k)
    spec: TableSpec
    vocab_factors: Tuple[int, ...]
    dim_factors: Tuple[int, ...]

    @classmethod
    def create(cls, generator, vocab: int, dim: int, *, rank: int = 8,
               num_cores: int = 3,
               vocab_factors: Optional[Sequence[int]] = None,
               dim_factors: Optional[Sequence[int]] = None,
               dtype=torch.float32, name: Optional[str] = None,
               device=None) -> "TTEmbedding":
        """Random TT table on `device` (CUDA unless given), drawn from
        `generator`, each row's std about 1/sqrt(dim)."""
        if num_cores < 2:
            raise ValueError("TT needs >= 2 cores (1 core is a dense table)")
        vf = tuple(vocab_factors) if vocab_factors else _balanced_factors(
            vocab, num_cores)
        df = tuple(dim_factors) if dim_factors else _exact_factors(
            dim, num_cores)
        if len(vf) != len(df):
            raise ValueError("vocab_factors and dim_factors lengths differ")
        k = len(vf)
        pv = pd = 1
        for f in vf:
            pv *= f
        for f in df:
            pd *= f
        if pv < vocab:
            raise ValueError(f"prod(vocab_factors)={pv} < vocab={vocab}")
        if pd != dim:
            raise ValueError(f"prod(dim_factors)={pd} != dim={dim}")
        ranks = (1,) + (rank,) * (k - 1) + (1,)
        # A row element sums r^(K-1) rank paths of K-factor products; the
        # per-entry std solves paths * sigma^(2K) = 1/dim.
        paths = rank ** (k - 1)
        sigma = float((1.0 / (pd * paths)) ** (1.0 / (2 * k)))
        cores = tuple(
            sigma * normal(generator, (vf[i], ranks[i], df[i], ranks[i + 1]),
                           dtype, device)
            for i in range(k))
        spec = TableSpec(vocab=vocab, dim=dim, dtype=cores[0].dtype,
                         lookup=Dynamic(), name=name)
        return cls(cores=cores, spec=spec, vocab_factors=vf, dim_factors=df)

    # --- table protocol ------------------------------------------------------
    @property
    def shape(self):
        return (self.spec.vocab, self.spec.dim)

    @property
    def dtype(self):
        return self.spec.dtype

    def example(self) -> torch.Tensor:
        return self.cores[0].reshape(self.cores[0].shape[0], -1)

    def _slices(self, flat_idx: torch.Tensor) -> List[torch.Tensor]:
        digs = _digits(flat_idx, self.vocab_factors)
        return [take_rows(t, d).reshape(d.shape[0], *c.shape[1:])
                for c, t, d in zip(self.cores, self.core_tables(), digs)]

    def rows(self, idx, context=None) -> torch.Tensor:
        """Gather the cores and fold: `(*idx.shape, dim)`."""
        idx = torch.as_tensor(idx).to(self.cores[0].device)
        out = _fold(self._slices(idx.reshape(-1)))
        return out.reshape(*idx.shape, self.spec.dim)

    def materialize(self) -> torch.Tensor:
        """The dense `(vocab, dim)` table (a test oracle)."""
        return self.rows(torch.arange(self.spec.vocab,
                                      device=self.cores[0].device))

    def compression(self) -> float:
        """Dense-table elements / TT elements."""
        return (self.spec.vocab * self.spec.dim
                / sum(c.numel() for c in self.cores))

    # --- training ------------------------------------------------------------
    def _sub_updates(self, flat_idx, delta: torch.Tensor
                     ) -> Tuple[SparseEmbeddingUpdate, ...]:
        """Chain rule through the fold: one update per core, each
        occurrence's slice gradient flattened to a `(r*d*r')` row."""
        flat_idx = torch.as_tensor(flat_idx).to(
            self.cores[0].device).reshape(-1)
        digs = _digits(flat_idx, self.vocab_factors)
        slices = [s.detach().requires_grad_(True)
                  for s in self._slices(flat_idx)]
        with torch.inference_mode(False), torch.enable_grad():
            grads = torch.autograd.grad(
                _fold(slices), slices, delta.reshape(-1, self.spec.dim))
        return tuple(
            SparseEmbeddingUpdate(delta=g.reshape(g.shape[0], -1), indices=d)
            for g, d in zip(grads, digs))

    def core_tables(self) -> Tuple[torch.Tensor, ...]:
        """The cores viewed as `(v_k, r*d*r')` embedding tables (views: an
        update of one updates its core); the sparse optimizers apply
        `_sub_updates`' streams to them."""
        return tuple(c.reshape(c.shape[0], -1) for c in self.cores)

    def replace_core_tables(self, flats: Sequence[torch.Tensor]
                            ) -> "TTEmbedding":
        cores = tuple(f.reshape(c.shape) for f, c in zip(flats, self.cores))
        return dataclasses.replace(self, cores=cores)

    def scatter_apply(self, idx, delta: torch.Tensor) -> "TTEmbedding":
        """`rows[idx] += delta` through the fold's chain rule into every
        core, in place (plain SGD through the protocol). Returns the
        table."""
        upds = self._sub_updates(idx, torch.as_tensor(delta))
        for t, u in zip(self.core_tables(), upds):
            SimpleEmbedding(t).scatter_apply(u.indices, u.delta)
        return self


def tt_lookup_vjp(table: TTEmbedding, indices
                  ) -> Tuple[torch.Tensor, Callable]:
    """TT lookup plus its lazy pullback: `pullback(delta) -> (upd_1, ...,
    upd_K)`, one `SparseEmbeddingUpdate` per core for the sparse optimizers
    to apply to `table.core_tables()[k]`. `(B,)` ids only, as
    `qr_lookup_vjp`."""
    indices = torch.as_tensor(indices).to(table.cores[0].device)
    if indices.dim() != 1:
        raise ValueError("tt_lookup_vjp takes (B,) indices; reduce bags "
                         "outside the TT fold")
    out = table.rows(indices)

    def pullback(delta: torch.Tensor):
        return table._sub_updates(indices, delta)

    return out, pullback
