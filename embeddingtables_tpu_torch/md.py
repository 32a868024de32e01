"""MD (mixed-dimension) embedding tables: rows stored at a small dimension
and projected up on lookup (counterpart of `embeddingtables_tpu/md.py`;
Ginart et al., "Mixed Dimension Embeddings", 2021):

    data: (V, d_small)      proj: (d_small, D)
    row(v) = data[v] @ proj

Memory: V*d_small + d_small*D against V*D.

The lookup is a `gather_rows` at `d_small` (the hand kernel on the card)
followed by a `(B, d_small) @ (d_small, D)` matmul, which stays a torch
matmul as JAX leaves it to XLA. Training: the pullback is a lazy
`SparseEmbeddingUpdate` of the small table (delta @ proj^T on the lookup's
ids) and a dense `(d_small, D)` gradient of the shared projection.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .ops.sparse_update import SparseEmbeddingUpdate
from .tables import SimpleEmbedding, normal, take_rows
from .types import Dynamic, TableSpec


@dataclasses.dataclass
class MDEmbedding:
    """Low-rank `(vocab, dim)` table: `(V, d_small)` rows and a shared
    `(d_small, dim)` projection."""

    data: torch.Tensor         # (V, d_small)
    proj: torch.Tensor         # (d_small, dim)
    spec: TableSpec

    @classmethod
    def create(cls, generator, vocab: int, dim: int, d_small: int, *,
               dtype=torch.float32, name: Optional[str] = None,
               device=None) -> "MDEmbedding":
        """Random MD table on `device` (CUDA unless given), drawn from
        `generator`."""
        if not 0 < d_small <= dim:
            raise ValueError(f"d_small must be in (0, {dim}], got {d_small}")
        data = normal(generator, (vocab, d_small), dtype, device) / (
            d_small ** 0.5)
        proj = normal(generator, (d_small, dim), dtype, device) / (dim ** 0.25)
        spec = TableSpec(vocab=vocab, dim=dim, dtype=dtype, lookup=Dynamic(),
                         name=name)
        return cls(data=data, proj=proj, spec=spec)

    # --- table protocol ------------------------------------------------------
    @property
    def shape(self):
        return (self.spec.vocab, self.spec.dim)

    @property
    def dtype(self):
        return self.spec.dtype

    @property
    def d_small(self) -> int:
        return self.data.shape[1]

    def example(self) -> torch.Tensor:
        return self.data

    def rows(self, idx, context=None) -> torch.Tensor:
        return take_rows(self.data, idx) @ self.proj

    def materialize(self) -> torch.Tensor:
        return self.data @ self.proj

    def compression(self) -> float:
        return (self.spec.vocab * self.spec.dim
                / (self.data.numel() + self.proj.numel()))

    def scatter_apply(self, idx, delta: torch.Tensor) -> "MDEmbedding":
        """A full-width row delta applied to the small table only (projected
        back through proj^T), in place; the projection is left to the dense
        optimizer. Returns the table."""
        small_delta = delta @ self.proj.T.to(delta.dtype)
        SimpleEmbedding(self.data).scatter_apply(idx, small_delta)
        return self


def md_lookup_vjp(table: MDEmbedding, indices
                  ) -> Tuple[torch.Tensor, Callable]:
    """MD lookup plus its split pullback: `pullback(delta) -> (upd_small,
    proj_grad)`, a lazy `SparseEmbeddingUpdate` of `table.data` on the
    lookup's ids and the dense `(d_small, dim)` gradient of the projection.
    `(B,)` ids only."""
    indices = torch.as_tensor(indices).to(table.data.device)
    if indices.dim() != 1:
        raise ValueError("md_lookup_vjp takes (B,) indices; reduce bags "
                         "outside the projection")
    small = take_rows(table.data, indices)               # (B, d_small)
    out = small @ table.proj

    def pullback(delta: torch.Tensor):
        upd_small = SparseEmbeddingUpdate(
            delta=delta @ table.proj.T.to(delta.dtype), indices=indices)
        proj_grad = small.to(delta.dtype).T @ delta      # (d_small, dim)
        return upd_small, proj_grad

    return out, pullback
