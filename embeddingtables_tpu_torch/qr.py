"""QR (quotient-remainder) compressed embedding tables (counterpart of
`embeddingtables_tpu/qr.py`).

Row `v` of a `(V, D)` table is the combination of rows of two small tables
(Shi et al., "Compositional Embeddings Using Complementary Partitions", KDD
2020):

    q_table: (ceil(V / Q), D)   row v // Q
    r_table: (Q, D)             row v % Q
    row(v) = combine(q_table[v // Q], r_table[v % Q])

`combine` is "mult" (elementwise product), "add" or "concat" (each table
carries D/2). Memory falls from V*D to (V/Q + Q)*D, least at Q ≈ sqrt(V).

A lookup is two gathers on the small tables through `gather_rows` (the hand
kernel on the card) and one elementwise combine. Each sub-table applies its
own id contract, `jnp.take`'s as in JAX: an id in `[V, nq*Q)` gives a real
row, and a quotient or remainder out of its table's range a NaN row.
Training: the pullback of a QR lookup is two `SparseEmbeddingUpdate`s, one
per sub-table (the delta scaled by the partner's rows for "mult"), which the
sparse optimizers apply to `q_data` and `r_data`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .ops.sparse_update import SparseEmbeddingUpdate
from .tables import SimpleEmbedding, normal, take_rows
from .types import Dynamic, TableSpec, cdiv


@dataclasses.dataclass
class QREmbedding:
    """Compositional `(vocab, dim)` table backed by two O(sqrt(V)) tables."""

    q_data: torch.Tensor       # (ceil(vocab / Q), dim_q)
    r_data: torch.Tensor       # (Q, dim_r)
    spec: TableSpec
    num_remainder: int
    combine: str = "mult"

    @classmethod
    def create(cls, generator, vocab: int, dim: int, *,
               num_remainder: Optional[int] = None, combine: str = "mult",
               dtype=torch.float32, name: Optional[str] = None,
               device=None) -> "QREmbedding":
        """Random QR table on `device` (CUDA unless given), drawn from
        `generator`; Q defaults to int(sqrt(vocab))."""
        if combine not in ("mult", "add", "concat"):
            raise ValueError(f"combine must be mult|add|concat, got {combine}")
        q = num_remainder or max(2, int(vocab ** 0.5))
        nq = cdiv(vocab, q)
        dq = dr = dim
        if combine == "concat":
            if dim % 2 != 0:
                raise ValueError("concat combine needs an even dim")
            dq = dr = dim // 2
        scale = 1.0 / (dim ** 0.5)
        q_data = scale * normal(generator, (nq, dq), dtype, device)
        r_data = scale * normal(generator, (q, dr), dtype, device)
        if combine == "mult":
            # A product of two ~N(0, s) factors has scale s^2: seed q around
            # 1 so products start near a plain table's init scale.
            q_data = 1.0 + q_data
        spec = TableSpec(vocab=vocab, dim=dim, dtype=q_data.dtype,
                         lookup=Dynamic(), name=name)
        return cls(q_data=q_data, r_data=r_data, spec=spec,
                   num_remainder=q, combine=combine)

    # --- table protocol ------------------------------------------------------
    @property
    def shape(self):
        return (self.spec.vocab, self.spec.dim)

    @property
    def dtype(self):
        return self.spec.dtype

    def example(self) -> torch.Tensor:
        return self.q_data

    def split_indices(self, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """int32 (quotient, remainder) ids: floor division and a
        non-negative modulo, as JAX's `//` and `%`."""
        idx = torch.as_tensor(idx).to(self.q_data.device, torch.int32)
        q = self.num_remainder
        return (torch.div(idx, q, rounding_mode="floor"),
                torch.remainder(idx, q))

    def rows(self, idx, context=None) -> torch.Tensor:
        """Gather and combine: `(*idx.shape, dim)`."""
        qi, ri = self.split_indices(idx)
        qrow = take_rows(self.q_data, qi)
        rrow = take_rows(self.r_data, ri)
        if self.combine == "mult":
            return qrow * rrow
        if self.combine == "add":
            return qrow + rrow
        return torch.cat([qrow, rrow], dim=-1)

    def materialize(self) -> torch.Tensor:
        """The dense `(vocab, dim)` table (a test oracle)."""
        return self.rows(torch.arange(self.spec.vocab,
                                      device=self.q_data.device))

    def compression(self) -> float:
        """Dense-table elements / QR elements."""
        return (self.spec.vocab * self.spec.dim
                / (self.q_data.numel() + self.r_data.numel()))

    def scatter_apply(self, idx, delta: torch.Tensor) -> "QREmbedding":
        """`rows[idx] += delta` through the combine's chain rule into both
        sub-tables, in place (plain SGD through the protocol); duplicates
        accumulate, ids follow `SimpleEmbedding.scatter_apply`. Returns the
        table."""
        upd_q, upd_r = self._sub_updates(idx, delta)
        SimpleEmbedding(self.q_data).scatter_apply(upd_q.indices, upd_q.delta)
        SimpleEmbedding(self.r_data).scatter_apply(upd_r.indices, upd_r.delta)
        return self

    # --- training ------------------------------------------------------------
    def _sub_updates(self, idx, delta: torch.Tensor):
        """Chain rule: per-occurrence updates of (q_table, r_table)."""
        qi, ri = self.split_indices(idx)
        if self.combine == "mult":
            qrow = take_rows(self.q_data, qi).to(delta.dtype)
            rrow = take_rows(self.r_data, ri).to(delta.dtype)
            dq, dr = delta * rrow, delta * qrow
        elif self.combine == "add":
            dq = dr = delta
        else:
            h = self.q_data.shape[1]
            dq, dr = delta[..., :h], delta[..., h:]
        return (SparseEmbeddingUpdate(delta=dq, indices=qi),
                SparseEmbeddingUpdate(delta=dr, indices=ri))


def qr_lookup_vjp(table: QREmbedding, indices
                  ) -> Tuple[torch.Tensor, Callable]:
    """QR lookup plus its lazy pullback: `pullback(delta) -> (upd_q, upd_r)`,
    one `SparseEmbeddingUpdate` per sub-table, for the sparse optimizers to
    apply to `q_data` and `r_data`. `(B,)` ids only: a bag reduces after
    the combine, which is no per-sub-table bag weight for "mult"."""
    indices = torch.as_tensor(indices).to(table.q_data.device)
    if indices.dim() != 1:
        raise ValueError("qr_lookup_vjp takes (B,) indices; reduce bags "
                         "outside the QR combine")
    out = table.rows(indices)

    def pullback(delta: torch.Tensor):
        return table._sub_updates(indices, delta)

    return out, pullback
