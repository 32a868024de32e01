"""Embedding table containers (counterpart of `embeddingtables_tpu/tables.py`).

Tables are row-major `(vocab, dim)` tensors; `lookup(A, I)[i, :] == A[I[i], :]`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ops.cuda.gather import gather_rows
from .types import Dynamic, Static, TableSpec


def _as_spec(data: torch.Tensor, lookup: Static | Dynamic | None,
             name: Optional[str]) -> TableSpec:
    vocab, dim = data.shape
    if lookup is None:
        lookup = Dynamic()
    if isinstance(lookup, Static) and lookup.n != dim:
        raise ValueError(
            f"Static feature size {lookup.n} does not match array feature size {dim}"
        )
    return TableSpec(vocab=vocab, dim=dim, dtype=data.dtype, lookup=lookup, name=name)


class SimpleEmbedding:
    """Minimal table: a thin wrapper over one `(vocab, dim)` tensor."""

    def __init__(self, data: torch.Tensor, lookup: Static | Dynamic | None = None,
                 *, spec: TableSpec | None = None, name: Optional[str] = None):
        self.data = data
        self.spec = spec if spec is not None else _as_spec(data, lookup, name)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def example(self) -> torch.Tensor:
        """Prototype tensor for output placement (device and dtype)."""
        return self.data

    def rows(self, idx: torch.Tensor, context=None) -> torch.Tensor:
        """Gather rows `idx` of any shape -> `(*idx.shape, dim)`."""
        idx = idx.to(torch.int32)
        flat = gather_rows(self.data, idx.reshape(-1).contiguous())
        return flat.reshape(*idx.shape, self.spec.dim)


def is_table(x) -> bool:
    """True for anything implementing the table protocol: `spec`, `rows`,
    `example`."""
    return hasattr(x, "spec") and hasattr(x, "rows") and hasattr(x, "example")


def as_table(x):
    """Coerce a raw `(vocab, dim)` tensor into a `SimpleEmbedding`."""
    if is_table(x):
        return x
    return SimpleEmbedding(torch.as_tensor(x))
