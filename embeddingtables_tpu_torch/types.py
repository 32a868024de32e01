"""Core type tags and specs (counterpart of `embeddingtables_tpu/types.py`).

`Static{N}` / `Dynamic` lookup tags, the `IndexingContext` phase tags,
`TableSpec`, `featuresize` and `cdiv`. The TPU lane/sublane tiling constants
of the JAX package have no counterpart here: the CUDA gathers take any
feature size.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class LookupKind(enum.Enum):
    """Analog of the reference's `AbstractLookupType`."""

    STATIC = "static"
    DYNAMIC = "dynamic"


@dataclasses.dataclass(frozen=True)
class Static:
    """Fixed feature size tag; `n` must match the table's feature size."""

    n: int

    def __post_init__(self):
        if not isinstance(self.n, int) or self.n <= 0:
            raise ValueError(f"Static feature size must be a positive Int, got {self.n!r}")

    @property
    def kind(self) -> LookupKind:
        return LookupKind.STATIC


@dataclasses.dataclass(frozen=True)
class Dynamic:
    """Runtime feature size tag."""

    @property
    def kind(self) -> LookupKind:
        return LookupKind.DYNAMIC


class IndexingContext(enum.Enum):
    """Phase tag passed down the access path to tables whose `rows()` may
    steer forward reads and update writes differently."""

    NO_CONTEXT = "no_context"
    FORWARD = "forward"
    UPDATE = "update"


NoContext = IndexingContext.NO_CONTEXT
Forward = IndexingContext.FORWARD
Update = IndexingContext.UPDATE


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static description of one embedding table.

    vocab:  number of rows; tables are row-major `(vocab, dim)`.
    dim:    feature size.
    dtype:  storage dtype (a `torch.dtype`).
    lookup: Static(dim) or Dynamic() tag.
    name:   optional identifier.
    """

    vocab: int
    dim: int
    dtype: torch.dtype = torch.float32
    lookup: Static | Dynamic = dataclasses.field(default_factory=Dynamic)
    name: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.lookup, Static) and self.lookup.n != self.dim:
            raise ValueError(
                f"Static feature size {self.lookup.n} does not match table dim {self.dim}"
            )

    @property
    def is_static(self) -> bool:
        return isinstance(self.lookup, Static)


def featuresize(table) -> int:
    """Feature size of a table or a raw `(vocab, dim)` tensor."""
    if hasattr(table, "spec"):
        return table.spec.dim
    return table.shape[-1]


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)
