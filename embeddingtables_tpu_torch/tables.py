"""Embedding table containers (counterpart of `embeddingtables_tpu/tables.py`).

Tables are row-major `(vocab, dim)` tensors; `lookup(A, I)[i, :] == A[I[i], :]`.

  - `SimpleEmbedding`: one `(vocab, dim)` tensor.
  - `SplitEmbedding`: the rows in chunks of `rows_per_shard` (the last one
    ragged), each on a device of its own if asked.
  - `example` / `destination`: the prototype tensor of a table, and the
    shape and dtype of a lookup's output as a tensor on the `meta` device.

`scatter_apply` adds into the rows in place and returns the table: the
port's counterpart of JAX's donated buffers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import resolve_device
from .ops.cuda.gather import gather_rows
from .types import Dynamic, Static, TableSpec, cdiv, featuresize


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

    def scatter_apply(self, idx: torch.Tensor,
                      delta: torch.Tensor) -> "SimpleEmbedding":
        """`data[idx] += delta` in place, duplicates accumulating; ids in
        `[-V, 0)` wrap and other out-of-range ids are dropped, as JAX's
        `.at[idx].add` does. Returns the table."""
        from .ops.sparse_update import resolve_rows   # it imports this module
        rows = resolve_rows(torch.as_tensor(idx).reshape(-1).to(
            self.data.device), self.data.shape[0]).long()
        keep = rows >= 0
        delta = delta.reshape(rows.shape[0], -1).to(self.data.device,
                                                     self.data.dtype)
        self.data.index_add_(0, rows[keep], delta[keep])
        return self

    def zeros_like(self) -> "SimpleEmbedding":
        """A table of the same shape and dtype holding zeros."""
        return SimpleEmbedding(torch.zeros_like(self.data), spec=self.spec)


def normal(generator, shape, dtype, device=None) -> torch.Tensor:
    """Standard-normal draws of `shape` and `dtype` on `device` (CUDA unless
    given) from `generator` (which must live there; by default one seeded
    with 0): the `create` constructors' initializer."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def take_rows(data: torch.Tensor, idx) -> torch.Tensor:
    """`data[idx]` for ids of any shape through `gather_rows` on the table's
    device, under the lookup's id contract (`[-V, 0)` wraps, any other
    out-of-range id gives a NaN row): `jnp.take` as the JAX tables call
    it."""
    return SimpleEmbedding(data).rows(torch.as_tensor(idx).to(data.device))


def _as_data(data, device=None) -> torch.Tensor:
    """A tensor as it is; anything else (a numpy array) as a tensor on
    `resolve_device(device)`, float64 narrowed to float32 as in the JAX
    package."""
    if torch.is_tensor(data):
        return data
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        resolve_device(device))


class SplitEmbedding:
    """Row-sharded table: chunks of `rows_per_shard` rows, the last one
    ragged. Its spec is always `Static(dim)`.

    `devices`, a list of `torch.device`s, places shard `s` on
    `devices[s % len(devices)]`; without it the shards stay on the device of
    `data` (a numpy `data` goes to CUDA unless the devices say otherwise).
    """

    def __init__(self, data=None, rows_per_shard: int | None = None, *,
                 shards: Sequence[torch.Tensor] | None = None,
                 spec: TableSpec | None = None,
                 devices: Sequence | None = None, name: Optional[str] = None):
        if shards is not None:
            self.shards = list(shards)
            self.spec = spec
            self.rows_per_shard = rows_per_shard or self.shards[0].shape[0]
            return
        # With devices, numpy data is cut on the host and each chunk moved.
        data = _as_data(data, "cpu" if devices is not None else None)
        vocab, dim = data.shape
        if rows_per_shard is None:
            rows_per_shard = vocab
        if rows_per_shard <= 0:
            raise ValueError("rows_per_shard must be positive")
        chunks = []
        for s in range(cdiv(vocab, rows_per_shard)):
            chunk = data[s * rows_per_shard:min(vocab, (s + 1) * rows_per_shard)]
            if devices is not None:
                chunk = chunk.to(torch.device(devices[s % len(devices)]))
            chunks.append(chunk.clone())
        self.shards = chunks
        self.rows_per_shard = rows_per_shard
        self.spec = spec if spec is not None else TableSpec(
            vocab=vocab, dim=dim, dtype=data.dtype, lookup=Static(dim),
            name=name)

    @property
    def shape(self):
        return (self.spec.vocab, self.spec.dim)

    @property
    def dtype(self):
        return self.spec.dtype

    @property
    def nshards(self) -> int:
        return len(self.shards)

    def chunkindex(self, idx):
        """Global row id -> (shard, local row)."""
        return idx // self.rows_per_shard, idx % self.rows_per_shard

    def example(self) -> torch.Tensor:
        return self.shards[0]

    def materialize(self) -> torch.Tensor:
        """The dense `(vocab, dim)` table (a test oracle)."""
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], dim=0)

    def rows(self, idx, context=None) -> torch.Tensor:
        """Rows `idx` of any shape -> `(*idx.shape, dim)`: each id routed to
        its shard by divmod, gathered there with its local row clipped into
        the shard, and kept only from its own shard (ids of no shard give
        zero rows)."""
        out_dev = self.shards[0].device
        idx = torch.as_tensor(idx).to(out_dev).long()
        shard_id, local = self.chunkindex(idx)
        out = None
        for s, chunk in enumerate(self.shards):
            safe = local.clamp(0, chunk.shape[0] - 1).to(chunk.device)
            got = chunk.index_select(0, safe.reshape(-1)).reshape(
                *idx.shape, self.spec.dim).to(out_dev)
            picked = torch.where((shard_id == s)[..., None], got,
                                 torch.zeros_like(got))
            out = picked if out is None else out + picked
        return out

    def replace_shards(self, shards: Sequence[torch.Tensor]) -> "SplitEmbedding":
        return SplitEmbedding(shards=list(shards), spec=self.spec,
                              rows_per_shard=self.rows_per_shard)

    def scatter_apply(self, idx, delta: torch.Tensor) -> "SplitEmbedding":
        """`rows[idx] += delta` in place, shard by shard; ids of no shard,
        and ids past the ragged last shard's rows, are dropped. Returns the
        table."""
        idx = torch.as_tensor(idx).reshape(-1).long()
        delta = delta.reshape(idx.shape[0], -1)
        shard_id, local = self.chunkindex(idx.to(delta.device))
        for s, chunk in enumerate(self.shards):
            mine = (shard_id == s) & (local < chunk.shape[0])
            chunk.index_add_(0, local[mine].to(chunk.device),
                             delta[mine].to(chunk.device, chunk.dtype))
        return self

    def zeros_like(self) -> "SplitEmbedding":
        return self.replace_shards([torch.zeros_like(s) for s in self.shards])


def is_table(x) -> bool:
    """True for anything implementing the table protocol: `spec`, `rows`,
    `example`."""
    return hasattr(x, "spec") and hasattr(x, "rows") and hasattr(x, "example")


def as_table(x):
    """Coerce a raw `(vocab, dim)` tensor into a `SimpleEmbedding`."""
    if is_table(x):
        return x
    return SimpleEmbedding(torch.as_tensor(x))


def example(table) -> torch.Tensor:
    """The table's prototype tensor (device and dtype of its outputs)."""
    return as_table(table).example()


def destination(table, indices) -> torch.Tensor:
    """The output of a lookup of `indices` (`(B,)` or `(B, bag)`) as a tensor
    on the `meta` device: `(B, dim)` in the table's dtype, no storage."""
    t = as_table(table)
    ndim = len(getattr(indices, "shape", np.shape(indices)))
    if ndim not in (1, 2):
        raise ValueError(f"indices must be 1-D or 2-D, got {ndim}-D")
    batch = (indices.shape if hasattr(indices, "shape")
             else np.shape(indices))[0]
    return torch.empty((batch, featuresize(t)), dtype=t.dtype, device="meta")
