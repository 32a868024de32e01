"""Host-memory-offloaded embedding tables (counterpart of
`embeddingtables_tpu/offload.py`).

The table lives in pinned host memory, so the card holds none of it and a
vocabulary larger than the card's memory trains on one card. A lookup clamps
the ids into `[0, V-1]` on the card (the table's own id contract, as in
JAX), copies them to the host, gathers the rows there into a pinned staging
buffer and copies only those `(B, D)` rows to the card. An update copies the
ids and the delta rows to the host and adds them there, duplicates
accumulating.

Both copies to the host are blocking (`.to("cpu")`): the host reads what it
copied right away, and a non-blocking copy would let it read before the
stream had written it. The rows go back to the card with a non-blocking
copy out of pinned memory, which PyTorch's host allocator keeps alive until
the copy is done.

On the CPU (`device="cpu"`, as the tests run) there is nothing to pin: the
table is a plain host tensor and the rows stay on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .tables import _as_spec
from .types import Dynamic, Static, TableSpec


def _host_tensor(x) -> torch.Tensor:
    """A tensor as it is; anything else (a numpy array) copied into a host
    tensor, float64 narrowed to float32 as in the JAX package."""
    if torch.is_tensor(x):
        return x
    arr = np.array(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def host_put(x, device=None) -> torch.Tensor:
    """A new host tensor holding `x` for `device` (CUDA unless given): in
    pinned memory for a card (a tensor already pinned is returned as it
    is), a plain host tensor for `device="cpu"`."""
    device = resolve_device(device)
    t = _host_tensor(x)
    if device.type != "cuda":
        return t.to("cpu", copy=True)
    if t.device.type == "cpu" and t.is_pinned():
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def host_rows(host: torch.Tensor, host_idx: torch.Tensor,
              device: torch.device) -> torch.Tensor:
    """Rows `host_idx` (in range, on the host) of a host table, gathered on
    the host into a staging buffer (pinned when the rows go to a card) and
    copied to `device`: `(n, D)`."""
    out = torch.empty((host_idx.numel(), host.shape[1]), dtype=host.dtype,
                      pin_memory=device.type == "cuda")
    torch.index_select(host, 0, host_idx.reshape(-1).long(), out=out)
    return out.to(device, non_blocking=True)


class HostOffloadEmbedding:
    """Embedding table resident in pinned host memory, serving rows to
    `device` (CUDA unless given).

    Implements the table protocol (`spec`, `rows`, `example`), so `lookup`,
    `lookup_vjp`, `maplookup` and `sgd_update` take it; only rows cross
    PCIe. `example()` is an empty `(0, dim)` tensor on `device`: the
    device and dtype of the rows it returns.
    """

    def __init__(self, data, lookup: Static | Dynamic | None = None, *,
                 spec: TableSpec | None = None, name: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.data = host_put(data, self.device)       # (vocab, dim)
        self.spec = spec if spec is not None else _as_spec(self.data, lookup,
                                                           name)
        self._example = torch.empty((0, self.spec.dim), dtype=self.data.dtype,
                                    device=self.device)

    @property
    def shape(self):
        return (self.spec.vocab, self.spec.dim)

    @property
    def dtype(self):
        return self.spec.dtype

    def example(self) -> torch.Tensor:
        return self._example

    def _host_ids(self, idx) -> torch.Tensor:
        """Ids clamped into `[0, V-1]` on the device, then copied to the
        host (blocking)."""
        idx = torch.as_tensor(idx).to(self.device)
        return idx.clamp(0, self.spec.vocab - 1).to("cpu")

    def rows(self, idx, context=None) -> torch.Tensor:
        """Forward: clamp on the device, gather on the host, ship only the
        gathered rows: `(*idx.shape, dim)` on `device`."""
        shape = torch.as_tensor(idx).shape
        out = host_rows(self.data, self._host_ids(idx), self.device)
        return out.reshape(*shape, self.spec.dim)

    def replace_data(self, data) -> "HostOffloadEmbedding":
        return HostOffloadEmbedding(data, spec=self.spec, device=self.device)

    def scatter_apply(self, idx, delta: torch.Tensor) -> "HostOffloadEmbedding":
        """Update: ship the delta rows host-ward and add them there, in
        place, duplicates accumulating. Returns the table."""
        hidx = self._host_ids(idx).reshape(-1).long()
        hdelta = delta.reshape(hidx.numel(), -1).to(self.data.dtype).to("cpu")
        self.data.index_add_(0, hidx, hdelta)
        return self

    def zeros_like(self) -> "HostOffloadEmbedding":
        return self.replace_data(torch.zeros_like(self.data))

    def materialize(self) -> torch.Tensor:
        """The table copied to `device` (a test oracle)."""
        return self.data.to(self.device)
