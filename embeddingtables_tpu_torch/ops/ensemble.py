"""`StackedTables`: the one-array ensemble container (counterpart of
`embeddingtables_tpu/ops/ensemble.py::StackedTables`).

N same-width tables concatenated along the vocab axis into one
`(sum vocab_i, dim)` tensor with per-table row offsets, so an ensemble
lookup is ONE gather with offset-shifted ids.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..tables import SimpleEmbedding, as_table


class StackedTables(nn.Module):
    """`data` is a buffer (the sparse optimizers update it outside autograd);
    `offsets` is the Python tuple of T+1 row offsets."""

    def __init__(self, data: torch.Tensor, offsets: Sequence[int], dim: int):
        super().__init__()
        self.register_buffer("data", data)
        self.offsets = tuple(int(o) for o in offsets)
        self.dim = dim
        self.register_buffer("_starts", torch.tensor(
            self.offsets[:-1], dtype=torch.int32, device=data.device),
            persistent=False)

    @classmethod
    def stack(cls, tables: Sequence) -> "StackedTables":
        ts = [as_table(t) for t in tables]
        dims = {t.spec.dim for t in ts}
        if len(dims) != 1:
            raise ValueError(f"StackedTables requires equal feature dims, got {dims}")
        datas = [t.data if isinstance(t, SimpleEmbedding) else
                 t.rows(torch.arange(t.spec.vocab, device=t.example().device))
                 for t in ts]
        offs, acc = [0], 0
        for d in datas:
            acc += d.shape[0]
            offs.append(acc)
        return cls(torch.cat(datas, dim=0), tuple(offs), ts[0].spec.dim)

    @property
    def ntables(self) -> int:
        return len(self.offsets) - 1

    @property
    def vocabs(self) -> tuple:
        return tuple(self.offsets[i + 1] - self.offsets[i]
                     for i in range(self.ntables))

    def shift_indices(self, idx_list) -> torch.Tensor:
        """Per-table local ids -> global rows of the stacked array, stacked
        to `(T, B[, bag])` int32. Accepts a sequence of T tensors or one
        `(T, B[, bag])` tensor."""
        idx = torch.stack(list(idx_list)) if not torch.is_tensor(idx_list) \
            else idx_list
        idx = idx.to(device=self._starts.device, dtype=torch.int32)
        return idx + self._starts.view(-1, *([1] * (idx.dim() - 1)))

    def table(self, t: int) -> SimpleEmbedding:
        return SimpleEmbedding(self.data[self.offsets[t]:self.offsets[t + 1]])
