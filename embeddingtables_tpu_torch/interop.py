"""Carry a DLRM's weights into the port from plain numpy arrays.

The arrays are what `np.asarray` gives for the JAX package's parameters, so a
model trained there can be served here, and the tests can hold both packages
to the same weights. bfloat16 arrays arrive as the `ml_dtypes` bfloat16
numpy type, which `torch.from_numpy` refuses; they are reinterpreted bit for
bit through uint16.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .config import resolve_device
from .models.dlrm import DLRM, DLRMConfig
from .ops.ensemble import StackedTables
from .optim import SparseOptState


def tensor_from_array(arr, device) -> torch.Tensor:
    """numpy array -> tensor on `device`, bfloat16 carried bit for bit."""
    arr = np.array(arr)          # a private, writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.int16)
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def dlrm_from_arrays(cfg: DLRMConfig, bottom: Sequence, top: Sequence,
                     table_data, offsets: Sequence[int],
                     device=None, emb_accum=None) -> DLRM:
    """Build the port's `DLRM` on `device` (CUDA unless given) from numpy
    arrays: `bottom`/`top` are lists of `(W (fan_in, fan_out), b)` pairs,
    `table_data` the stacked `(sum V, dim)` table, `offsets` its T+1 row
    offsets, and `emb_accum` the row-wise-AdaGrad accumulator `(sum V,)`
    (None: SGD's empty state), so both packages train from one state."""
    device = resolve_device(device)

    def mlp(layers):
        return [(tensor_from_array(w, device), tensor_from_array(b, device))
                for w, b in layers]

    tables = StackedTables(tensor_from_array(table_data, device),
                           tuple(offsets), cfg.dim)
    state = None if emb_accum is None else \
        SparseOptState(accum=tensor_from_array(emb_accum, device))
    return DLRM(cfg, mlp(bottom), mlp(top), tables, state)
