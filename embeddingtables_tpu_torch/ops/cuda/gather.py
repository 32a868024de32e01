"""Forward-lookup gathers: hand-written CUDA kernels and their plain versions.

Counterpart of `embeddingtables_tpu/ops/pallas/gather.py`:

  - `gather_rows`: `(V, D) x (n,) int32 -> (n, D)`, `O[i] = T[idx[i]]`.
  - `gather_bags`: `(V, D) x (n, bag) int32 -> (n, D)`, `O[i] = sum_k T[idx[i, k]]`,
    summed in float32 and cast once to the table dtype.

Both follow the JAX lookup's id contract: an id in `[-V, 0)` wraps to
`id + V`; any other out-of-range id gives a row of NaN, and a bag holding one
sums to NaN. Tables are float32 or bfloat16.

A CUDA tensor goes to the kernel in `csrc/gather.cu`; a CPU tensor goes to the
plain PyTorch version (`gather_rows_plain`, `gather_bags_plain`), which is
also what the kernel is checked against on the card. The kernels take any
width and any table base aligned to its element: rows off the 16-byte grid
(DeepFM's fused D + 1 = 129, a table viewed from inside its buffer) take the
realigning vector kernels. Each wrapper counts its launches in
`<wrapper>.launches`, and `gather_rows` its launches at each row width in
`gather_rows.widths` (a `Counter` keyed by D).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "et_gather_rows": [_P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
    "et_gather_bags": [_P, _P, _P, _I64, _I64, _I64, _I64, _INT, _INT, _P],
}


def _validate(table: torch.Tensor, idx: torch.Tensor, idx_ndim: int) -> None:
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype must be float32 or bfloat16, got {table.dtype}")
    if table.dim() != 2:
        raise ValueError(f"table must be (V, D), got shape {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {idx.dtype}")
    if idx.dim() != idx_ndim:
        raise ValueError(f"ids must be {idx_ndim}-D, got shape {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"ids on {idx.device}, table on {table.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and ids must be contiguous")


def _resolve(idx: torch.Tensor, v: int):
    """(safe int64 ids, in-range mask) under the wrap/NaN id contract."""
    i = idx.long()
    i = torch.where(i < 0, i + v, i)
    ok = (i >= 0) & (i < v)
    return torch.where(ok, i, 0), ok


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch `gather_rows`."""
    safe, ok = _resolve(idx, table.shape[0])
    return torch.where(ok[:, None], table.index_select(0, safe), float("nan"))


def gather_bags_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch `gather_bags`: f32 sum in bag order, one cast."""
    n, bag = idx.shape
    safe, ok = _resolve(idx, table.shape[0])
    rows = table.index_select(0, safe.reshape(-1)).reshape(n, bag,
                                                           table.shape[1])
    acc = torch.zeros((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for k in range(bag):
        acc += rows[:, k]
    acc = torch.where(ok.all(dim=1)[:, None], acc, float("nan"))
    return acc.to(table.dtype)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Non-reducing gather `(V, D) x (n,) int32 -> (n, D)`."""
    _validate(table, idx, 1)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    (n,), (v, d) = idx.shape, table.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out
    lib = _lib.load("gather", _SIGNATURES)
    with torch.cuda.device(table.device):
        err = lib.et_gather_rows(table.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), n, v, d,
                                 _DTYPE_CODE[table.dtype], _lib.sm_count(table),
                                 _lib.stream_of(table))
    _lib.check(lib, err, "gather_rows")
    gather_rows.launches += 1
    gather_rows.widths[d] += 1
    return out


def gather_bags(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Reducing gather `(V, D) x (n, bag) int32 -> (n, D)`."""
    _validate(table, idx, 2)
    if table.device.type == "cpu":
        return gather_bags_plain(table, idx)
    (n, bag), (v, d) = idx.shape, table.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out
    lib = _lib.load("gather", _SIGNATURES)
    with torch.cuda.device(table.device):
        err = lib.et_gather_bags(table.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), n, bag, v, d,
                                 _DTYPE_CODE[table.dtype], _lib.sm_count(table),
                                 _lib.stream_of(table))
    _lib.check(lib, err, "gather_bags")
    gather_bags.launches += 1
    return out


gather_rows.launches = 0
gather_rows.widths = collections.Counter()
gather_bags.launches = 0
