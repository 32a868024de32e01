"""Bounded-range segment sum: a hand-written CUDA kernel and its plain version.

Counterpart of `embeddingtables_tpu/ops/pallas/segsum.py`:

  - `hot_accumulate(rows, vals, num_segments)`: `(n,) int32 x (n, D) ->
    (num_segments, D)` float32, `out[s] = sum of vals[j] with rows[j] == s`.
    Ids outside `[0, num_segments)` are dropped. `D` and `num_segments`
    must be multiples of 128, as in the JAX package. `compute_dtype`
    bfloat16 (the default) rounds each value to bf16 before the float32
    accumulation, as the TPU kernel's bf16 matmul does; float32 accumulates
    the values as they are. `n == 0` gives zeros.

A CUDA tensor goes to the kernel in `csrc/segsum.cu`; a CPU tensor to the
plain version (`hot_accumulate_plain`), which is also what the kernel is
checked against on the card. The kernel combines values with atomics, so the
order of its float32 additions varies from run to run. The wrapper counts
its launches in `hot_accumulate.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _lib

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "et_hot_accumulate": [_P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _P],
}
_COMPUTE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block's (num_segments, slice) accumulator may take: two
# blocks fit in an SM's 228 KB.
_SMEM_BUDGET = 96 * 1024


def _validate(rows, vals, num_segments, compute_dtype) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError(f"rows must be 1-D int32, got {rows.dtype} {tuple(rows.shape)}")
    if vals.dim() != 2 or vals.shape[0] != rows.shape[0]:
        raise ValueError(f"values must be ({rows.shape[0]}, D), got {tuple(vals.shape)}")
    d = vals.shape[1]
    if d % 128 != 0:
        raise ValueError(f"feature dim {d} must be a multiple of 128")
    if num_segments % 128 != 0:
        raise ValueError(
            f"num_segments {num_segments} must be a multiple of 128")
    if compute_dtype not in _COMPUTE_CODE:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if rows.device != vals.device:
        raise ValueError(f"rows on {rows.device}, values on {vals.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vals.device}")


def hot_accumulate_plain(rows: torch.Tensor, vals: torch.Tensor,
                         num_segments: int,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch `hot_accumulate`: dropped ids go to a spare row that is
    cut off."""
    r = rows.long()
    r = torch.where((r >= 0) & (r < num_segments), r, num_segments)
    out = torch.zeros((num_segments + 1, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, r, vals.to(compute_dtype).float())
    return out[:num_segments]


def _column_slice(num_segments: int, d: int) -> int:
    ds = 128
    while ds > 1 and num_segments * ds * 4 > _SMEM_BUDGET:
        ds //= 2
    if num_segments * ds * 4 > _SMEM_BUDGET:
        raise ValueError(f"num_segments {num_segments} does not fit the "
                         f"{_SMEM_BUDGET}-byte shared-memory accumulator")
    return min(ds, d)


def hot_accumulate(rows: torch.Tensor, vals: torch.Tensor, num_segments: int,
                   *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Bounded-range segment sum `(n,) int32 x (n, D) -> (num_segments, D)`
    float32; ids outside `[0, num_segments)` are dropped."""
    _validate(rows, vals, num_segments, compute_dtype)
    n, d = vals.shape
    if n == 0:
        return torch.zeros((num_segments, d), dtype=torch.float32,
                           device=vals.device)
    if vals.device.type == "cpu":
        return hot_accumulate_plain(rows, vals, num_segments, compute_dtype)
    rows = rows.contiguous()
    vals = vals.float().contiguous()
    out = torch.zeros((num_segments, d), dtype=torch.float32,
                      device=vals.device)
    ds = _column_slice(num_segments, d)
    # About two blocks per SM in all, each over at least 4 * num_segments
    # occurrences, so the flush of its partial sums stays a small share.
    blocks_x = max(1, min(-(-2 * _lib.sm_count(vals) // (d // ds)),
                          n // (4 * num_segments)))
    lib = _lib.load("segsum", _SIGNATURES)
    with torch.cuda.device(vals.device):
        err = lib.et_hot_accumulate(rows.data_ptr(), vals.data_ptr(),
                                    out.data_ptr(), n, d, num_segments, ds,
                                    _COMPUTE_CODE[compute_dtype], blocks_x,
                                    _lib.stream_of(vals))
    _lib.check(lib, err, "hot_accumulate")
    hot_accumulate.launches += 1
    return out


hot_accumulate.launches = 0
