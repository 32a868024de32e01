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
checked against on the card. On the card `num_segments` is at most 14,464
(a 16-byte column slice of every segment in one block's shared memory). The
kernel adds within a block with shared-memory atomics, so the order of its
float32 additions varies from run to run; across blocks the order is fixed.
The wrapper counts its launches in `hot_accumulate.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _lib

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "et_hot_accumulate": [_P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT,
                          _P],
    "et_hot_accumulate_clusters_that_fit": [_I64, _INT, _INT, _INT,
                                            ctypes.POINTER(_INT)],
}
_COMPUTE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may take on Hopper (227 KB), and the most its
# (num_segments, slice) f32 accumulator takes while a narrower slice is
# open: past it, zeroing the accumulator and reducing it across the cluster
# cost more than wider value rows save.
_SMEM_MAX = 232_448
_SMEM_PREFERRED = 96 * 1024
_MAX_CLUSTERS = 32    # clusters per column slice the combine adds (`kMaxClusters`)
_fits: dict = {}


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


def _column_slice(num_segments: int) -> int:
    """The widest column slice (128 down to 4) whose f32 accumulator for
    every segment stays within `_SMEM_PREFERRED`, else the narrowest that
    fits one block's shared memory."""
    ds = 128
    while ds > 4 and num_segments * ds * 4 > _SMEM_PREFERRED:
        ds //= 2
    if num_segments * ds * 4 > _SMEM_MAX:
        raise ValueError(f"num_segments {num_segments} does not fit the "
                         f"{_SMEM_MAX}-byte shared-memory accumulator")
    return ds


def _clusters(lib, n: int, d: int, num_segments: int, ds: int,
              compute: int, device) -> int:
    """Clusters of 8 blocks per column slice: as many as the card runs at
    once (one wave; a second wave for a few clusters would double the
    time), and few enough that their (num_segments, D) partial sums stay
    under 1/8 of the value bytes (written once, read once: 2 C S <= n / 8)."""
    key = (d, num_segments, ds, compute, device)
    if key not in _fits:
        fit = _INT(0)
        _lib.check(lib, lib.et_hot_accumulate_clusters_that_fit(
            d, num_segments, ds, compute, ctypes.byref(fit)),
            "hot_accumulate occupancy")
        _fits[key] = fit.value
    return max(1, min(_MAX_CLUSTERS, _fits[key] // (d // ds),
                      n // (16 * num_segments)))


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
    if vals.data_ptr() % 16:                  # the kernel loads 16 bytes
        vals = vals.clone()
    lib = _lib.load("segsum", _SIGNATURES)
    ds = _column_slice(num_segments)
    compute = _COMPUTE_CODE[compute_dtype]
    with torch.cuda.device(vals.device):
        clusters = _clusters(lib, n, d, num_segments, ds, compute,
                             vals.device)
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=vals.device)
    scratch = (torch.empty((clusters, num_segments, d), dtype=torch.float32,
                           device=vals.device) if clusters > 1 else None)
    with torch.cuda.device(vals.device):
        err = lib.et_hot_accumulate(
            rows.data_ptr(), vals.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, d,
            num_segments, ds, compute, clusters,
            _lib.stream_of(vals))
    _lib.check(lib, err, "hot_accumulate")
    hot_accumulate.launches += 1
    return out


hot_accumulate.launches = 0
