"""Sorted-run scatter (the fused sparse update): a hand-written CUDA kernel
and its plain version.

Counterpart of `embeddingtables_tpu/ops/pallas/scatter.py`:

  - `scatter_add_rows_sorted(table, rows, vals, scale)`: over rows sorted
    ascending, `table[r] += scale * sum(run of r) vals`, the run summed in
    float32 and the row rounded once to the table dtype. Each unique row is
    read once and written once, in place. Rows `< 0` are padding; rows
    `>= V` are dropped (the Pallas kernel would copy out of bounds). With
    `accum=` it runs the row-wise AdaGrad epilogue instead:
    `accum[r] += mean(acc^2)`, then
    `table[r] += (scale * acc) * rsqrt(max(accum[r] + eps, 1e-30))` with
    `scale = -lr`.
  - `scatter_update(table, rows, vals, scale)`: any row order; a stable sort
    of the rows, a permute of the values with `gather_rows`, then the
    run-scatter. Equal to `table.index_add_(0, rows, scale * vals)` up to
    the order of the float32 additions.
  - `scatter_sgd(table, delta, idx_result, cols, lr)`: the SGD step of an
    indexer result, `table[r] -= lr * sum delta[cols[k]]` over the
    occurrences k of r, each occurrence's row being `unique[group_of[k]]`.

The order of the float32 additions: pieces at run starts and at multiples of
`RUN_WINDOW` (L) positions, each summed in stream order, then each run's
pieces folded left to right, `((p0 + p1) + p2) + ...`. A run that crosses no
multiple of L is one piece, summed in stream order.

Tables are float32 or bfloat16, of any width; values are float32. The
kernel has three width classes by the row's vector units (4 elements when
D and the pointers allow 16-byte accesses, else 1): narrow (fewer than 32
units: a group of P lanes a window, P the next power of two), 32 to 128 (a
warp a window) and wide (more than 128: a block a window, a slice of the
row a warp). Each update is two kernel launches; only AdaGrad on rows
wider than `_WIDE_COLS` walks column chunks twice. A CUDA tensor goes to
the kernel in `csrc/scatter.cu`; a CPU tensor to the plain version
(`scatter_add_rows_sorted_plain`), which is also what the kernel is checked
against on the card: it makes the same float32 additions in the same order.
The wrapper counts its launches in `scatter_add_rows_sorted.launches` (one
a call), and each call's width class in `scatter_add_rows_sorted.classes`
(a `Counter` keyed "narrow", "mid" and "wide"); the entry point reports the
class and the device kernels it launched (`scatter_add_rows_sorted.kernels`,
of the last call) in the same call.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _lib
from .gather import gather_rows

# L: the window length of the summation order; `kRunWindow` in
# csrc/scatter.cu, checked against it when the library loads.
RUN_WINDOW = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _INT, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "et_scatter_add_rows_sorted": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                   _INT, _F32, _F32, _P, _P],
    "et_run_window": [],
}
_CLASSES = ("narrow", "mid", "wide")
# The widest rows, in elements, that the kernel holds in one pass
# (`kWideCols` in csrc/scatter.cu): the scratch is at most this wide, and
# only the AdaGrad epilogue of wider rows takes an (n,) f32 scratch of sums
# of squares, walking the rows in column chunks of this width twice.
_WIDE_COLS = 4096


def _validate(table, rows, vals, accum) -> None:
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype must be float32 or bfloat16, got {table.dtype}")
    if table.dim() != 2:
        raise ValueError(f"table must be (V, D), got shape {tuple(table.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError(f"rows must be 1-D int32, got {rows.dtype} {tuple(rows.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {vals.dtype}")
    if vals.shape != (rows.shape[0], table.shape[1]):
        raise ValueError(f"values must be {(rows.shape[0], table.shape[1])}, "
                         f"got {tuple(vals.shape)}")
    tensors = [table, rows, vals]
    if accum is not None:
        if accum.dtype != torch.float32 or accum.shape != (table.shape[0],):
            raise ValueError(f"accum must be ({table.shape[0]},) float32, got "
                             f"{accum.dtype} {tuple(accum.shape)}")
        tensors.append(accum)
    if any(t.device != table.device for t in tensors):
        raise ValueError("table, rows, values and accum must be on one device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table, rows, values and accum must be contiguous")


def _level_sums(group: torch.Tensor, level: torch.Tensor, x: torch.Tensor,
                groups: int) -> torch.Tensor:
    """float32 sums of the rows of `x` by `group`, each group's rows added
    from zero in `level` order: level p adds the p-th row of every group at
    once, and the groups of one level are distinct."""
    acc = torch.zeros((groups, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    order = torch.argsort(level, stable=True)
    group, x = group[order], x[order]
    off = 0
    for count in torch.bincount(level[order]).tolist():
        acc.index_add_(0, group[off:off + count], x[off:off + count])
        off += count
    return acc


def _run_sums(rows: torch.Tensor, vals: torch.Tensor, v: int):
    """(run start positions, float32 run sums) of the valid runs of `rows`,
    in the kernel's order: pieces at run starts and at multiples of
    RUN_WINDOW, each summed in stream order, then each run's pieces folded
    left to right."""
    r = rows.long()
    valid = (r >= 0) & (r < v)
    start = valid.clone()
    start[1:] &= r[1:] != r[:-1]
    starts = start.nonzero().squeeze(1)
    if starts.numel() == 0:
        return starts, torch.zeros((0, vals.shape[1]), dtype=torch.float32,
                                   device=vals.device)
    pos = torch.arange(r.numel(), device=r.device)
    piece_start = start | (valid & (pos % RUN_WINDOW == 0))
    pieces = piece_start.nonzero().squeeze(1)
    piece = torch.cumsum(piece_start, 0) - 1        # at valid positions
    ks = valid.nonzero().squeeze(1)
    piece_sums = _level_sums(piece[ks], ks - pieces[piece[ks]], vals[ks],
                             pieces.numel())
    run_of_piece = (torch.cumsum(start, 0) - 1)[pieces]
    first_piece = piece[starts]
    rank = torch.arange(pieces.numel(), device=r.device) - first_piece[run_of_piece]
    return starts, _level_sums(run_of_piece, rank, piece_sums, starts.numel())


def scatter_add_rows_sorted_plain(table: torch.Tensor, sorted_rows: torch.Tensor,
                                  sorted_vals: torch.Tensor, scale=1.0, *,
                                  accum: torch.Tensor | None = None,
                                  eps=0.0) -> torch.Tensor:
    """Plain PyTorch `scatter_add_rows_sorted`, in place; returns `table`."""
    starts, acc = _run_sums(sorted_rows, sorted_vals, table.shape[0])
    if starts.numel() == 0:
        return table
    rows = sorted_rows[starts].long()
    sc = torch.tensor(scale, dtype=torch.float32, device=table.device)
    step = sc * acc
    if accum is not None:
        a = accum[rows] + (acc * acc).mean(dim=-1)
        accum.index_copy_(0, rows, a)
        e = torch.tensor(eps, dtype=torch.float32, device=table.device)
        step = step * torch.rsqrt(torch.clamp_min(a + e, 1e-30))[:, None]
    new = table[rows].float() + step
    table.index_copy_(0, rows, new.to(table.dtype))
    return table


def _library():
    lib = _lib.load("scatter", _SIGNATURES)
    if lib.et_run_window() != RUN_WINDOW:
        raise RuntimeError(f"csrc/scatter.cu sums in windows of "
                           f"{lib.et_run_window()}, RUN_WINDOW is {RUN_WINDOW}")
    return lib


def scatter_add_rows_sorted(table: torch.Tensor, sorted_rows: torch.Tensor,
                            sorted_vals: torch.Tensor, scale=1.0, *,
                            accum: torch.Tensor | None = None,
                            eps=0.0) -> torch.Tensor:
    """`table[r] += scale * sum(run of r) vals` over ascending int32 rows, in
    place; returns `table`. `accum=` selects the row-wise AdaGrad epilogue
    (module docstring). Rows must be sorted: unsorted rows split a row into
    several runs, which race on the card."""
    _validate(table, sorted_rows, sorted_vals, accum)
    if table.device.type == "cpu":
        return scatter_add_rows_sorted_plain(table, sorted_rows, sorted_vals,
                                             scale, accum=accum, eps=eps)
    (n,), (v, d) = sorted_rows.shape, table.shape
    if n == 0 or d == 0:
        return table
    lib = _library()
    # Two f32 slots per window for the pieces of runs that cross its edges,
    # one pass's columns wide.
    scratch = torch.empty((2 * -(-n // RUN_WINDOW), min(d, _WIDE_COLS)),
                          dtype=torch.float32, device=table.device)
    ssq = None
    if accum is not None and d > _WIDE_COLS:
        ssq = torch.zeros((n,), dtype=torch.float32, device=table.device)
    info = (ctypes.c_int * 2)()         # width class, kernels launched
    with torch.cuda.device(table.device):
        err = lib.et_scatter_add_rows_sorted(
            table.data_ptr(), sorted_rows.data_ptr(), sorted_vals.data_ptr(),
            None if accum is None else accum.data_ptr(), scratch.data_ptr(),
            None if ssq is None else ssq.data_ptr(), n, v, d,
            _DTYPE_CODE[table.dtype], float(scale), float(eps),
            _lib.stream_of(table), info)
    _lib.check(lib, err, "scatter_add_rows_sorted")
    scatter_add_rows_sorted.launches += 1
    scatter_add_rows_sorted.classes[_CLASSES[info[0]]] += 1
    scatter_add_rows_sorted.kernels = info[1]
    return table


def scatter_update(table: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                   scale=1.0, *, accum: torch.Tensor | None = None,
                   eps=0.0) -> torch.Tensor:
    """Duplicate-accumulating scatter-add through sorted runs, in place:
    a stable sort of `rows`, the values permuted with `gather_rows`, then
    `scatter_add_rows_sorted` (which drops rows `< 0` and `>= V`), each
    step a telemetry phase: "update.sort", "update.permute" and
    "update.scatter"."""
    # imported here: `utils` imports the optimizers, which import this module
    from ...utils.telemetry import phase
    with phase("update.sort"):
        sorted_rows, perm = torch.sort(rows.to(torch.int32), stable=True)
    with phase("update.permute"):
        sorted_vals = gather_rows(vals.float().contiguous(),
                                  perm.to(torch.int32))
    with phase("update.scatter"):
        return scatter_add_rows_sorted(table, sorted_rows, sorted_vals, scale,
                                       accum=accum, eps=eps)


def scatter_sgd(table: torch.Tensor, delta: torch.Tensor, idx_result,
                cols: torch.Tensor, lr) -> torch.Tensor:
    """Fused sparse SGD from an `IndexerResult` and the occurrences' delta
    columns (`flatten_indices`), in place through `scatter_update`; returns
    `table`. Rows < 0 are padding and rows >= V are dropped, as in JAX's
    `scatter_sgd`: the indexer's `unique` folds every id below -1 into -1,
    so a negative id cannot be resolved from the result."""
    rows = idx_result.unique[idx_result.group_of.long()]
    vals = delta.float().index_select(0, cols.to(delta.device).long())
    return scatter_update(table, rows.to(table.device),
                          vals.to(table.device), -float(lr))


scatter_add_rows_sorted.launches = 0
scatter_add_rows_sorted.classes = collections.Counter()
scatter_add_rows_sorted.kernels = 0
