"""Column (feature-dim) sharding (counterpart of
`embeddingtables_tpu/parallel/colshard.py`).

The other decomposition of a `(V, D)` table beside `sharded.py`'s mod rows:
the rank of flat index d owns the feature slice `[d * D/n, (d+1) * D/n)` of
EVERY row, the feature dim padded up to a multiple of n.

  - No index routing: every rank gathers the whole batch's ids against its
    slice, so hot-row skew costs nothing (no row has an owner).
  - Lookup: all-gather this rank's `(b,)` or `(b, bag)` ids, gather
    `(B, D/n)` from the slice with `gather_rows`, scale and sum the bags,
    then ONE all-to-all of `(n, B/n, D/n)` blocks turns the
    (batch-replicated, column-sharded) rows into this rank's
    (batch-sharded, column-complete) `(b, D)`.
  - Update: the same exchange transposed (every example's delta for this
    rank's columns), then a dense `(V, D/n)` f32 gradient of the slice
    (`optim._dense_grad`: `index_add_`, or `hot_accumulate` for a slice of
    at most 512 padded rows and a width that divides by 128). A rank writes
    only its own columns, so the update is race-free.
  - Row facts that cross the slices ride ONE fused `(V, 2)` all-reduce of
    `[sumsq, touched]`: `touched` is any nonzero gradient element over all
    columns, the full-row sum of squares serves `clipnorm` and row-wise
    AdaGrad's `sumsq / dim` (the true width, not the padded one). Plain SGD
    without decay or clip skips it. AdaGrad's `(V,)` accumulator is
    replicated and advances identically on every rank; Adam's moments and
    FTRL's z, n are per coordinate and split like the table.

Column sharding takes one mesh axis. Each rank holds only its slice; the
optimizer states are the JAX layouts at local shapes (None for SGD, the
replicated `(V,)` accumulator for AdaGrad, `SparseAdamState` /
`SparseFTRLState` of `(V, D/n)` slices). Stochastic rounding draws each
rank's noise from its own generator (JAX folds the column index into one
key: ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cuda.gather import gather_rows
from ..ops.ensemble import StackedTables
from ..ops.sparse_update import SparseEmbeddingUpdate
from ..optim import (SparseAdamState, SparseFTRL, SparseFTRLState,
                     SparseLazyAdam, SparseRowWiseAdaGrad, SparseSGD,
                     _dense_grad, ftrl_init_arrays)
from ..rounding import stochastic_cast
from ..tables import SimpleEmbedding, as_table
from ..types import cdiv
from .sharded import Exchange, _fold_combiner


class ColShardedStackedTables(nn.Module):
    """A (stacked) table column-sharded over one mesh axis.

    data:    this rank's `(vocab, cols_local)` slice (a buffer): columns
             `[me * cols_local, (me + 1) * cols_local)` of every row of the
             table padded to `n * cols_local` features.
    offsets: per-table global row offsets into the stacked vocab.
    dim:     the true (unpadded) feature width.
    """

    def __init__(self, data: torch.Tensor, offsets: Sequence[int], dim: int,
                 axis: str, mesh):
        super().__init__()
        if not isinstance(axis, str):
            raise NotImplementedError(
                "column sharding takes one mesh axis (JAX's "
                "parallel/colshard.py); row-shard on a multi-axis placement")
        self.register_buffer("data", data)
        self.offsets = tuple(int(o) for o in offsets)
        self.dim, self.axis, self.mesh = int(dim), axis, mesh
        self.exchange = Exchange(mesh, axis)
        if data.shape[1] != cdiv(self.dim, self.exchange.n):
            raise ValueError(f"{self.dim} columns over {self.exchange.n} "
                             f"ranks are {cdiv(self.dim, self.exchange.n)} a "
                             f"rank, got {data.shape[1]}")

    @property
    def n_shards(self) -> int:
        return self.exchange.n

    @property
    def vocab(self) -> int:
        return self.data.shape[0]

    @property
    def cols_local(self) -> int:
        return self.data.shape[1]

    @property
    def ntables(self) -> int:
        return len(self.offsets) - 1

    @classmethod
    def shard(cls, mesh, axis: str, tables) -> "ColShardedStackedTables":
        """Stack `tables` (a list of tables or tensors, a `StackedTables`,
        or one table) along the vocab axis and keep this rank's columns.
        Every rank must pass the same tables."""
        if isinstance(tables, StackedTables):
            st = tables
        elif isinstance(tables, (list, tuple)):
            st = StackedTables.stack(tables)
        else:
            t = as_table(tables)
            data = t.data if isinstance(t, SimpleEmbedding) else t.rows(
                torch.arange(t.spec.vocab, device=t.example().device))
            st = StackedTables(data, (0, t.spec.vocab), t.spec.dim)
        ex = Exchange(mesh, axis)
        dim = st.data.shape[1]
        return cls(col_slice(st.data, ex.me, ex.n), st.offsets, dim, axis,
                   mesh)

    def unshard(self) -> torch.Tensor:
        """The dense `(vocab, dim)` table on every rank (a collective)."""
        return col_unslice(self.exchange.gather_flat(self.data), self.dim)

    def table(self, t: int) -> torch.Tensor:
        """One member table, dense (a collective; test oracle)."""
        return self.unshard()[self.offsets[t]:self.offsets[t + 1]]


def col_slice(x: torch.Tensor, me: int, n: int) -> torch.Tensor:
    """Columns `[me * cl, (me + 1) * cl)` of `(V, D)` padded with zeros to
    `n * cl` features, `cl = cdiv(D, n)` (a copy)."""
    cl = cdiv(x.shape[1], n)
    part = x[:, me * cl:(me + 1) * cl]
    short = cl - part.shape[1]
    if short:
        part = torch.cat([part, torch.zeros(
            (x.shape[0], short), dtype=x.dtype, device=x.device)], dim=1)
    return part.contiguous().clone()


def col_unslice(slices: torch.Tensor, dim: int) -> torch.Tensor:
    """`(n, V, cl)` slices in flat order -> the `(V, dim)` table."""
    n, v, cl = slices.shape
    return slices.permute(1, 0, 2).reshape(v, n * cl)[:, :dim].contiguous()


def col_sharded_lookup(mesh, ct: ColShardedStackedTables, idx, *,
                       batch_sharded: bool = True, reducing=None,
                       combiner: str = "sum", weights=None,
                       pad_idx: int | None = None) -> torch.Tensor:
    """Lookup on a column-sharded table: this rank's block `(b,)` or
    `(b, bag)` of global stacked row ids (the global batch when not
    `batch_sharded`) -> `(b, dim)`, the same block.

    reducing: override bag detection; False takes a 2-D stream as rows
    (`(b, T)` -> `(b, T, dim)`). combiner / weights `(b, bag)` / pad_idx:
    the single-device `lookup` contract, folded into one per-occurrence
    scale that rides the id all-gather (pads go to row 0 with scale 0)."""
    ex = ct.exchange
    n, cl = ex.n, ct.cols_local
    idx = torch.as_tensor(idx).to(ct.data.device, torch.int32)
    if reducing is None:
        reducing = idx.dim() == 2
    scale = None
    if weights is not None or combiner != "sum" or pad_idx is not None:
        if not reducing and idx.dim() == 2:
            raise NotImplementedError(
                "combiner/weights/pad_idx with reducing=False (ensemble "
                "layouts) is not supported here — fold per-table masks "
                "outside, as the planner group does")
        idx, scale = _fold_combiner(idx, combiner, weights, pad_idx)
    gidx = ex.gather_batch(idx) if batch_sharded else idx
    part = gather_rows(ct.data, gidx.reshape(-1).contiguous()).reshape(
        tuple(gidx.shape) + (cl,))
    if scale is not None:
        gs = ex.gather_batch(scale) if batch_sharded else scale
        part = part * gs[..., None].to(part.dtype)
    if reducing:
        part = part.sum(dim=1)
    if not batch_sharded:
        # Every rank assembles the whole features of the whole batch.
        slices = ex.gather_flat(part)                  # (n, B, ..., cl)
        full = slices.movedim(0, -2)
    else:
        b = part.shape[0]
        inner = tuple(part.shape[1:-1])
        blocks = part.reshape((n, b // n) + inner + (cl,))
        got = ex.all_to_all(blocks)                    # (n, b/n, ..., cl)
        full = got.movedim(0, -2)
    full = full.reshape(tuple(full.shape[:-2]) + (n * cl,))
    return full[..., :ct.dim]


def init_col_row_state(mesh, ct: ColShardedStackedTables, opt):
    """Fresh optimizer state of a column-sharded stack, placed like the
    table: None for SGD; the replicated `(V,)` f32 accumulator for
    row-wise AdaGrad (rows span every slice); lazy Adam's zero `(m, v,
    count)` and FTRL's `(z, n)` solved from the weights, as `(V,
    cols_local)` slices (the padded columns get z = 0, n = initial_accum,
    which is harmless)."""
    if isinstance(opt, SparseLazyAdam):
        return opt.init(ct.data)
    if isinstance(opt, SparseFTRL):
        return SparseFTRLState(*ftrl_init_arrays(
            ct.data, opt.lr, opt.beta, opt.l1, opt.l2, opt.initial_accum))
    if isinstance(opt, SparseRowWiseAdaGrad):
        return torch.full((ct.vocab,), float(opt.initial_accum),
                          dtype=torch.float32, device=ct.data.device)
    return None


def _opt_kind(opt) -> str:
    for cls, kind in ((SparseRowWiseAdaGrad, "adagrad"),
                      (SparseLazyAdam, "adam"), (SparseFTRL, "ftrl"),
                      (SparseSGD, "sgd")):
        if isinstance(opt, cls):
            return kind
    raise NotImplementedError(type(opt).__name__)


def _slice_grad(ct: ColShardedStackedTables, upd: SparseEmbeddingUpdate, opt,
                batch_sharded: bool) -> torch.Tensor:
    """The dense `(V, cols_local)` f32 gradient of this rank's slice: every
    example's delta for these columns (the transposed all-to-all), fanned
    out over the bags and weighted, accumulated by `optim._dense_grad`
    (ids outside `[-V, V)` dropped)."""
    ex = ct.exchange
    n, cl = ex.n, ct.cols_local
    device = ct.data.device
    idx = torch.as_tensor(upd.indices).to(device, torch.int32)
    w = (torch.ones(idx.shape, dtype=torch.float32, device=device)
         if upd.weights is None
         else torch.as_tensor(upd.weights).to(device, torch.float32))
    d = torch.as_tensor(upd.delta).to(device).float()
    d = torch.nn.functional.pad(d, (0, n * cl - d.shape[1]))
    if batch_sharded:
        gidx, gw = ex.gather_batch(idx), ex.gather_batch(w)
        bl = d.shape[0]
        blocks = d.reshape(bl, n, cl).transpose(0, 1)   # (n, b, cl)
        gdelta = ex.all_to_all(blocks).reshape(n * bl, cl)
    else:
        gidx, gw = idx, w
        gdelta = d[:, ex.me * cl:(ex.me + 1) * cl]
    vals = gdelta
    if gidx.dim() == 2:
        vals = torch.repeat_interleave(vals, gidx.shape[1], dim=0)
    vals = vals * gw.reshape(-1)[:, None]
    return _dense_grad(ct.data, gidx.reshape(-1), vals,
                       getattr(opt, "dense_grad_dtype", None))


def col_sharded_update(mesh, ct: ColShardedStackedTables,
                       upd: SparseEmbeddingUpdate, opt, accum=None, *,
                       batch_sharded: bool = True, lr=None, generator=None):
    """Sparse update of a column-sharded table, in place: SGD, row-wise
    AdaGrad, lazy Adam or FTRL-Proximal, with weight decay, `clipnorm`,
    `dense_grad_dtype` and stochastic rounding (`generator`: this rank's
    noise). `upd` is this rank's block of a lazy update of global ids.
    `accum` per optimizer (`init_col_row_state`): None for SGD (returns
    `ct`), else the state, advanced in place (returns `(ct, state)`; Adam's
    count is a new tensor). Each branch mirrors its `optim.*_dense_body`;
    the bodies cannot be called directly because of the collective in the
    middle."""
    kind = _opt_kind(opt)
    use_sr = bool(getattr(opt, "stochastic_rounding", False))
    if use_sr and generator is None:
        raise ValueError(
            "opt.stochastic_rounding=True: pass this rank's torch.Generator "
            "as generator= (the train loops pass one)")
    if kind == "sgd" and accum is not None:
        raise ValueError("accum is optimizer state; SparseSGD takes none "
                         "(and returns only the table)")
    if kind != "sgd" and accum is None:
        raise ValueError(f"{type(opt).__name__} needs accum= state "
                         "(init_col_row_state)")
    if lr is not None and kind == "ftrl":
        raise ValueError(
            "SparseFTRL cannot change lr per step: alpha is baked into "
            "the accumulated z state")
    lr_val = opt.lr if lr is None else lr
    wd = getattr(opt, "weight_decay", 0.0)
    clip = getattr(opt, "clipnorm", None)
    gen = generator if use_sr else None
    data = ct.data
    with torch.no_grad():
        grad = _slice_grad(ct, upd, opt, batch_sharded)
        if kind == "sgd" and wd == 0.0 and clip is None:
            data.copy_(stochastic_cast(data.float() - lr_val * grad,
                                       data.dtype, gen))
            return ct
        # ONE fused (V, 2) all-reduce of [sumsq, touched]: the padded
        # columns carry zero gradient, so they add nothing.
        stats = torch.stack([(grad * grad).sum(dim=1),
                             torch.any(grad != 0.0, dim=1).float()], dim=1)
        ct.exchange.sum_all(stats)
        sumsq, touched = stats[:, 0], stats[:, 1] > 0
        if clip is not None:
            s = torch.clamp_max(clip / torch.clamp_min(torch.sqrt(sumsq),
                                                       1e-12), 1.0)
            grad = grad * s[:, None]
            sumsq = sumsq * s * s
        tmask = touched[:, None]
        w = data.float()

        def decay(new):
            if wd != 0.0:
                new = new * torch.where(touched, 1.0 - lr_val * wd,
                                        1.0)[:, None]
            return new

        if kind == "sgd":
            data.copy_(stochastic_cast(decay(w - lr_val * grad), data.dtype,
                                       gen))
            return ct
        if kind == "adagrad":
            new_acc = accum + sumsq / ct.dim
            denom = torch.rsqrt(torch.clamp_min(new_acc + opt.eps, 1e-30))
            step = lr_val * grad * denom[:, None]
            data.copy_(stochastic_cast(
                decay(w - torch.where(tmask, step, 0.0)), data.dtype, gen))
            accum.copy_(torch.where(touched, new_acc, accum))
            return ct, accum
        if kind == "adam":
            m, v, count = accum
            t = count + 1
            m.copy_(torch.where(tmask, opt.b1 * m + (1 - opt.b1) * grad, m))
            v.copy_(torch.where(tmask, opt.b2 * v + (1 - opt.b2) * grad * grad,
                                v))
            tf = t.float()
            step = lr_val * (m / (1 - opt.b1 ** tf)) / (
                torch.sqrt(v / (1 - opt.b2 ** tf)) + opt.eps)
            data.copy_(stochastic_cast(
                decay(w - torch.where(tmask, step, 0.0)), data.dtype, gen))
            return ct, SparseAdamState(m=m, v=v, count=t)
        # FTRL-Proximal, per coordinate with the global touched mask.
        z, n_st = accum
        new_n = n_st + grad * grad
        sigma = (torch.sqrt(new_n) - torch.sqrt(n_st)) / opt.lr
        z.copy_(torch.where(tmask, z + grad - sigma * w, z))
        n_st.copy_(torch.where(tmask, new_n, n_st))
        denom = (opt.beta + torch.sqrt(n_st)) / opt.lr + opt.l2
        w_new = torch.where(torch.abs(z) > opt.l1,
                            -(z - torch.sign(z) * opt.l1) / denom, 0.0)
        data.copy_(torch.where(tmask, w_new, w).to(data.dtype))
        return ct, SparseFTRLState(z=z, n=n_st)
