"""Mod-row-sharded tables and the exact gather exchange (counterpart of
`embeddingtables_tpu/parallel/sharded.py`).

  - A (stacked) table is mod-row-sharded over one or more mesh axes: global
    row r lives on the rank whose flattened mesh index (`flat_index`) is
    `r % n`, at local slot `r // n`. Each rank holds only its
    `(cdiv(V, n), D)` shard, and the sparse optimizer's state of those rows,
    as buffers. Mod sharding balances skewed vocabularies: every rank owns
    1/n of every table.
  - Lookup: all-gather the batch's ids over the data axis, gather the owned
    rows with `gather_rows` (positions this rank does not own read zero, as
    JAX's `_local_gather`), then reduce-scatter the partial rows over the
    data axis, and all-reduce them over the model axis of a 2-D mesh. Every
    position of a one-hot lookup is one real row plus zeros, so the exchange
    is exact.
  - Update (`owned_apply`): all-gather the lazy update's `(delta, ids,
    weights)` over the data axis, keep the occurrences of the rows this rank
    owns, and run the sparse optimizer's own `apply` on them. The shard then
    takes the single-device dispatch and kernels: the run-scatter for SGD
    and indexer AdaGrad, the dense bodies for AdaGrad "auto" (when it picks
    them), lazy Adam and FTRL. Disjoint ownership makes it race-free.

On a `("data", "model")` mesh, rows are sharded over the product of the axes
and the batch over `data` only (JAX's `axis=("data", "model")`). The ids are
global stacked row ids in `[0, V)`; pads are folded in as zero-scale
occurrences of a real row.

The collectives move batch-major tensors (the batch first), so each rank's
block is contiguous; the ensemble entry points take and return JAX's
table-major `(T, B, ...)` layout and transpose at the local size. Keeping
the owned occurrences reads their count on the host: one synchronization
per update.

Divergence from JAX (ROADMAP.md queue 3): JAX's shard adds each occurrence
into its row through an XLA scatter (SGD) or a dense-gradient scratch; the
port's owned stream goes through the run-scatter, which sums each row's run
in its own order before one write.

Each collective call of an `Exchange` is the telemetry phase
"exchange.<collective>" ("exchange.all_gather", "exchange.reduce_scatter",
...), and `owned_apply`'s host read of the owned count is
"update.owned_count". An `Exchange`'s `timer`, when set to a callable
`name -> context manager`, also wraps each collective call (chip_smoke.py
times them with CUDA events).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..ops.cuda.gather import gather_rows
from ..ops.ensemble import StackedTables, normalize_indices, normalize_weights
from ..ops.sparse_update import SparseEmbeddingUpdate
from ..optim import SparseAdamState, SparseFTRLState, SparseOptState, SparseSGD
from ..tables import SimpleEmbedding, as_table
from ..types import cdiv
from ..utils.telemetry import phase
from .mesh import mesh_device


def _axes_tuple(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _dims(mesh, axes) -> list:
    names = mesh.mesh_dim_names
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh axes {names} have no {missing}")
    return [names.index(a) for a in axes]


def flat_index(mesh, axes, coord=None) -> int:
    """Flattened index over `axes` (row-major) of this rank, or of the mesh
    coordinate `coord`: JAX's `_flat_axis_index`."""
    coord = mesh.get_coordinate() if coord is None else coord
    me = 0
    for d in _dims(mesh, axes):
        me = me * mesh.shape[d] + int(coord[d])
    return me


def axes_size(mesh, axes) -> int:
    n = 1
    for d in _dims(mesh, axes):
        n *= mesh.shape[d]
    return n


class Exchange:
    """The groups and indices of one placement `(mesh, axis)`: the data
    group (axis 0, the batch), the model groups (the other axes), and the
    flat group over all of them, whose group ranks map to flattened indices
    through `order` (None where they agree). `timer` (None, or a callable
    `name -> context manager`) wraps every collective call."""

    timer = None

    def __init__(self, mesh, axis):
        self.mesh, self.axes = mesh, _axes_tuple(axis)
        names = mesh.mesh_dim_names
        self.n = axes_size(mesh, self.axes)
        self.me = flat_index(mesh, self.axes)
        self.data_group = mesh.get_group(self.axes[0])
        self.n_data = axes_size(mesh, self.axes[:1])
        self.data_index = flat_index(mesh, self.axes[:1])
        self.model_groups = [mesh.get_group(a) for a in self.axes[1:]]
        self.n_model = axes_size(mesh, self.axes[1:])
        self.model_index = flat_index(mesh, self.axes[1:])
        if len(self.axes) == 1:
            self.group = self.data_group
        else:
            if sorted(self.axes) != sorted(names) or \
                    mesh.mesh.numel() != dist.get_world_size():
                raise NotImplementedError(
                    "rows sharded over several axes need a mesh of exactly "
                    "those axes over every rank of the group")
            self.group = dist.group.WORLD
        ranks = sorted(dist.get_process_group_ranks(self.group),
                       key=lambda g: dist.get_group_rank(self.group, g))
        grid = mesh.mesh
        flat = [flat_index(mesh, self.axes,
                           (grid == g).nonzero()[0].tolist()) for g in ranks]
        self.order = self.inverse = None
        if flat != list(range(self.n)):
            self.order = torch.tensor(flat)
            self.inverse = torch.argsort(self.order)

    @contextlib.contextmanager
    def timed(self, name: str):
        """The collective `name` as the telemetry phase "exchange.<name>",
        inside `timer(name)` where one is set."""
        with phase(f"exchange.{name}"), (
                contextlib.nullcontext() if self.timer is None
                else self.timer(name)):
            yield

    def _to_flat(self, x):
        """Group-rank-major chunks -> flat-index-major."""
        if self.inverse is None:
            return x
        return x.index_select(0, self.inverse.to(x.device))

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """`(b, ...)` on every data rank -> `(n_data * b, ...)`, blocks in
        data order."""
        x = x.contiguous()
        out = torch.empty((self.n_data * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with self.timed("all_gather"):
            dist.all_gather_into_tensor(out, x, group=self.data_group)
        return out

    def scatter_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums `(n_data * b, ...)` -> this rank's block `(b, ...)`
        summed over the data group, then over the model groups. bf16
        partials are summed in f32 (exact for one-hot rows) and rounded
        once."""
        dtype = x.dtype
        x = (x.float() if dtype == torch.bfloat16 else x).contiguous()
        out = torch.empty((x.shape[0] // self.n_data,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with self.timed("reduce_scatter"):
            dist.reduce_scatter_tensor(out, x, group=self.data_group)
            for g in self.model_groups:
                dist.all_reduce(out, group=g)
        return out.to(dtype)

    def sum_all(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every rank of the placement (JAX's psum over the axes),
        in place; bf16 in f32."""
        y = x.float() if x.dtype == torch.bfloat16 else x
        with self.timed("all_reduce"):
            dist.all_reduce(y, group=self.group)
        return y.to(x.dtype) if y is not x else x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """`(n, cap, ...)` buckets, bucket f for flat rank f -> the `(n,
        cap, ...)` buckets each flat rank sent here, in flat order."""
        send = x if self.order is None else x.index_select(
            0, self.order.to(x.device))
        send = send.contiguous()
        out = torch.empty_like(send)
        with self.timed("all_to_all"):
            dist.all_to_all_single(out, send, group=self.group)
        return self._to_flat(out)

    def gather_flat(self, x: torch.Tensor) -> torch.Tensor:
        """`(r, ...)` on every flat rank -> `(n, r, ...)` in flat order."""
        x = x.contiguous()
        out = torch.empty((self.n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with self.timed("all_gather"):
            dist.all_gather_into_tensor(out, x, group=self.group)
        return self._to_flat(out.view((self.n,) + tuple(x.shape)))


def _local_rows(x: torch.Tensor, ex: Exchange, rows_local: int,
               pad_value=0.0) -> torch.Tensor:
    """This rank's rows of a `(V, ...)` row-wise array: global row
    `me + j * n` at slot j, padded to `rows_local` with `pad_value`."""
    mine = x[ex.me::ex.n]
    short = rows_local - mine.shape[0]
    if short:
        pad = torch.full((short,) + tuple(x.shape[1:]), pad_value,
                         dtype=x.dtype, device=x.device)
        mine = torch.cat([mine, pad])
    return mine.contiguous().clone()


def _global_rows(x: torch.Tensor, ex: Exchange, vocab: int) -> torch.Tensor:
    """The `(V, ...)` array from every rank's `local_rows` (a collective)."""
    shards = ex.gather_flat(x)                      # (n, rows_local, ...)
    full = shards.transpose(0, 1).reshape((-1,) + tuple(x.shape[1:]))
    return full[:vocab].clone()


class ShardedStackedTables(nn.Module):
    """A (stacked) table mod-row-sharded over one or more mesh axes.

    data:    this rank's `(rows_local, dim)` shard (a buffer): global row r
             with `r % n == me` at slot `r // n`.
    offsets: per-table global row offsets into the stacked vocab.
    vocab:   total (unpadded) stacked vocab.
    axis:    the mesh axis name, or a tuple for the 2-D decomposition (rows
             over the product of the axes, the batch over the first).
    """

    def __init__(self, data: torch.Tensor, offsets: Sequence[int],
                 vocab: int, dim: int, axis, mesh):
        super().__init__()
        self.register_buffer("data", data)
        self.offsets = tuple(int(o) for o in offsets)
        self.vocab, self.dim = int(vocab), int(dim)
        self.axis = axis if isinstance(axis, str) else tuple(axis)
        self.mesh = mesh
        self.exchange = Exchange(mesh, axis)
        if data.shape[0] != cdiv(self.vocab, self.exchange.n):
            raise ValueError(f"a shard of {self.vocab} rows over "
                             f"{self.exchange.n} ranks has "
                             f"{cdiv(self.vocab, self.exchange.n)} rows, "
                             f"got {data.shape[0]}")

    @property
    def axes(self) -> tuple:
        return _axes_tuple(self.axis)

    @property
    def rows_local(self) -> int:
        return self.data.shape[0]

    @property
    def ntables(self) -> int:
        return len(self.offsets) - 1

    @classmethod
    def shard(cls, mesh, axis, tables, pad_value=0.0
              ) -> "ShardedStackedTables":
        """Stack `tables` (a list of tables or tensors, a `StackedTables`,
        or one table) along the vocab axis and keep this rank's rows. Every
        rank must pass the same tables."""
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
        vocab, dim = st.data.shape
        data = _local_rows(st.data, ex, cdiv(vocab, ex.n), pad_value)
        return cls(data, st.offsets, vocab, dim, axis, mesh)

    @classmethod
    def init_sharded(cls, mesh, axis, vocab_sizes, dim: int, *,
                     generator: torch.Generator | None = None,
                     scale: float | None = None, dtype=torch.float32,
                     device=None) -> "ShardedStackedTables":
        """Each rank draws its own shard, uniform in `[-scale, scale)`
        (default `1/sqrt(dim)`), so the full table never exists anywhere.
        `generator` should differ between ranks (by default one seeded with
        this rank's flattened index)."""
        ex = Exchange(mesh, axis)
        offs = [0]
        for v in vocab_sizes:
            offs.append(offs[-1] + int(v))
        device = mesh_device(mesh) if device is None else torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(ex.me)
        scale = 1.0 / dim ** 0.5 if scale is None else scale
        data = torch.empty((cdiv(offs[-1], ex.n), dim), dtype=torch.float32,
                           device=device)
        data.uniform_(-1.0, 1.0, generator=generator)
        return cls((data * scale).to(dtype), offs, offs[-1], dim, axis, mesh)

    def unshard(self) -> torch.Tensor:
        """The dense `(vocab, dim)` table on every rank (a collective)."""
        return _global_rows(self.data, self.exchange, self.vocab)


def shard_table(mesh, axis, table) -> ShardedStackedTables:
    """One table mod-row-sharded (`ShardedStackedTables.shard`)."""
    return ShardedStackedTables.shard(mesh, axis, table)


# ---------------------------------------------------------------------------
# Row state
# ---------------------------------------------------------------------------

def shard_row_accum(mesh, axis, st: ShardedStackedTables, state, sparse_opt):
    """This rank's rows of a single-device sparse-optimizer state, in the
    layout of the table's rows: the same state type with local shapes.
    A populated state survives whatever `sparse_opt` says (JAX dispatches
    on the state too); SGD's zero-size state becomes `sparse_opt`'s fresh
    state of the shard (JAX does so for AdaGrad only: its Adam and FTRL
    steps need a model made with their state); Adam's `count` is the global
    step, the same on every rank."""
    ex, rows = st.exchange, st.rows_local
    if isinstance(state, SparseAdamState):
        return SparseAdamState(m=_local_rows(state.m, ex, rows),
                               v=_local_rows(state.v, ex, rows),
                               count=state.count.clone())
    if isinstance(state, SparseFTRLState):
        return SparseFTRLState(z=_local_rows(state.z, ex, rows),
                               n=_local_rows(state.n, ex, rows))
    if state is not None and state.accum.numel():
        return SparseOptState(accum=_local_rows(state.accum.float(), ex, rows))
    return (sparse_opt or SparseSGD()).init(st.data)


def unshard_row_state(st: ShardedStackedTables, state):
    """The single-device state back from the shards (a collective)."""
    ex, vocab = st.exchange, st.vocab
    if isinstance(state, SparseAdamState):
        return SparseAdamState(m=_global_rows(state.m, ex, vocab),
                               v=_global_rows(state.v, ex, vocab),
                               count=state.count.clone())
    if isinstance(state, SparseFTRLState):
        return SparseFTRLState(z=_global_rows(state.z, ex, vocab),
                               n=_global_rows(state.n, ex, vocab))
    if not state.accum.numel():
        return SparseOptState(accum=state.accum.clone())
    return SparseOptState(accum=_global_rows(state.accum, ex, vocab))


def init_sharded_row_state(mesh, st: ShardedStackedTables, sparse_opt):
    """`sparse_opt`'s fresh state of this rank's shard (SGD's empty one by
    default): the state of a table made directly on the mesh."""
    return (sparse_opt or SparseSGD()).init(st.data)


def init_sharded_adam_state(mesh, st: ShardedStackedTables):
    """Lazy Adam's zero `(m, v, count)` of this rank's shard."""
    from ..optim import SparseLazyAdam
    return SparseLazyAdam().init(st.data)


def shard_adam_state(mesh, st: ShardedStackedTables, state):
    """This rank's rows of a single-device `SparseAdamState`."""
    return shard_row_accum(mesh, st.axis, st, state, None)


def unshard_adam_state(st: ShardedStackedTables, m, v, count):
    """The single-device `SparseAdamState` back (a collective)."""
    return unshard_row_state(st, SparseAdamState(m=m, v=v, count=count))


def init_sharded_ftrl_state(mesh, st: ShardedStackedTables, opt):
    """FTRL's `(z, n)` of this rank's shard, z solved for its rows."""
    return opt.init(st.data)


def shard_ftrl_state(mesh, st: ShardedStackedTables, state):
    """This rank's rows of a single-device `SparseFTRLState`."""
    return shard_row_accum(mesh, st.axis, st, state, None)


def _apply_table_major(st, state, shifted_idx, delta_t, opt, batch_sharded,
                       scale_t, lr=None, generator=None):
    """`owned_apply` of JAX's table-major `(T, B[, bag])` ids, `(T, B, D)`
    deltas and per-occurrence scale."""
    def bt(x):
        return None if x is None else torch.as_tensor(x).to(
            st.data.device).transpose(0, 1).contiguous()
    return owned_apply(st, bt(shifted_idx).to(torch.int32), bt(delta_t),
                       bt(scale_t), opt, state, batch_sharded=batch_sharded,
                       lr=lr, generator=generator)


def sharded_adam_apply(mesh, st: ShardedStackedTables, m, v, count,
                       shifted_idx, delta_t, opt, *,
                       batch_sharded: bool = True, scale_t=None, lr=None,
                       generator=None):
    """Lazy Adam on the shard through the gather exchange, in place:
    `shifted_idx (T, B[, bag])` stacked global rows, `delta_t (T, B, D)`.
    Returns `(st, m, v, count)`."""
    state = _apply_table_major(st, SparseAdamState(m=m, v=v, count=count),
                               shifted_idx, delta_t, opt, batch_sharded,
                               scale_t, lr, generator)
    return st, state.m, state.v, state.count


def sharded_ftrl_apply(mesh, st: ShardedStackedTables, z, n_state,
                       shifted_idx, delta_t, opt, *,
                       batch_sharded: bool = True, scale_t=None):
    """FTRL on the shard through the gather exchange, in place (the
    arguments of `sharded_adam_apply`). Returns `(st, z, n)`."""
    state = _apply_table_major(st, SparseFTRLState(z=z, n=n_state),
                               shifted_idx, delta_t, opt, batch_sharded,
                               scale_t)
    return st, state.z, state.n


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

def _owned_rows(shard: torch.Tensor, flat: torch.Tensor,
                ex: Exchange) -> torch.Tensor:
    """`(m,)` global ids -> `(m, D)`: the rows this rank owns, zeros at
    the positions it does not own."""
    flat = flat.reshape(-1)
    mine = torch.remainder(flat, ex.n) == ex.me
    lrow = torch.where(mine, torch.div(flat, ex.n, rounding_mode="floor"), 0)
    rows = gather_rows(shard, lrow.to(torch.int32).contiguous())
    return torch.where(mine[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


def _fold_combiner(idx: torch.Tensor, combiner: str, weights, pad_idx):
    """`(safe_idx, scale)`: the lookup's combiner, weights and pads as one
    f32 per-occurrence scale (None for a plain sum), so the exchange stays
    one weighted-sum gather. Pads go to row 0 with scale 0; mean weights
    are normalized per example."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    scale = None if weights is None else \
        torch.as_tensor(weights).to(idx.device, torch.float32)
    if pad_idx is not None:
        valid = (idx != pad_idx).float()
        idx = torch.where(idx != pad_idx, idx, 0)
        scale = valid if scale is None else scale * valid
    if combiner == "mean" and idx.dim() >= 2:
        if scale is None:
            scale = torch.full(idx.shape, 1.0 / idx.shape[-1],
                               dtype=torch.float32, device=idx.device)
        else:
            scale = scale / torch.clamp_min(scale.sum(dim=-1, keepdim=True),
                                            1e-12)
    return idx, scale


def _lookup_batch_major(st: ShardedStackedTables, idx: torch.Tensor, scale,
                       reducing: bool, batch_sharded: bool = True
                       ) -> torch.Tensor:
    """The gather exchange on batch-major ids `(b, *rest)` (the bag, if
    `reducing`, last): -> `(b, *rest without the bag, D)`."""
    ex = st.exchange
    gidx = ex.gather_batch(idx) if batch_sharded else idx
    part = _owned_rows(st.data, gidx, ex).reshape(tuple(gidx.shape)
                                                   + (st.dim,))
    if scale is not None:
        gs = ex.gather_batch(scale) if batch_sharded else scale
        part = part * gs[..., None].to(part.dtype)
    if reducing:
        part = part.sum(dim=-2)
    if batch_sharded:
        return ex.scatter_batch(part)
    return ex.sum_all(part)


def sharded_lookup(mesh, st: ShardedStackedTables, idx, *,
                   batch_sharded: bool = True, combiner: str = "sum",
                   weights=None, pad_idx: int | None = None) -> torch.Tensor:
    """Lookup on a sharded (stacked) table. `idx`: this rank's block `(b,)`
    or `(b, bag)` of global stacked ids (the global batch when not
    `batch_sharded`); returns `(b, dim)`, the same block. combiner /
    weights / pad_idx: the single-device `lookup` contract, folded into
    one scale (`pad_idx` is matched before any shift)."""
    idx = torch.as_tensor(idx).to(st.data.device, torch.int32)
    reducing = idx.dim() == 2
    idx, scale = _fold_combiner(idx, combiner, weights, pad_idx)
    return _lookup_batch_major(st, idx, scale, reducing, batch_sharded)


def _stack_shifted(st: ShardedStackedTables, idx_list) -> torch.Tensor:
    return torch.stack([torch.as_tensor(i).to(st.data.device, torch.int32)
                        + st.offsets[t] for t, i in enumerate(idx_list)])


def sharded_ensemble_lookup(mesh, st: ShardedStackedTables, indices, *,
                            batch_sharded: bool = True, fused: bool = False,
                            prependrows: int = 0, stacked: bool = False,
                            combiner: str = "sum", weights=None,
                            pad_idx: int | None = None):
    """Every table of the stack in ONE exchange: per-table local ids (a
    list, or a `(T, b[, bag])` tensor) are shifted by the stacked offsets.
    Returns `(T, b, dim)` with `stacked`, one `(b, prependrows + T*dim)`
    tensor with `fused`, else a list of `(b, dim)`. Pads are detected on
    the local ids before the shift."""
    idx_list = normalize_indices(indices, st.ntables)
    scale = None
    if weights is not None or pad_idx is not None or combiner != "sum":
        w_list = normalize_weights(weights, st.ntables)
        folded = [_fold_combiner(torch.as_tensor(i).to(st.data.device),
                                 combiner, w, pad_idx)
                  for i, w in zip(idx_list, w_list)]
        idx_list = [f[0] for f in folded]
        if any(f[1] is not None for f in folded):
            scale = torch.stack([
                f[1] if f[1] is not None else
                torch.ones(f[0].shape, dtype=torch.float32,
                           device=st.data.device) for f in folded])
    shifted = _stack_shifted(st, idx_list)            # (T, b[, bag])
    reducing = shifted.dim() == 3
    out = _lookup_batch_major(
        st, shifted.transpose(0, 1).contiguous(),
        None if scale is None else scale.transpose(0, 1).contiguous(),
        reducing, batch_sharded)                      # (b, T, dim)
    b = out.shape[0]
    if fused:
        fusedout = out.reshape(b, st.ntables * st.dim)
        if prependrows:
            zeros = torch.zeros((b, prependrows), dtype=fusedout.dtype,
                                device=fusedout.device)
            fusedout = torch.cat([zeros, fusedout], dim=-1)
        return fusedout
    out = out.transpose(0, 1).contiguous()
    if stacked:
        return out
    return list(out.unbind(0))


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------

def owned_apply(st: ShardedStackedTables, idx: torch.Tensor,
                delta: torch.Tensor, weights, sparse_opt, state, *,
                batch_sharded: bool = True, lr=None, generator=None):
    """The gather exchange's update, in place; returns the new state.

    idx: batch-major global ids `(b, *rows)` or `(b, *rows, bag)`; delta:
    `(b, *rows, D)`, one row per output (a bag's delta fans out to its
    ids); weights: per-occurrence scale like `idx`, or None. After the
    all-gather over the data axis, the occurrences of rows this rank owns
    (in stream order) become one `SparseEmbeddingUpdate` of local slots,
    which `sparse_opt.apply` writes into the shard and its state."""
    ex = st.exchange
    dim = st.dim
    delta = delta.float()
    if batch_sharded:
        idx = ex.gather_batch(idx)
        delta = ex.gather_batch(delta)
        weights = None if weights is None else ex.gather_batch(weights)
    rows = idx.reshape(-1).long()
    per_row = rows.numel() // max(1, delta.numel() // dim)
    mine = (rows >= 0) & (torch.remainder(rows, ex.n) == ex.me)
    with phase("update.owned_count"):     # reads the count on the host
        sel = mine.nonzero().squeeze(1)
    lrow = torch.div(rows[sel], ex.n, rounding_mode="floor").to(torch.int32)
    vals = delta.reshape(-1, dim).index_select(
        0, sel if per_row == 1 else torch.div(sel, per_row,
                                              rounding_mode="floor"))
    if weights is not None:
        vals = vals * weights.reshape(-1).float()[sel, None]
    kw = {} if generator is None else {"generator": generator}
    _, state = sparse_opt.apply(
        st.data, SparseEmbeddingUpdate(delta=vals, indices=lrow), state,
        lr=lr, **kw)
    return state


def sharded_sgd_update(mesh, st: ShardedStackedTables,
                       upd: SparseEmbeddingUpdate, lr, *,
                       batch_sharded: bool = True) -> ShardedStackedTables:
    """Sparse SGD on a sharded table, in place: `upd` is this rank's block
    of a lazy update of global ids. Returns `st`."""
    owned_apply(st, upd.indices, upd.delta, upd.weights, SparseSGD(lr),
                SparseSGD().init(st.data), batch_sharded=batch_sharded)
    return st


def _stack_updates(st: ShardedStackedTables,
                  upds: Sequence[SparseEmbeddingUpdate]):
    """Per-table lazy updates -> batch-major `(ids, delta, weights)` of the
    stack: ids shifted to stacked rows."""
    shifted = _stack_shifted(st, [u.indices for u in upds])
    deltas = torch.stack([u.delta for u in upds])
    weights = None
    if any(u.weights is not None for u in upds):
        weights = torch.stack([
            u.weights.to(shifted.device).float() if u.weights is not None
            else torch.ones(u.indices.shape, dtype=torch.float32,
                            device=shifted.device) for u in upds])
        weights = weights.transpose(0, 1).contiguous()
    return (shifted.transpose(0, 1).contiguous(),
            deltas.transpose(0, 1).contiguous(), weights)


def sharded_ensemble_update(mesh, st: ShardedStackedTables,
                            upds: Sequence[SparseEmbeddingUpdate], lr, *,
                            batch_sharded: bool = True
                            ) -> ShardedStackedTables:
    """Per-table lazy updates applied to the stack in ONE exchange, in
    place. Returns `st`."""
    idx, delta, weights = _stack_updates(st, upds)
    owned_apply(st, idx, delta, weights, SparseSGD(lr),
                SparseSGD().init(st.data), batch_sharded=batch_sharded)
    return st
