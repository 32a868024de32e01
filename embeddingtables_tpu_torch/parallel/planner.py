"""The sharding planner: a placement for every table over the mesh
(counterpart of `embeddingtables_tpu/parallel/planner.py`).

Three placements, each a group stacked along the vocab axis, so a plan
still does one gather per group:

  - replicate: the table lives whole on every rank. Its lookup is a local
    gather (no exchange); its update applies the global occurrence stream
    (the ids, deltas and weights all-gathered over the data axis) on every
    replica through the dense bodies (`optim.*_dense_body`). The gradient
    is the run-scatter's (`optim.run_scatter_dense_grad`), which adds in
    the same order on every rank, so the replicas stay bitwise equal
    without an all-reduce; JAX's XLA scatter adds in its own order
    (ROADMAP.md queue 3).
  - row_shard: mod-row-sharded (`sharded.py`): the gather exchange, and
    `owned_apply` for the update.
  - col_shard: feature-sharded (`colshard.py`).

`plan_sharding` decides by a cost model that JAX's reads: a table is
replicated while it is small (`replicate_max_bytes`) and the replicated
total fits `replicate_budget_bytes`, admitted by value density (hotness per
byte, then vocab, a stable sort); `col_shard` names tables to column-shard,
and `skew` col-shards a table that would row-shard when one row takes at
least `col_shard_skew_threshold` of its traffic. On one rank every table
replicates. The plan is plain Python on the mesh's shape.

`PlannedTables` executes a plan: this rank's copy of the replicated group,
its shard of the row group, its column slice of the col group, and each
group's sparse optimizer state (the single-device state types at local
shapes; the col group's AdaGrad accumulator and the replicated group's are
whole on every rank). `planned_lookup` and `planned_apply` run the three
groups. The planned DLRM, DCN and folded DeepFM are adapters on
`parallel.dlrm.gather_train_step` with the planner's lookup and update, as
the sharded families are with the gather exchange's. Tables of several dims
group by dim (`plan_sharding_mixed`, `MixedDimPlannedTables`: one
`PlannedTables` a group). The planned two-tower retriever
(`PlannedTwoTower`) puts its query stack and its item corpus each on a plan
and trains with the sharded two-tower step's in-batch softmax over the
ranks; its corpus index is whole on every rank.

Stochastic rounding: the replicated group draws its noise from a generator
seeded by one number that rank 0 of the placement draws from its generator
and broadcasts (the replicas must round alike); the row and col groups draw
each rank's own noise from its generator, after it, in that order (JAX
folds 0, 1 and 2 into one key: ROADMAP.md queue 3); the groups of a
mixed-dim plan draw from the one generator in group order (JAX folds the
group index in).

Every rank must call every function here that touches a sharded group in
the same order: they are collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models import dcn as _dcn
from ..models import deepfm as _deepfm
from ..models.dcn import DCN
from ..models.deepfm import DeepFM
from ..models.dlrm import (RowState, _init_mlp, _pairs, _param_list,
                           forward_from_embeddings as dlrm_forward,
                           step_generator, with_dense_tx)
from ..models.two_tower import (TwoTower, TwoTowerConfig,
                                item_embed_from_rows, query_embed_from_rows)
from ..ops.cuda.gather import gather_rows
from ..ops.ensemble import StackedTables, normalize_indices
from ..ops.sparse_update import SparseEmbeddingUpdate
from ..optim import (SparseAdamState, SparseFTRL, SparseFTRLState,
                     SparseLazyAdam, SparseOptState, SparseRowWiseAdaGrad,
                     SparseSGD, adagrad_dense_body, adam_dense_body,
                     apply_dense_tx, check_dense_tx, ftrl_dense_body,
                     ftrl_init_arrays, run_scatter_dense_grad,
                     sgd_dense_body)
from ..tables import SimpleEmbedding
from .colshard import (ColShardedStackedTables, col_sharded_lookup,
                       col_sharded_update, col_slice, init_col_row_state)
from .dlrm import (_block, _check_sharded_opt, _copy_layers, _global_mean,
                   _local_grads, gather_train_step, rank_generator)
from .mesh import mesh_device
from .sharded import (Exchange, ShardedStackedTables, _apply_table_major,
                      _axes_tuple, _dims, shard_row_accum,
                      sharded_ensemble_lookup)

REPLICATE = "replicate"
ROW_SHARD = "row_shard"
COL_SHARD = "col_shard"


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """One table's placement and its cost accounting."""

    name: str
    vocab: int
    dim: int
    placement: str                  # REPLICATE | ROW_SHARD | COL_SHARD
    table_bytes: int                # full dense size
    bytes_per_device: int           # after placement (incl. shard padding)
    reason: str


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    decisions: tuple
    n_devices: int
    axis: str | tuple
    opt_state_bytes_per_device: int

    @property
    def replicated(self) -> tuple:
        return tuple(i for i, d in enumerate(self.decisions)
                     if d.placement == REPLICATE)

    @property
    def sharded(self) -> tuple:
        return tuple(i for i, d in enumerate(self.decisions)
                     if d.placement == ROW_SHARD)

    @property
    def col_sharded(self) -> tuple:
        return tuple(i for i, d in enumerate(self.decisions)
                     if d.placement == COL_SHARD)

    @property
    def bytes_per_device(self) -> int:
        return (sum(d.bytes_per_device for d in self.decisions)
                + self.opt_state_bytes_per_device)

    def summary(self) -> str:
        lines = [f"sharding plan over {self.n_devices} device(s), "
                 f"axis={self.axis!r}: "
                 f"{len(self.replicated)} replicated, "
                 f"{len(self.sharded)} row-sharded, "
                 f"{len(self.col_sharded)} col-sharded, "
                 f"{self.bytes_per_device / 2**20:.1f} MiB/device "
                 f"(opt state {self.opt_state_bytes_per_device / 2**20:.1f})"]
        for d in self.decisions:
            lines.append(f"  {d.name:<16} V={d.vocab:<10} D={d.dim:<5} "
                         f"{d.placement:<10} "
                         f"{d.bytes_per_device / 2**20:8.2f} MiB/dev  "
                         f"[{d.reason}]")
        return "\n".join(lines)


def _mesh_size(mesh, axes) -> int:
    n = 1
    for d in _dims(mesh, axes):
        n *= mesh.shape[d]
    return n


def plan_sharding(vocab_sizes: Sequence[int], dim: int, mesh,
                  axis: str | tuple = "data", *, dtype=torch.float32,
                  names: Optional[Sequence[str]] = None,
                  hotness: Optional[Sequence[float]] = None,
                  replicate_max_bytes: int = 4 << 20,
                  replicate_budget_bytes: int = 256 << 20,
                  hbm_budget_bytes: Optional[int] = None,
                  opt_state_scalars: int = 0,
                  col_shard: Optional[Sequence[int]] = None,
                  skew: Optional[Sequence[float]] = None,
                  col_shard_skew_threshold: float = 0.05) -> ShardingPlan:
    """Choose a placement for every table (the module docstring's rule).

    `mesh` is read for its shape only (`mesh_dim_names` and `shape`, as a
    `DeviceMesh` has them). `hotness`: per-table expected lookups per
    example (default 1.0 each); a table's value density is hotness over its
    bytes. `opt_state_scalars`: f32 scalars of optimizer state per row (1
    for row-wise AdaGrad), placed like the table (whole for the replicated
    and col groups). `dtype`: the tables' torch dtype. If
    `hbm_budget_bytes` is given and the per-device total exceeds it,
    raises `ValueError` carrying the plan summary. `col_shard` and `skew`
    take a single-axis placement only."""
    axes = _axes_tuple(axis)
    n = _mesh_size(mesh, axes)
    esize = torch.empty((), dtype=dtype).element_size()
    names = list(names) if names is not None else \
        [f"table_{i}" for i in range(len(vocab_sizes))]
    if len(names) != len(vocab_sizes):
        raise ValueError("names/vocab_sizes length mismatch")
    if hotness is not None and len(hotness) != len(vocab_sizes):
        raise ValueError("hotness/vocab_sizes length mismatch")
    hot = list(hotness) if hotness is not None else [1.0] * len(vocab_sizes)
    order = sorted(range(len(vocab_sizes)),
                   key=lambda i: (-hot[i] / max(vocab_sizes[i] * dim * esize,
                                                1), vocab_sizes[i]))
    col_set = set(col_shard or ())
    if skew is not None:
        if len(skew) != len(vocab_sizes):
            raise ValueError("skew/vocab_sizes length mismatch")
        if not isinstance(axis, str):
            raise NotImplementedError(
                "skew-driven col-sharding is single-axis "
                "(parallel/colshard.py)")
    bad = [i for i in col_set if not 0 <= i < len(vocab_sizes)]
    if bad:
        raise ValueError(f"col_shard indices out of range: {bad}")
    if col_set and not isinstance(axis, str):
        raise NotImplementedError(
            "col_shard is single-axis (parallel/colshard.py); use a 1-D "
            "mesh axis or row-shard on multi-axis meshes")
    placement = {}
    repl_total = 0
    for i in order:
        tb = vocab_sizes[i] * dim * esize
        if i in col_set:
            placement[i] = COL_SHARD if n > 1 else REPLICATE
        elif tb <= replicate_max_bytes and repl_total + tb <= \
                replicate_budget_bytes and n > 1:
            placement[i] = REPLICATE
            repl_total += tb
        elif (skew is not None and n > 1
              and skew[i] >= col_shard_skew_threshold):
            placement[i] = COL_SHARD
        elif n == 1:
            placement[i] = REPLICATE
        else:
            placement[i] = ROW_SHARD

    decisions = []
    opt_bytes = 0
    for i, v in enumerate(vocab_sizes):
        tb = v * dim * esize
        if placement[i] == REPLICATE:
            per_dev = tb
            reason = ("single device" if n == 1 else
                      f"small ({tb / 2**20:.2f} MiB <= "
                      f"{replicate_max_bytes / 2**20:.0f} MiB): local gather, "
                      f"zero exchange")
            opt_bytes += v * 4 * opt_state_scalars
        elif placement[i] == COL_SHARD:
            per_dev = v * (-(-dim // n)) * esize
            reason = (("col-shard (explicit)" if i in col_set else
                       f"col-shard (skew {skew[i]:.0%} >= "
                       f"{col_shard_skew_threshold:.0%})")
                      + f": feature slice 1/{n}, no index routing — "
                      f"hot-row skew free")
            opt_bytes += v * 4 * opt_state_scalars
        else:
            per_dev = (-(-v // n)) * dim * esize
            reason = (f"large: 1/{n} HBM/device, gather exchange "
                      f"(~{4 * 1}B/idx + (B,D) psum_scatter)")
            opt_bytes += (-(-v // n)) * 4 * opt_state_scalars
        decisions.append(PlacementDecision(
            name=names[i], vocab=v, dim=dim, placement=placement[i],
            table_bytes=tb, bytes_per_device=per_dev, reason=reason))

    plan = ShardingPlan(decisions=tuple(decisions), n_devices=n, axis=axis,
                        opt_state_bytes_per_device=opt_bytes)
    if hbm_budget_bytes is not None and \
            plan.bytes_per_device > hbm_budget_bytes:
        raise ValueError(
            f"plan needs {plan.bytes_per_device / 2**20:.1f} MiB/device, "
            f"budget is {hbm_budget_bytes / 2**20:.1f} MiB\n" + plan.summary())
    return plan


# ---------------------------------------------------------------------------
# Executing a plan
# ---------------------------------------------------------------------------

def _offsets(vocabs) -> tuple:
    offs, acc = [0], 0
    for v in vocabs:
        acc += v
        offs.append(acc)
    return tuple(offs)


def _empty_state(device) -> SparseOptState:
    return SparseOptState(accum=torch.zeros((0,), dtype=torch.float32,
                                            device=device))


class PlannedTables(nn.Module):
    """A plan, realized on this rank: the replicated group stacked in
    `repl` (a `(sum V_r, D)` buffer, whole on every rank), the row group's
    `shard` (`ShardedStackedTables`, or None), the col group's `col`
    (`ColShardedStackedTables`, or None), and each group's sparse optimizer
    state (`repl_state`, `shard_state`, `col_state`: `SparseOptState`,
    `SparseAdamState` or `SparseFTRLState`, at local shapes; SGD's zero-size
    placeholder), held as buffers so a checkpoint carries them. `exchange`
    is the placement's (`plan.axis`): its data axis carries the batch."""

    repl_state = RowState("repl")
    shard_state = RowState("shard")
    col_state = RowState("col")

    def __init__(self, plan: ShardingPlan, mesh, repl: torch.Tensor,
                 shard: Optional[ShardedStackedTables] = None,
                 col: Optional[ColShardedStackedTables] = None,
                 repl_state=None, shard_state=None, col_state=None):
        super().__init__()
        self.plan, self.mesh, self.axis = plan, mesh, plan.axis
        self.exchange = Exchange(mesh, plan.axis)
        self.register_buffer("repl", repl)
        self.shard, self.col = shard, col
        self.repl_tables = plan.replicated
        self.shard_tables = plan.sharded
        self.col_tables = plan.col_sharded
        self.vocab_sizes = tuple(d.vocab for d in plan.decisions)
        self.dim = plan.decisions[0].dim if plan.decisions else 0
        self.repl_offsets = _offsets(tuple(self.vocab_sizes[i]
                                           for i in self.repl_tables))
        dev = repl.device
        self.repl_state = _empty_state(dev) if repl_state is None \
            else repl_state
        self.shard_state = _empty_state(dev) if shard_state is None \
            else shard_state
        self.col_state = _empty_state(dev) if col_state is None \
            else col_state

    @property
    def device(self) -> torch.device:
        return self.repl.device

    @property
    def ntables(self) -> int:
        return len(self.vocab_sizes)

    def tables(self) -> list:
        """Every member table, dense, in plan order (a collective; the
        test oracle)."""
        full = {"shard": self.shard, "col": self.col}
        full = {k: g.unshard() for k, g in full.items() if g is not None}
        out = []
        for t in range(self.ntables):
            if t in self.repl_tables:
                j, data, offs = (self.repl_tables.index(t), self.repl,
                                 self.repl_offsets)
            elif t in self.col_tables:
                j, data, offs = (self.col_tables.index(t), full["col"],
                                 self.col.offsets)
            else:
                j, data, offs = (self.shard_tables.index(t), full["shard"],
                                 self.shard.offsets)
            out.append(data[offs[j]:offs[j + 1]])
        return out

    def table(self, t: int) -> torch.Tensor:
        """One member table, dense (a collective)."""
        return self.tables()[t]

    def set_row_state(self, repl_state, shard_state, col_state
                      ) -> "PlannedTables":
        """Replace the three groups' optimizer states, of any type (a fresh
        placement holds SGD's placeholders); returns `self`."""
        self.__dict__.get("_state_types", {}).clear()
        for prefix in ("repl", "shard", "col"):
            for name in [b for b in self._buffers
                         if b.startswith(prefix + "_")]:
                del self._buffers[name]
        self.repl_state, self.shard_state, self.col_state = (
            repl_state, shard_state, col_state)
        return self

    @classmethod
    def init(cls, generator: torch.Generator, plan: ShardingPlan, mesh, *,
             scale: Optional[float] = None, dtype=torch.float32,
             adagrad: bool = False) -> "PlannedTables":
        """Random tables per the plan, uniform in `[-scale, scale)` (default
        `1/sqrt(dim)`). `generator` must be seeded alike on every rank (it
        lives on the mesh's device): the replicated group, then the col
        group's whole table (each rank keeps its slice) come from it; each
        rank then draws its row shard from `rank_generator` of a seed drawn
        from it, so the row group never exists whole. `adagrad`: zero
        row-wise AdaGrad accumulators (else SGD's placeholders; the planned
        families set any optimizer's state with `planned_row_state`)."""
        device = mesh_device(mesh)
        dim = plan.decisions[0].dim if plan.decisions else 0
        scale = (1.0 / dim ** 0.5 if dim else 1.0) if scale is None else scale

        def uniform(rows):
            data = torch.empty((rows, dim), dtype=torch.float32,
                               device=device)
            data.uniform_(-1.0, 1.0, generator=generator)
            return (data * scale).to(dtype)

        vr = sum(plan.decisions[i].vocab for i in plan.replicated)
        repl = uniform(vr)
        col = None
        if plan.col_sharded:
            vocabs = tuple(plan.decisions[i].vocab for i in plan.col_sharded)
            col = ColShardedStackedTables.shard(
                mesh, _axes_tuple(plan.axis)[0],
                StackedTables(uniform(sum(vocabs)), _offsets(vocabs), dim))
        shard = None
        if plan.sharded:
            seed = int(torch.randint(0, 2 ** 31, (1,), generator=generator,
                                     device=device))
            ex = Exchange(mesh, plan.axis)
            shard = ShardedStackedTables.init_sharded(
                mesh, plan.axis,
                tuple(plan.decisions[i].vocab for i in plan.sharded), dim,
                generator=rank_generator(seed, ex.me, device), scale=scale,
                dtype=dtype, device=device)
        pt = cls(plan, mesh, repl, shard, col)
        if adagrad:
            pt.set_row_state(*planned_row_state(mesh, pt,
                                                SparseRowWiseAdaGrad()))
        return pt

    @classmethod
    def from_tables(cls, plan: ShardingPlan, mesh, tables: Sequence, *,
                    adagrad: bool = False,
                    accums: Optional[Sequence] = None) -> "PlannedTables":
        """Place existing `(V, D)` tables (tensors, numpy arrays or tables)
        per the plan, on the mesh's device; every rank passes the same.
        `accums`: per-table `(V,)` row-wise AdaGrad accumulators to place
        beside them (implies `adagrad`; without them, zeros)."""
        device = mesh_device(mesh)
        arrs = [_dense(t, device) for t in tables]
        if accums is not None:
            adagrad = True
            if len(accums) != len(arrs):
                raise ValueError("accums/tables length mismatch")
        dim = arrs[0].shape[1] if arrs else 0
        repl = (torch.cat([arrs[i] for i in plan.replicated])
                if plan.replicated
                else torch.zeros((0, dim), dtype=torch.float32, device=device))
        shard = None
        if plan.sharded:
            shard = ShardedStackedTables.shard(
                mesh, plan.axis, [arrs[i] for i in plan.sharded])
        col = None
        if plan.col_sharded:
            col = ColShardedStackedTables.shard(
                mesh, _axes_tuple(plan.axis)[0],
                [arrs[i] for i in plan.col_sharded])
        pt = cls(plan, mesh, repl.contiguous(), shard, col)
        if adagrad:
            state = None
            offsets = None
            if accums is not None:
                acc = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                       else a).to(device, torch.float32)
                       for a in accums]
                state = SparseOptState(accum=torch.cat(acc))
                offsets = _offsets(tuple(a.shape[0] for a in arrs))
            pt.set_row_state(*planned_row_state(
                mesh, pt, SparseRowWiseAdaGrad(), state=state,
                offsets=offsets))
        return pt


def _dense(t, device) -> torch.Tensor:
    """A `(V, D)` tensor on `device` from a tensor, an array or a table."""
    if isinstance(t, (StackedTables, SimpleEmbedding)):
        return t.data.to(device)
    if hasattr(t, "rows") and hasattr(t, "spec"):
        return t.rows(torch.arange(t.spec.vocab,
                                   device=t.example().device)).to(device)
    return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                           else t).to(device)


def _col_group_stream(pt: PlannedTables, idx_list, combiner, pad_idx):
    """`(shifted (Tc, b[, bag]) ids into the col stack, scale or None)` of
    the col group from the ORIGINAL ids: pads go to the group's row 0 with
    scale 0 (normalized over the valid mass with `combiner="mean"`)."""
    device = pt.device
    ids = [torch.as_tensor(idx_list[t]).to(device, torch.int32)
           for t in pt.col_tables]
    offs = pt.col.offsets
    if pad_idx is None:
        return torch.stack([i + offs[j] for j, i in enumerate(ids)]), None
    masks = torch.stack([i != pad_idx for i in ids])
    shifted = torch.stack([torch.where(masks[j], i, 0) + offs[j]
                           for j, i in enumerate(ids)])
    w = masks.float()
    if w.dim() == 3 and combiner == "mean":
        w = w / torch.clamp_min(w.sum(dim=2, keepdim=True), 1e-12)
    return shifted, w


def _batch_major(x: torch.Tensor) -> torch.Tensor:
    """`(T, b, ...)` -> `(b * T, ...)`: the (table, example) pairs as one
    batch with b leading, so each rank's block stays contiguous."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def planned_lookup(mesh, pt: PlannedTables, indices, *, combiner: str = "sum",
                   pad_idx: int | None = None) -> torch.Tensor:
    """Ensemble lookup under a plan: this rank's block of per-table ids (a
    list, or a `(T, b[, bag])` tensor) -> `(T, b, dim)` in the plan's table
    order. The replicated group is one local `gather_rows`; the row group
    the gather exchange; the col group one column exchange with the (table,
    example) pairs as its batch.

    pad_idx: the bag sentinel (ops/lookup.py's pad contract); with it
    `combiner` applies inside (mean over the valid entries). Without it the
    caller divides a mean itself (the plain bag sum comes back)."""
    device = pt.device
    idx_list = [torch.as_tensor(i).to(device, torch.int32)
                for i in normalize_indices(indices, pt.ntables)]
    out = [None] * pt.ntables
    if pt.repl_tables:
        ids = torch.stack([idx_list[t] for t in pt.repl_tables])
        offs = torch.tensor(pt.repl_offsets[:-1], dtype=torch.int32,
                            device=device).view(-1, *([1] * (ids.dim() - 1)))
        msub = None
        if pad_idx is not None:
            msub = ids != pad_idx
            ids = torch.where(msub, ids, 0)
        shifted = ids + offs
        rows = gather_rows(pt.repl, shifted.reshape(-1).contiguous()).reshape(
            tuple(shifted.shape) + (pt.dim,))
        if msub is not None:
            rows = rows * msub[..., None].to(rows.dtype)
        if shifted.dim() == 3:
            rows = rows.sum(dim=2)
            if msub is not None and combiner == "mean":
                denom = torch.clamp_min(msub.sum(dim=2).float(), 1e-12)
                rows = rows / denom[..., None].to(rows.dtype)
        for j, t in enumerate(pt.repl_tables):
            out[t] = rows[j]
    if pt.shard_tables:
        sub = [idx_list[t] for t in pt.shard_tables]
        kw = ({} if pad_idx is None
              else dict(combiner=combiner, pad_idx=pad_idx))
        so = sharded_ensemble_lookup(mesh, pt.shard, sub, stacked=True, **kw)
        for j, t in enumerate(pt.shard_tables):
            out[t] = so[j]
    if pt.col_tables:
        shifted, eff = _col_group_stream(pt, idx_list, combiner, pad_idx)
        b, tc = shifted.shape[1], len(pt.col_tables)
        co = col_sharded_lookup(
            mesh, pt.col, _batch_major(shifted),
            weights=None if eff is None else _batch_major(eff))
        co = co.reshape(b, tc, pt.dim)
        for j, t in enumerate(pt.col_tables):
            out[t] = co[:, j]
    return torch.stack(out)


def _col_reshard(mesh, ct: ColShardedStackedTables, x: torch.Tensor):
    """A per-coordinate `(V_c, D)` state buffer in the col group's layout:
    this rank's f32 `(V_c, cols_local)` slice."""
    return col_slice(x.float(), ct.exchange.me, ct.exchange.n)


def planned_row_state(mesh, pt: PlannedTables, sparse_opt, *, state=None,
                      offsets=None):
    """`(repl_state, shard_state, col_state)` of any sparse optimizer, for
    all three groups at once: fresh when `state` is None; else `state` is
    the single-device state of the original stacked ensemble (with per-table
    row `offsets`) and each group gets its tables' slices (the resume path).
    Layouts: the single-device state types at local shapes (the replicated
    group whole; the row group's rows; the col group's AdaGrad accumulator
    whole, its Adam and FTRL buffers as `(V_c, cols_local)` slices). Groups
    the plan does not use keep SGD's zero-size placeholder."""
    if state is not None:
        want = (SparseAdamState if isinstance(sparse_opt, SparseLazyAdam)
                else SparseFTRLState if isinstance(sparse_opt, SparseFTRL)
                else SparseOptState)
        if not isinstance(state, want):
            raise NotImplementedError(
                f"resume state {type(state).__name__} does not match "
                f"{type(sparse_opt).__name__} (expected "
                f"{want.__name__}); re-init the optimizer state or keep "
                f"the optimizer family")
    device = pt.device

    def group_cat(x, table_ids):
        if not table_ids:
            return x[:0]
        return torch.cat([x[offsets[t]:offsets[t + 1]] for t in table_ids])

    def count():
        return (state.count.clone().to(device, torch.int32)
                if state is not None
                else torch.zeros((), dtype=torch.int32, device=device))

    empty = _empty_state(device)
    if isinstance(sparse_opt, SparseLazyAdam):
        if state is not None:
            repl = SparseAdamState(m=group_cat(state.m, pt.repl_tables).float(),
                                   v=group_cat(state.v, pt.repl_tables).float(),
                                   count=count())
        else:
            repl = sparse_opt.init(pt.repl)
        shard = col = empty
        if pt.shard is not None:
            shard = (shard_row_accum(mesh, pt.axis, pt.shard, SparseAdamState(
                m=group_cat(state.m, pt.shard_tables),
                v=group_cat(state.v, pt.shard_tables), count=count()), None)
                     if state is not None else sparse_opt.init(pt.shard.data))
        if pt.col is not None:
            col = (SparseAdamState(
                m=_col_reshard(mesh, pt.col, group_cat(state.m, pt.col_tables)),
                v=_col_reshard(mesh, pt.col, group_cat(state.v, pt.col_tables)),
                count=count()) if state is not None
                   else init_col_row_state(mesh, pt.col, sparse_opt))
        return repl, shard, col
    if isinstance(sparse_opt, SparseFTRL):
        if state is not None:
            repl = SparseFTRLState(z=group_cat(state.z, pt.repl_tables).float(),
                                   n=group_cat(state.n, pt.repl_tables).float())
        else:
            repl = SparseFTRLState(*ftrl_init_arrays(
                pt.repl, sparse_opt.lr, sparse_opt.beta, sparse_opt.l1,
                sparse_opt.l2, sparse_opt.initial_accum))
        shard = col = empty
        if pt.shard is not None:
            shard = (shard_row_accum(mesh, pt.axis, pt.shard, SparseFTRLState(
                z=group_cat(state.z, pt.shard_tables),
                n=group_cat(state.n, pt.shard_tables)), None)
                     if state is not None else sparse_opt.init(pt.shard.data))
        if pt.col is not None:
            col = (SparseFTRLState(
                z=_col_reshard(mesh, pt.col, group_cat(state.z, pt.col_tables)),
                n=_col_reshard(mesh, pt.col, group_cat(state.n, pt.col_tables)))
                   if state is not None
                   else init_col_row_state(mesh, pt.col, sparse_opt))
        return repl, shard, col
    if isinstance(sparse_opt, SparseRowWiseAdaGrad):
        iv = float(sparse_opt.initial_accum)
        carried = state is not None and state.accum.numel()

        def accum(table_ids, rows):
            if carried:
                return group_cat(state.accum, table_ids).to(
                    device, torch.float32).clone()
            return torch.full((rows,), iv, dtype=torch.float32,
                              device=device)
        repl = SparseOptState(accum=accum(pt.repl_tables, pt.repl.shape[0]))
        shard = col = empty
        if pt.shard is not None:
            shard = shard_row_accum(
                mesh, pt.axis, pt.shard,
                SparseOptState(accum=group_cat(state.accum, pt.shard_tables))
                if carried else None, sparse_opt)
        if pt.col is not None:
            col = SparseOptState(accum=accum(pt.col_tables, pt.col.vocab))
        return repl, shard, col
    return empty, _empty_state(device), _empty_state(device)


def _replica_generator(pt: PlannedTables, generator: torch.Generator):
    """One generator alike on every rank for the replicated group's
    stochastic rounding: seeded by a number rank 0 of the placement draws
    from its own generator and broadcasts."""
    ex = pt.exchange
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device).to(pt.device)
    with ex.timed("broadcast"):
        dist.broadcast(seed, src=dist.get_global_rank(ex.group, 0),
                       group=ex.group)
    return torch.Generator(device=pt.device).manual_seed(int(seed))


def planned_apply(mesh, pt: PlannedTables, indices, delta_t, sparse_opt, *,
                  combiner: str = "sum", pad_idx: int | None = None,
                  lr=None, generator=None) -> PlannedTables:
    """The lazy ensemble update `(delta_t (T, b, dim), indices)` of this
    rank's block under the plan, in place: tables and each group's state.
    Returns `pt`.

    Replicated group: the global occurrence stream (ids, deltas and pad
    scales all-gathered over the data axis) applied on every replica
    through the dense bodies with `run_scatter_dense_grad`, so the replicas
    stay bitwise equal. Row group: `owned_apply`. Col group:
    `col_sharded_update`, its stream built from the ORIGINAL ids (the
    remapped ones would hide the pads).

    pad_idx: the bag sentinel; pads carry weight 0 (the mean normalized over
    the valid mass), so they touch no row and no state. Without it,
    `combiner` is the caller's (deltas pre-scaled by 1/bag for the mean).
    `generator`: this rank's stochastic-rounding noise."""
    if not isinstance(sparse_opt, (SparseSGD, SparseRowWiseAdaGrad,
                                   SparseLazyAdam, SparseFTRL)):
        raise NotImplementedError(
            f"planned_apply supports SparseSGD / SparseRowWiseAdaGrad / "
            f"SparseLazyAdam / SparseFTRL, got "
            f"{type(sparse_opt).__name__}")
    use_sr = bool(getattr(sparse_opt, "stochastic_rounding", False))
    if use_sr and generator is None:
        raise ValueError(
            "sparse_opt.stochastic_rounding=True: pass this rank's "
            "torch.Generator as generator= (the train loops pass one)")
    if lr is not None and isinstance(sparse_opt, SparseFTRL):
        raise ValueError(
            "SparseFTRL cannot change lr per step: alpha is baked into "
            "the accumulated z state")
    lr_val = sparse_opt.lr if lr is None else lr
    device = pt.device
    orig = [torch.as_tensor(i).to(device, torch.int32)
            for i in normalize_indices(indices, pt.ntables)]
    delta_t = torch.as_tensor(delta_t).to(device)
    masks = None
    idx_list = orig
    if pad_idx is not None:
        masks = [i != pad_idx for i in orig]
        idx_list = [torch.where(m, i, 0) for m, i in zip(masks, orig)]

    def eff_scale(table_ids):
        if masks is None:
            return None
        w = torch.stack([masks[t] for t in table_ids]).float()
        if w.dim() == 3 and combiner == "mean":
            w = w / torch.clamp_min(w.sum(dim=2, keepdim=True), 1e-12)
        return w

    if pt.repl_tables:
        ex = pt.exchange
        offs = torch.tensor(pt.repl_offsets[:-1], dtype=torch.int32,
                            device=device)
        ids = torch.stack([idx_list[t] for t in pt.repl_tables])
        shifted = ids + offs.view(-1, *([1] * (ids.dim() - 1)))
        # Batch-major, then the whole batch: every replica sees the global
        # stream in data order.
        rows = ex.gather_batch(shifted.transpose(0, 1).contiguous())
        g = ex.gather_batch(torch.stack(
            [delta_t[t] for t in pt.repl_tables]).float().transpose(
                0, 1).contiguous()).reshape(-1, pt.dim)
        if rows.dim() == 3:
            g = torch.repeat_interleave(g, rows.shape[2], dim=0)
        scale = eff_scale(pt.repl_tables)
        if scale is not None:
            g = g * ex.gather_batch(scale.transpose(0, 1).contiguous()
                                    ).reshape(-1)[:, None]
        rows = rows.reshape(-1)
        kw = dict(generator=(_replica_generator(pt, generator) if use_sr
                             else None),
                  grad_dtype=getattr(sparse_opt, "dense_grad_dtype", None),
                  dense_grad=run_scatter_dense_grad)
        st = pt.repl_state
        with torch.no_grad():
            if isinstance(sparse_opt, SparseRowWiseAdaGrad):
                adagrad_dense_body(pt.repl, st.accum, rows, g, lr_val,
                                   sparse_opt.eps, sparse_opt.weight_decay,
                                   sparse_opt.clipnorm, **kw)
            elif isinstance(sparse_opt, SparseLazyAdam):
                t = st.count + 1
                adam_dense_body(pt.repl, st.m, st.v, t, rows, g, lr_val,
                                sparse_opt.b1, sparse_opt.b2, sparse_opt.eps,
                                sparse_opt.weight_decay, sparse_opt.clipnorm,
                                **kw)
                pt.repl_state = SparseAdamState(m=st.m, v=st.v, count=t)
            elif isinstance(sparse_opt, SparseFTRL):
                ftrl_dense_body(pt.repl, st.z, st.n, rows, g, sparse_opt.lr,
                                sparse_opt.beta, sparse_opt.l1, sparse_opt.l2,
                                sparse_opt.clipnorm, **kw)
            else:
                sgd_dense_body(pt.repl, rows, g, lr_val,
                               sparse_opt.weight_decay, sparse_opt.clipnorm,
                               **kw)
    if pt.shard_tables:
        offs = pt.shard.offsets
        shifted = torch.stack([idx_list[t] + offs[j]
                               for j, t in enumerate(pt.shard_tables)])
        dsub = torch.stack([delta_t[t] for t in pt.shard_tables])
        with torch.no_grad():
            pt.shard_state = _apply_table_major(
                pt.shard, pt.shard_state, shifted, dsub, sparse_opt, True,
                eff_scale(pt.shard_tables), lr,
                generator if use_sr else None)
    if pt.col_tables:
        shifted, eff = _col_group_stream(pt, orig, combiner, pad_idx)
        dsub = torch.stack([delta_t[t] for t in pt.col_tables])
        upd = SparseEmbeddingUpdate(
            delta=_batch_major(dsub), indices=_batch_major(shifted),
            weights=None if eff is None else _batch_major(eff))
        kw = dict(lr=lr, generator=generator if use_sr else None)
        st = pt.col_state
        if isinstance(sparse_opt, SparseSGD):
            col_sharded_update(mesh, pt.col, upd, sparse_opt, **kw)
        elif isinstance(sparse_opt, SparseRowWiseAdaGrad):
            col_sharded_update(mesh, pt.col, upd, sparse_opt, st.accum, **kw)
        else:
            _, pt.col_state = col_sharded_update(mesh, pt.col, upd,
                                                 sparse_opt, st, **kw)
    return pt


# ---------------------------------------------------------------------------
# The planned CTR families: adapters on `gather_train_step`
# ---------------------------------------------------------------------------

class PlannedDLRM(nn.Module):
    """A DLRM whose embeddings are a `PlannedTables` (`tables`): the towers
    replicated on every rank (`bottom_params`, `top_params`) and their
    optimizer state (`dense_opt_state`)."""

    def __init__(self, config, bottom, top, tables: PlannedTables,
                 dense_opt_state=None):
        super().__init__()
        self.config = config
        self.bottom_params = _param_list(bottom)
        self.top_params = _param_list(top)
        self.tables = tables
        self.dense_opt_state = dense_opt_state

    def tower_params(self) -> list:
        return list(self.named_parameters())

    @property
    def bottom(self):
        return _pairs(self.bottom_params)

    @property
    def top(self):
        return _pairs(self.top_params)

    def forward(self, dense, cat):
        """Logits of this rank's block (a collective)."""
        return make_planned_eval_step(self.config, self.tables.mesh)(
            self, dense, cat)


class PlannedDCN(nn.Module):
    """A DCN-v2 whose embeddings are a `PlannedTables`: replicated cross
    layers, deep tower and head, and their optimizer state."""

    cross, deep, head = DCN.cross, DCN.deep, DCN.head
    tower_params = DCN.tower_params

    def __init__(self, config, cross, deep, head, tables: PlannedTables,
                 dense_opt_state=None):
        super().__init__()
        self.config = config
        self.cross_params = _param_list(cross)
        self.deep_params = _param_list(deep)
        self.head_params = _param_list([head])
        self.tables = tables
        self.dense_opt_state = dense_opt_state

    def forward(self, dense, cat):
        """Logits of this rank's block (a collective)."""
        return make_planned_dcn_eval_step(self.config, self.tables.mesh)(
            self, dense, cat)


class PlannedDeepFM(nn.Module):
    """A folded DeepFM whose fused `(sum V, D + 1)` stack is a
    `PlannedTables` (dim `cfg.stack_dim`): replicated deep tower, head,
    `dense_w`, `bias` and their optimizer state. Only the folded layout can
    be planned (`models.deepfm.fuse_deepfm` converts the other)."""

    deep, head, dense_params = DeepFM.deep, DeepFM.head, DeepFM.dense_params
    tower_params = DeepFM.tower_params

    def __init__(self, config, deep, head, dense_w, bias,
                 tables: PlannedTables, dense_opt_state=None):
        super().__init__()
        self.config = config
        self.deep_params = _param_list(deep)
        self.head_params = _param_list([head])
        self.dense_w = nn.Parameter(dense_w)
        self.bias = nn.Parameter(bias)
        self.tables = tables
        self.dense_opt_state = dense_opt_state

    def forward(self, dense, cat):
        """Logits of this rank's block (a collective)."""
        return make_planned_deepfm_eval_step(self.config, self.tables.mesh)(
            self, dense, cat)


def _require_folded_deepfm(cfg, plan: Optional[ShardingPlan] = None):
    if not getattr(cfg, "folded", False):
        raise ValueError(
            "planner placement supports the folded DeepFM layout only "
            "(fold_fm_w=True with use_fm=True); convert a legacy model "
            "with models.deepfm.fuse_deepfm")
    if plan is not None and plan.decisions and \
            plan.decisions[0].dim != cfg.stack_dim:
        raise ValueError(
            f"plan dim {plan.decisions[0].dim} != cfg.stack_dim "
            f"{cfg.stack_dim} — build the plan with dim=cfg.stack_dim "
            f"(D+1: the fused stack carries the first-order column)")


def _zero_fused_w_column(pt: PlannedTables) -> PlannedTables:
    """Zero column 0 (the first-order weights) of every group, in place:
    the FM linear-term init of `init_deepfm`'s fused stack. In the col
    group only the rank holding global column 0 zeroes its local column
    0."""
    with torch.no_grad():
        pt.repl[:, 0] = 0.0
        if pt.shard is not None:
            pt.shard.data[:, 0] = 0.0
        if pt.col is not None and pt.col.exchange.me == 0:
            pt.col.data[:, 0] = 0.0
    return pt


@dataclasses.dataclass(frozen=True)
class _Planned:
    """One planned CTR family: the model class, its towers from a
    generator or from another model (`(cfg, generator, device) -> tower
    arguments`, `model -> copies of them`), its forward over the activation
    sets, the activation sets of a planned lookup and the one delta of
    their cotangents."""

    cls: type
    init_towers: object
    copy_towers: object
    forward: object
    split: object = staticmethod(lambda g: [g])
    fuse: object = staticmethod(lambda deltas: deltas[0])


def _dlrm_towers(cfg, g, device):
    return (_init_mlp((cfg.num_dense,) + cfg.bottom_mlp, cfg.param_dtype, g,
                      device),
            _init_mlp((cfg.interaction_features,) + cfg.top_mlp,
                      cfg.param_dtype, g, device))


def _dcn_towers(cfg, g, device):
    return _dcn.init_dense_params(cfg, g, device)


def _deepfm_towers(cfg, g, device):
    dt = cfg.param_dtype
    if cfg.use_deep:
        deep = _init_mlp((cfg.deep_features,) + cfg.deep_mlp, dt, g, device)
        head = _init_mlp((cfg.deep_mlp[-1], 1), dt, g, device)[0]
    else:
        deep = []
        head = (torch.zeros((1, 1), dtype=dt, device=device),
                torch.zeros((1,), dtype=dt, device=device))
    return (deep, head, torch.zeros((cfg.num_dense,), dtype=dt,
                                    device=device),
            torch.zeros((), dtype=dt, device=device))


def _head_copy(head):
    return tuple(t.detach().clone() for t in head)


def _dcn_forward(m, cfg, dense, acts):
    return _dcn.forward_from_embeddings(m.cross, m.deep, m.head, cfg, dense,
                                        acts[0])


def _deepfm_forward(m, cfg, dense, acts):
    return _deepfm.forward_from_embeddings(m.dense_params, cfg, dense,
                                           acts[0], acts[1])


def _deepfm_split(g):
    w_t, emb_t = _deepfm.split_fused(g)
    return [emb_t, w_t]


def _deepfm_fuse(deltas):
    return _deepfm.fuse_delta(deltas[1], deltas[0])


_FAMILIES = {
    "dlrm": _Planned(
        PlannedDLRM, _dlrm_towers,
        lambda m: (_copy_layers(m.bottom), _copy_layers(m.top)),
        lambda m, cfg, d, acts: dlrm_forward(m.bottom, m.top, cfg, d,
                                             acts[0])),
    "dcn": _Planned(
        PlannedDCN, _dcn_towers,
        lambda m: (_copy_layers(m.cross), _copy_layers(m.deep),
                   _head_copy(m.head)), _dcn_forward),
    "deepfm": _Planned(
        PlannedDeepFM, _deepfm_towers,
        lambda m: (_copy_layers(m.deep), _head_copy(m.head),
                   m.dense_w.detach().clone(), m.bias.detach().clone()),
        _deepfm_forward, _deepfm_split, _deepfm_fuse),
}


def _init_planned(family: str, cfg, plan: ShardingPlan, mesh, sparse_opt,
                  dense_tx, seed: int):
    """A random planned model: the towers from `seed` (alike on every
    rank), the tables by `PlannedTables.init` from the same generator, and
    `sparse_opt`'s fresh state of every group."""
    fam = _FAMILIES[family]
    device = mesh_device(mesh)
    g = torch.Generator(device=device).manual_seed(seed)
    towers = fam.init_towers(cfg, g, device)
    scale = 1.0 / cfg.dim ** 0.5 if family == "deepfm" else None
    pt = PlannedTables.init(g, plan, mesh, scale=scale,
                            dtype=cfg.tables_dtype)
    if family == "deepfm":
        _zero_fused_w_column(pt)
    pt.set_row_state(*planned_row_state(mesh, pt, sparse_opt or SparseSGD()))
    return with_dense_tx(fam.cls(cfg, *towers, pt), dense_tx)


def init_planned_dlrm(cfg, plan: ShardingPlan, mesh, sparse_opt=None,
                      dense_tx=None, seed: int = 0) -> PlannedDLRM:
    """A random DLRM made directly on the plan (JAX's `key` is `seed`):
    the towers from `seed`, the same on every rank; the replicated and col
    groups from the same generator, the row group from each rank's own
    (`PlannedTables.init`), so it never exists whole; `sparse_opt`'s fresh
    state of every group, and `dense_tx`'s tower state."""
    return _init_planned("dlrm", cfg, plan, mesh, sparse_opt, dense_tx, seed)


def init_planned_dcn(cfg, plan: ShardingPlan, mesh, sparse_opt=None,
                     dense_tx=None, seed: int = 0) -> PlannedDCN:
    """A random DCN-v2 made directly on the plan (`init_planned_dlrm`)."""
    _dcn.single_device_only(cfg, "init_planned_dcn")
    return _init_planned("dcn", cfg, plan, mesh, sparse_opt, dense_tx, seed)


def init_planned_deepfm(cfg, plan: ShardingPlan, mesh, sparse_opt=None,
                        dense_tx=None, seed: int = 0) -> PlannedDeepFM:
    """A random folded DeepFM made directly on the plan
    (`init_planned_dlrm`): the fused stack drawn at the vector scale
    `1/sqrt(cfg.dim)`, its first-order column zeroed in every group."""
    _require_folded_deepfm(cfg, plan)
    return _init_planned("deepfm", cfg, plan, mesh, sparse_opt, dense_tx,
                         seed)


def _planned_lookup_fn(mesh, cfg):
    """The planned families' `(T, b, D)` activations: the planned lookup,
    a mean divided by the bag when no pads are in play."""
    pad = cfg.pad_idx

    def lookup(m, cat):
        with torch.no_grad():
            e = planned_lookup(mesh, m.tables, cat, combiner=cfg.combiner,
                               pad_idx=pad)
            if pad is None and cfg.combiner == "mean" and cat.dim() == 3:
                e = e / cat.shape[2]
        return e
    return lookup


def _planned_train_step(family, cfg, mesh, sparse_opt, dense_lr, dense_tx,
                        microbatch, entry, init_name):
    fam = _FAMILIES[family]
    sparse_opt = sparse_opt or SparseSGD()
    check_dense_tx(dense_tx)
    _check_sharded_opt(sparse_opt)
    lookup = _planned_lookup_fn(mesh, cfg)

    def update(m, cat, deltas, lr, kw):
        planned_apply(mesh, m.tables, cat, fam.fuse(deltas), sparse_opt,
                      combiner=cfg.combiner, pad_idx=cfg.pad_idx, lr=lr, **kw)

    return gather_train_step(
        cfg, sparse_opt, dense_lr, dense_tx, microbatch,
        lookups=lambda m, c: fam.split(lookup(m, c)),
        forward=lambda m, d, acts: fam.forward(m, cfg, d, acts),
        update=update, entry=entry, init_name=init_name)


def _planned_eval_step(family, cfg, mesh):
    fam = _FAMILIES[family]
    lookup = _planned_lookup_fn(mesh, cfg)

    def step(model, dense, cat):
        device = model.tables.device
        with torch.inference_mode():
            acts = fam.split(lookup(model, torch.as_tensor(cat).to(device)))
            return fam.forward(model, cfg, torch.as_tensor(dense).to(device),
                               acts)
    return step


def make_planned_train_step(cfg, mesh, sparse_opt=None,
                            dense_lr: float = 0.01, dense_tx=None,
                            microbatch=None):
    """`step(model: PlannedDLRM, dense, cat, label, lr=None, generator=None)
    -> loss` on this rank's block of the batch (`parallel.local_batch` over
    the plan's axis), in place: the sharded DLRM step's math
    (`gather_train_step`) with the planned lookup and ONE `planned_apply`
    of the whole block's delta; `dense_tx` and `microbatch=k` as the
    sharded step takes them. The placement is the model's own."""
    return _planned_train_step("dlrm", cfg, mesh, sparse_opt, dense_lr,
                               dense_tx, microbatch, "train_dlrm",
                               "init_planned_dlrm")


def make_planned_eval_step(cfg, mesh):
    """`step(model: PlannedDLRM, dense, cat) -> logits` of this rank's
    block, under `torch.inference_mode` (a collective)."""
    return _planned_eval_step("dlrm", cfg, mesh)


def make_planned_dcn_train_step(cfg, mesh, sparse_opt=None,
                                dense_lr: float = 0.01, dense_tx=None,
                                microbatch=None):
    """The DCN-v2 train step on a plan (`make_planned_train_step`)."""
    return _planned_train_step("dcn", cfg, mesh, sparse_opt, dense_lr,
                               dense_tx, microbatch, "train_dcn",
                               "init_planned_dcn")


def make_planned_dcn_eval_step(cfg, mesh):
    """`step(model: PlannedDCN, dense, cat) -> logits` of this rank's
    block (a collective)."""
    return _planned_eval_step("dcn", cfg, mesh)


def make_planned_deepfm_train_step(cfg, mesh, sparse_opt=None,
                                   dense_lr: float = 0.01, dense_tx=None,
                                   microbatch=None):
    """The folded DeepFM train step on a plan: ONE planned lookup feeds
    both activation sets (`split_fused`), ONE `planned_apply` carries the
    fused delta (`fuse_delta`)."""
    _require_folded_deepfm(cfg)
    return _planned_train_step("deepfm", cfg, mesh, sparse_opt, dense_lr,
                               dense_tx, microbatch, "train_deepfm",
                               "init_planned_deepfm")


def make_planned_deepfm_eval_step(cfg, mesh):
    """`step(model: PlannedDeepFM, dense, cat) -> logits` of this rank's
    block (a collective)."""
    _require_folded_deepfm(cfg)
    return _planned_eval_step("deepfm", cfg, mesh)


# ---------------------------------------------------------------------------
# Resume onto a plan, traffic statistics, eviction
# ---------------------------------------------------------------------------

def place_stacked_on_plan(plan: ShardingPlan, mesh, stacked, emb_state,
                          sparse_opt) -> PlannedTables:
    """Place a trained `StackedTables` and its sparse optimizer state
    (single-device types) onto a plan: the resume path of
    `train_*(plan=)`."""
    offs = stacked.offsets
    pt = PlannedTables.from_tables(
        plan, mesh, [stacked.data[offs[t]:offs[t + 1]]
                     for t in range(len(offs) - 1)])
    has_state = emb_state is not None and any(
        torch.is_tensor(x) and x.numel() for x in emb_state)
    return pt.set_row_state(*planned_row_state(
        mesh, pt, sparse_opt or SparseSGD(),
        state=emb_state if has_state else None, offsets=offs))


def plan_model(model, plan: ShardingPlan, mesh, sparse_opt=None,
               dense_tx=None):
    """A single-device DLRM, DCN or folded DeepFM placed on a plan: its
    tables and sparse optimizer state (`place_stacked_on_plan`), copies of
    its towers and of their optimizer state (or `dense_tx`'s fresh one).
    Every rank must pass the same model."""
    family = ("dcn" if isinstance(model, DCN) else
              "deepfm" if isinstance(model, DeepFM) else "dlrm")
    if family == "deepfm":
        if model.fm_w is not None:
            raise ValueError(
                "plan= supports the folded DeepFM layout only; "
                "convert with models.deepfm.fuse_deepfm first")
        _require_folded_deepfm(model.config, plan)
    fam = _FAMILIES[family]
    pt = place_stacked_on_plan(plan, mesh, model.tables, model.emb_state,
                               sparse_opt)
    dstate = model.dense_opt_state
    planned = fam.cls(model.config, *fam.copy_towers(model), pt,
                      None if dstate is None else dstate.clone())
    if dstate is None:
        with_dense_tx(planned, dense_tx)
    return planned


def hotness_from_trackers(trackers) -> list:
    """Per-table hotness for `plan_sharding(hotness=)` from observed
    traffic: each `utils.FrequencyTracker`'s occurrences per observation, a
    decayed EMA normalized by the decayed observation count
    `(1 - d^N) / (1 - d)` so it stays stable in run length; 1.0 for a
    tracker that saw nothing."""
    hot = []
    for tr in trackers:
        n = tr.observations
        if n == 0:
            hot.append(1.0)
            continue
        d = tr.decay
        denom = float(n) if d >= 1.0 else (1.0 - d ** n) / (1.0 - d)
        hot.append(max(float(tr.counts.sum()) / denom, 1e-9))
    return hot


def skew_from_trackers(trackers) -> list:
    """Per-table hot-row concentration for `plan_sharding(skew=)`: the
    share of each table's decayed traffic on its hottest row (0.0 for a
    table that saw nothing)."""
    out = []
    for tr in trackers:
        total = float(tr.counts.sum())
        out.append(float(tr.counts.max()) / total if total > 0 else 0.0)
    return out


def _zero_state_rows(state, rows: torch.Tensor, v: int) -> None:
    """Zero a whole-group state's vocab-leading buffers at `rows`, in place
    (AdaGrad's accumulator, Adam's moments, FTRL's z, n); Adam's count and
    SGD's placeholder pass through."""
    for leaf in state:
        if torch.is_tensor(leaf) and leaf.dim() >= 1 and \
                leaf.shape[0] == v and v:
            leaf.index_fill_(0, rows, 0)


def evict_rows_planned(pt: PlannedTables, cold_per_table) -> PlannedTables:
    """Row eviction on a plan, in place: zero the given per-table LOCAL row
    ids (host int arrays, the loop's `FrequencyTracker.pop_cold` output) in
    whichever group holds each table, and their optimizer state cells (to
    0, as in JAX). Every rank calls it with the same rows; the row group's
    owner zeroes its own. Returns `pt`."""
    from ..utils.rowstats import evict_rows_sharded

    def group_rows(table_ids, offs):
        rows = np.concatenate(
            [np.asarray(cold_per_table[t], np.int64).reshape(-1) + offs[j]
             for j, t in enumerate(table_ids)])
        return torch.from_numpy(np.unique(rows)).to(pt.device)

    with torch.no_grad():
        if pt.repl_tables:
            rows = group_rows(pt.repl_tables, pt.repl_offsets)
            if rows.numel():
                pt.repl.index_fill_(0, rows, 0)
                _zero_state_rows(pt.repl_state, rows, pt.repl.shape[0])
        if pt.shard_tables:
            rows = group_rows(pt.shard_tables, pt.shard.offsets)
            if rows.numel():
                evict_rows_sharded(pt.shard, pt.shard_state, rows)
        if pt.col_tables:
            rows = group_rows(pt.col_tables, pt.col.offsets)
            if rows.numel():
                pt.col.data.index_fill_(0, rows, 0)
                _zero_state_rows(pt.col_state, rows, pt.col.vocab)
    return pt


# ---------------------------------------------------------------------------
# Mixed feature dimensions: one PlannedTables group per distinct dim
# ---------------------------------------------------------------------------

def plan_sharding_mixed(vocab_sizes: Sequence[int], dims: Sequence[int],
                        mesh, axis: str | tuple = "data", **kw) -> tuple:
    """A placement for an ensemble whose tables have their own dims (a
    stack needs one dim, so the tables group by dim first): `(plans,
    groups)`, `plans[g]` the `ShardingPlan` of dim group g in ascending dim
    order and `groups[g]` the original table indices it covers, in order.
    `plan_sharding`'s other keywords hold for every group. The budgets are
    per device for the whole ensemble: each group's replicate budget is
    what the earlier groups left of `replicate_budget_bytes`, and
    `hbm_budget_bytes` is checked on the groups' combined total
    (`ValueError` with every group's summary)."""
    if len(dims) != len(vocab_sizes):
        raise ValueError("dims/vocab_sizes length mismatch")
    names = kw.pop("names", None)
    hotness = kw.pop("hotness", None)
    hbm_budget = kw.pop("hbm_budget_bytes", None)
    repl_budget = kw.pop("replicate_budget_bytes", 256 << 20)
    plans, groups = [], []
    for d in sorted(set(dims)):
        idxs = tuple(i for i, dd in enumerate(dims) if dd == d)
        plan = plan_sharding(
            [vocab_sizes[i] for i in idxs], d, mesh, axis,
            names=None if names is None else [names[i] for i in idxs],
            hotness=None if hotness is None else [hotness[i] for i in idxs],
            replicate_budget_bytes=repl_budget, **kw)
        repl_budget -= sum(dec.table_bytes for dec in plan.decisions
                           if dec.placement == REPLICATE)
        plans.append(plan)
        groups.append(idxs)
    if hbm_budget is not None:
        total = sum(p.bytes_per_device for p in plans)
        if total > hbm_budget:
            raise ValueError(
                f"mixed plan needs {total / 2**20:.1f} MiB/device, budget "
                f"is {hbm_budget / 2**20:.1f} MiB\n"
                + "\n".join(p.summary() for p in plans))
    return tuple(plans), tuple(groups)


class MixedDimPlannedTables(nn.Module):
    """A mixed-dim plan, realized: one `PlannedTables` per dim group
    (`groups`) and `table_map[t] = (group, position in the group)` of each
    original table. Lookups and updates take and give per-table lists in
    the original order (tables of several dims make no `(T, B, D)`
    stack)."""

    def __init__(self, groups: Sequence[PlannedTables], table_map):
        super().__init__()
        self.groups = nn.ModuleList(groups)
        self.table_map = tuple(table_map)

    @property
    def ntables(self) -> int:
        return len(self.table_map)

    def table(self, t: int) -> torch.Tensor:
        """Table t, dense (a collective)."""
        g, j = self.table_map[t]
        return self.groups[g].table(j)

    def members(self, g: int) -> list:
        """The original table indices of group g, in group order."""
        return [t for t, (gg, _) in enumerate(self.table_map) if gg == g]

    @staticmethod
    def _map(group_idxs) -> tuple:
        table_map = [None] * sum(len(ix) for ix in group_idxs)
        for g, idxs in enumerate(group_idxs):
            for j, t in enumerate(idxs):
                table_map[t] = (g, j)
        return tuple(table_map)

    @classmethod
    def from_tables(cls, plans, group_idxs, mesh, tables: Sequence, *,
                    adagrad: bool = False,
                    sparse_opt=None) -> "MixedDimPlannedTables":
        """Place existing per-table `(V, D_t)` tables by the mixed plan
        (`plan_sharding_mixed`'s `(plans, groups)`). `sparse_opt`: each
        group's fresh state of that optimizer (`planned_row_state`; it
        supersedes `adagrad`)."""
        groups = []
        for plan, idxs in zip(plans, group_idxs):
            pt = PlannedTables.from_tables(
                plan, mesh, [tables[i] for i in idxs], adagrad=adagrad)
            if sparse_opt is not None:
                pt.set_row_state(*planned_row_state(mesh, pt, sparse_opt))
            groups.append(pt)
        return cls(groups, cls._map(group_idxs))

    @classmethod
    def init(cls, generator: torch.Generator, plans, group_idxs, mesh, *,
             dtype=torch.float32, adagrad: bool = False,
             sparse_opt=None) -> "MixedDimPlannedTables":
        """Random tables by the mixed plan: each group by
        `PlannedTables.init` from `generator`, in group order (seeded alike
        on every rank)."""
        groups = []
        for plan in plans:
            pt = PlannedTables.init(generator, plan, mesh, dtype=dtype,
                                    adagrad=adagrad)
            if sparse_opt is not None:
                pt.set_row_state(*planned_row_state(mesh, pt, sparse_opt))
            groups.append(pt)
        return cls(groups, cls._map(group_idxs))


def mixed_planned_lookup(mesh, mt: MixedDimPlannedTables, indices, *,
                         combiner: str = "sum",
                         pad_idx: int | None = None) -> list:
    """Per-table lookups `[(b, D_t), ...]` in the original table order:
    one `planned_lookup` a group (`combiner` and `pad_idx` as there)."""
    idx_list = normalize_indices(indices, mt.ntables)
    out = [None] * mt.ntables
    for g, pt in enumerate(mt.groups):
        idxs = mt.members(g)
        sub = planned_lookup(mesh, pt, [idx_list[t] for t in idxs],
                             combiner=combiner, pad_idx=pad_idx)
        for j, t in enumerate(idxs):
            out[t] = sub[j]
    return out


def mixed_planned_apply(mesh, mt: MixedDimPlannedTables, indices,
                        deltas: Sequence, sparse_opt, *, combiner: str = "sum",
                        pad_idx: int | None = None, lr=None,
                        generator=None) -> MixedDimPlannedTables:
    """The per-table lazy deltas `[(b, D_t), ...]` applied by the mixed
    plan, in place: one `planned_apply` a group, in group order. Returns
    `mt`. Under stochastic rounding every group draws from `generator`
    after the groups before it (JAX folds the group index into its key:
    ROADMAP.md queue 3)."""
    idx_list = normalize_indices(indices, mt.ntables)
    for g, pt in enumerate(mt.groups):
        idxs = mt.members(g)
        delta_t = torch.stack([torch.as_tensor(deltas[t]).to(pt.device)
                               for t in idxs])
        planned_apply(mesh, pt, [idx_list[t] for t in idxs], delta_t,
                      sparse_opt, combiner=combiner, pad_idx=pad_idx, lr=lr,
                      generator=generator)
    return mt


# ---------------------------------------------------------------------------
# The two-tower retriever on the planner
# ---------------------------------------------------------------------------

class PlannedTwoTower(nn.Module):
    """A two-tower retriever whose two row spaces are `PlannedTables`: the
    query stack under `q_plan` (`query_tables`) and the item corpus as a
    single-table plan under `i_plan` (`item_tables`; a large corpus
    row-shards, a small one replicates), each with its groups' sparse
    optimizer state; the MLPs replicated on every rank."""

    query_mlp, item_mlp = TwoTower.query_mlp, TwoTower.item_mlp

    def __init__(self, config: TwoTowerConfig, query_tables: PlannedTables,
                 item_tables: PlannedTables, query_mlp, item_mlp):
        super().__init__()
        self.config = config
        self.query_tables = query_tables
        self.item_tables = item_tables
        self.query_mlp_params = _param_list(query_mlp)
        self.item_mlp_params = _param_list(item_mlp)


def _check_item_plan(i_plan: ShardingPlan, cfg) -> None:
    if len(i_plan.decisions) != 1 or \
            i_plan.decisions[0].vocab != cfg.item_vocab:
        raise ValueError(
            "i_plan must be a single-table plan over (item_vocab,): build it "
            "with plan_sharding([cfg.item_vocab], cfg.dim, mesh)")


def init_planned_two_tower(cfg: TwoTowerConfig, q_plan: ShardingPlan,
                           i_plan: ShardingPlan, mesh, sparse_opt=None,
                           seed: int = 0) -> PlannedTwoTower:
    """A random two-tower model made directly on the plans (JAX's `key` is
    `seed`): from one generator seeded alike on every rank, the query
    tables and the item corpus (`PlannedTables.init`, at `1/sqrt(dim)`),
    then the MLPs; `sparse_opt`'s fresh state of every group (default
    `SparseSGD(0.05)`)."""
    _check_item_plan(i_plan, cfg)
    sparse_opt = sparse_opt or SparseSGD(0.05)
    device = mesh_device(mesh)
    g = torch.Generator(device=device).manual_seed(seed)
    scale = 1.0 / cfg.dim ** 0.5
    groups = []
    for plan in (q_plan, i_plan):
        pt = PlannedTables.init(g, plan, mesh, scale=scale,
                                dtype=cfg.tables_dtype)
        groups.append(pt.set_row_state(*planned_row_state(mesh, pt,
                                                          sparse_opt)))
    q_in = cfg.num_dense + cfg.num_query_tables * cfg.dim
    qmlp = _init_mlp((q_in,) + cfg.query_mlp, cfg.param_dtype, g, device)
    imlp = _init_mlp((cfg.dim,) + cfg.item_mlp, cfg.param_dtype, g, device)
    return PlannedTwoTower(cfg, *groups, qmlp, imlp)


def place_two_tower_on_plan(q_plan: ShardingPlan, i_plan: ShardingPlan,
                            mesh, model: TwoTower,
                            sparse_opt) -> PlannedTwoTower:
    """A single-device `TwoTower` carried onto the plans with its tables'
    optimizer states (`place_stacked_on_plan` for each row space) and
    copies of its MLPs: the resume path of `train_two_tower(plan=)`. Every
    rank must pass the same model."""
    cfg = model.config
    _check_item_plan(i_plan, cfg)
    q_pt = place_stacked_on_plan(q_plan, mesh, model.query_tables,
                                 model.q_state, sparse_opt)
    items = StackedTables(model.item_data, (0, cfg.item_vocab), cfg.dim)
    i_pt = place_stacked_on_plan(i_plan, mesh, items, model.i_state,
                                 sparse_opt)
    return PlannedTwoTower(cfg, q_pt, i_pt, _copy_layers(model.query_mlp),
                           _copy_layers(model.item_mlp))


def make_planned_tt_train_step(cfg: TwoTowerConfig, mesh, sparse_opt=None,
                               dense_lr: float = 0.05):
    """The contrastive train step on a planned model, `step(model, dense,
    q_cat, item_ids, generator=None) -> (loss, acc)` on this rank's block
    (`parallel.tt_batch_shardings` over the query plan's axis), in place:
    the sharded two-tower step's math (`make_sharded_tt_train_step`: the
    in-batch softmax over every rank's items, `_softmax_over_ranks`) with
    both lookups through `planned_lookup` and both lazy updates through
    `planned_apply`, the query stack's first, then the item corpus's (under
    stochastic rounding both from this rank's `generator`: JAX folds 0 and
    1 into its key); then plain SGD on both MLPs."""
    from .two_tower import _softmax_over_ranks
    sparse_opt = sparse_opt or SparseSGD(0.05)
    _check_sharded_opt(sparse_opt)

    def step(model: PlannedTwoTower, dense, q_cat, item_ids,
             generator=None):
        kw = step_generator(sparse_opt, generator, "train_two_tower")
        qt, it = model.query_tables, model.item_tables
        ex = qt.exchange
        device = qt.device
        dense = torch.as_tensor(dense).to(device)
        q_cat = torch.as_tensor(q_cat).to(device, torch.int32)
        item_ids = torch.as_tensor(item_ids).to(device, torch.int32)
        with torch.no_grad():
            q_rows = planned_lookup(mesh, qt, q_cat).transpose(0, 1)
            i_rows = planned_lookup(mesh, it, item_ids[None])[0]
        params = list(model.parameters())
        acc = []

        def loss_fn(acts):
            q = query_embed_from_rows(model.query_mlp, cfg, dense, acts[0])
            i = item_embed_from_rows(model.item_mlp, cfg, acts[1])
            loss, a = _softmax_over_ranks(ex, q, i, cfg.temperature)
            acc.append(a.detach())
            return loss

        loss, grads, (q_delta, i_delta) = _local_grads(
            params, [q_rows, i_rows], loss_fn)
        loss, grads = _global_mean(ex, loss, grads + [acc[0].reshape(1)])
        acc = grads.pop()[0]
        planned_apply(mesh, qt, q_cat,
                      q_delta.transpose(0, 1).float() / ex.n_data,
                      sparse_opt, **kw)
        planned_apply(mesh, it, item_ids[None],
                      i_delta[None].float() / ex.n_data, sparse_opt, **kw)
        apply_dense_tx(params, grads, None, None, dense_lr)
        return loss, acc

    return step


def planned_build_item_index(mesh, model: PlannedTwoTower,
                             batch: int = 65_536) -> torch.Tensor:
    """The `(item_vocab, embed_dim)` corpus index of a planned model, whole
    on every rank (a collective): the item tower over `batch` items at a
    time, each rank embedding its block of the chunk (rows by
    `planned_lookup`), the blocks all-gathered. A ragged last chunk is
    padded to a multiple of the data axis with item 0, as in JAX, and
    trimmed. JAX's index is one global array that GSPMD places; every rank
    holds it whole here (ROADMAP.md queue 3)."""
    cfg = model.config
    it = model.item_tables
    ex = it.exchange
    v = cfg.item_vocab
    outs = []
    with torch.inference_mode():
        for lo in range(0, v, batch):
            n = min(v, lo + batch) - lo
            ids = torch.arange(lo, lo + n + (-n % ex.n_data),
                               dtype=torch.int32, device=it.device) % v
            ids = ids[_block(ex, ids.shape[0])]
            rows = planned_lookup(mesh, it, ids[None])[0]
            emb = item_embed_from_rows(model.item_mlp, cfg, rows)
            outs.append(ex.gather_batch(emb.contiguous())[:n])
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def planned_retrieve(mesh, model: PlannedTwoTower, index: torch.Tensor,
                     dense, q_cat, k: int = 10):
    """Top-k retrieval on a planned model (a collective: every rank calls
    it with the same queries and gets the same answer): the query rows by
    `planned_lookup`, the query tower, one `(B, V)` product with the whole
    index (`planned_build_item_index`) and `torch.topk`, as
    `models.two_tower.retrieve`. Returns `(scores (B, k), item_ids (B, k)
    int32)`."""
    cfg = model.config
    qt = model.query_tables
    with torch.inference_mode():
        q_cat = torch.as_tensor(q_cat).to(qt.device, torch.int32)
        q_rows = planned_lookup(mesh, qt, q_cat).transpose(0, 1)
        q = query_embed_from_rows(model.query_mlp, cfg,
                                  torch.as_tensor(dense).to(qt.device),
                                  q_rows)
        scores, ids = torch.topk(q @ index.T, k, dim=-1)
    return scores, ids.to(torch.int32)
