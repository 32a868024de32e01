"""Multi-card DLRM: data-parallel towers, mod-row-sharded embeddings
(counterpart of `embeddingtables_tpu/parallel/dlrm.py`).

  - The towers are replicated on every rank. Each rank takes its data-axis
    block of the global batch (rank d of n: rows `[d*B/n, (d+1)*B/n)`, JAX's
    `P("data")`; `local_batch`), computes its local-mean loss and gradients,
    and one all-reduce of the flattened tower gradients and the loss over
    the data axis, divided by its size, gives every rank the gradient of
    the global mean loss and the global mean loss.
  - The stacked table is mod-row-sharded over the same axis (or the data x
    model product): every rank is a data-parallel worker and a shard owner.
    The lookup and the update ride the exact gather exchange
    (`sharded.py`) or the capacity-bounded butterfly (`alltoall.py`); the
    lazy delta is the global loss's (the local one divided by the data-axis
    size).
  - The sparse optimizer's state is sharded like the rows it describes and
    held by the model as buffers (`RowState`), so the shard's `apply` is
    the single-device one.

`gather_train_step` is the gather exchange's step body; the sharded DCN
and DeepFM steps (`parallel/dcn.py`, `parallel/deepfm.py`) run it with
their own lookups, forward and stacks, as JAX's families share
`_sharded_sparse_apply`, and the planned families (`parallel/planner.py`)
with the planner's lookup and update.

The steps update the model in place and return the loss (the port's
counterpart of JAX's donated model). Every rank must call every step, eval
and `unshard_dlrm` in the same order: they are collectives.

Stochastic rounding draws each rank's noise from its own generator
(`rank_generator`, seeded from `(seed, rank)`); JAX folds the shard index
into one key (ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.dlrm import (DLRM, DLRMConfig, RowState, _init_mlp, _pairs,
                           _param_list, bce_loss, forward_from_embeddings,
                           microbatch_slices, step_generator, with_dense_tx)
from ..models.microbatch import microbatch_grads
from ..ops.ensemble import StackedTables
from ..ops.sparse_update import SparseEmbeddingUpdate
from ..optim import (SparseFTRL, SparseLazyAdam, SparseRowWiseAdaGrad,
                     SparseSGD, apply_dense_tx, check_dense_tx,
                     require_dense_state)
from ..utils.telemetry import phase
from .alltoall import sharded_lookup_a2a, sharded_update_a2a
from .mesh import mesh_device
from .sharded import (Exchange, ShardedStackedTables, owned_apply,
                      shard_row_accum, sharded_ensemble_lookup,
                      unshard_row_state)


class ShardedDLRM(nn.Module):
    """A DLRM over a mesh: replicated towers (`bottom_params`,
    `top_params`), this rank's shard of the stacked table (`tables`, a
    `ShardedStackedTables`), its rows' sparse optimizer state (`emb_state`,
    the single-device state types with local shapes) and the replicated
    tower optimizer state (`dense_opt_state`)."""

    emb_state = RowState("emb")

    def __init__(self, config: DLRMConfig, bottom, top,
                 tables: ShardedStackedTables, emb_state=None,
                 dense_opt_state=None):
        super().__init__()
        self.config = config
        self.bottom_params = _param_list(bottom)
        self.top_params = _param_list(top)
        self.tables = tables
        self.emb_state = (SparseSGD().init(tables.data) if emb_state is None
                          else emb_state)
        self.dense_opt_state = dense_opt_state

    def tower_params(self) -> list:
        """`(name, parameter)` of the towers, the train step's order."""
        return list(self.named_parameters())

    @property
    def bottom(self):
        return _pairs(self.bottom_params)

    @property
    def top(self):
        return _pairs(self.top_params)

    def forward(self, dense, cat):
        """Logits of this rank's block (a collective)."""
        return make_sharded_eval_step(self.config, self.tables.mesh,
                                      self.tables.axis)(self, dense, cat)


def _copy_layers(layers) -> list:
    return [tuple(t.detach().clone() for t in layer) for layer in layers]


def shard_dlrm(model: DLRM, mesh, axis="data", sparse_opt=None,
               dense_tx=None) -> ShardedDLRM:
    """Place a single-device DLRM on a mesh: copy the towers, keep this
    rank's rows of the stacked table and of its optimizer state
    (`shard_row_accum`), copy the tower state, or make `dense_tx`'s when the
    model has none. Every rank must pass the same model (the same seed or
    the same arrays)."""
    sparse_opt = sparse_opt or SparseSGD()
    st = ShardedStackedTables.shard(mesh, axis, model.tables)
    state = shard_row_accum(mesh, axis, st, model.emb_state, sparse_opt)
    dstate = model.dense_opt_state
    sm = ShardedDLRM(model.config, _copy_layers(model.bottom),
                     _copy_layers(model.top), st, state,
                     None if dstate is None else dstate.clone())
    if dstate is None:
        with_dense_tx(sm, dense_tx)
    return sm


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """A generator of its own for each rank, seeded from `(seed, rank)`."""
    return torch.Generator(device=device).manual_seed(
        int(seed) * 65_537 + int(rank) + 1)


def init_sharded_dlrm(cfg: DLRMConfig, mesh, axis="data", sparse_opt=None,
                      dense_tx=None, seed: int = 0) -> ShardedDLRM:
    """A random DLRM made directly on the mesh: the towers from `seed` (the
    same on every rank), each rank's table shard from its own generator
    (`rank_generator(seed, rank)`), so the full table never exists
    anywhere; `sparse_opt`'s fresh state of the shard's rows."""
    device = mesh_device(mesh)
    g = torch.Generator(device=device).manual_seed(seed)
    bottom = _init_mlp((cfg.num_dense,) + cfg.bottom_mlp, cfg.param_dtype, g,
                       device)
    top = _init_mlp((cfg.interaction_features,) + cfg.top_mlp,
                    cfg.param_dtype, g, device)
    ex = Exchange(mesh, axis)
    st = ShardedStackedTables.init_sharded(
        mesh, axis, cfg.vocab_sizes, cfg.dim, dtype=cfg.tables_dtype,
        generator=rank_generator(seed, ex.me, device), device=device)
    state = (sparse_opt or SparseSGD()).init(st.data)
    return with_dense_tx(ShardedDLRM(cfg, bottom, top, st, state), dense_tx)


def unshard_dlrm(model: ShardedDLRM) -> DLRM:
    """The single-device DLRM on every rank (a collective): the full table
    and optimizer state gathered from the shards, the towers and the tower
    state copied."""
    st = model.tables
    dstate = model.dense_opt_state
    return DLRM(model.config, _copy_layers(model.bottom),
                _copy_layers(model.top),
                StackedTables(st.unshard(), st.offsets, st.dim),
                unshard_row_state(st, model.emb_state),
                None if dstate is None else dstate.clone())


def _block(ex: Exchange, b: int) -> slice:
    if b % ex.n_data:
        raise ValueError(f"a batch of {b} does not split over the "
                         f"{ex.n_data} ranks of the data axis")
    size = b // ex.n_data
    return slice(ex.data_index * size, (ex.data_index + 1) * size)


def _local_block(ex: Exchange, dense, cat, label=None):
    sl = _block(ex, dense.shape[0])
    out = (dense[sl], cat[:, sl])
    return out if label is None else out + (label[sl],)


def local_batch(mesh, axis, dense, cat, label=None):
    """This rank's data-axis block of a global batch (numpy arrays or
    tensors): dense `(B, F)`, cat `(T, B[, bag])`, label `(B,)`."""
    return _local_block(Exchange(mesh, axis), dense, cat, label)


class BlockSharding:
    """The port's reading of a JAX batch `NamedSharding`: called on a
    global array, it returns this rank's data-axis block of dimension
    `dim` (what `jax.device_put(x, sharding)` leaves on this device)."""

    def __init__(self, ex: Exchange, dim: int):
        self.exchange, self.dim = ex, dim

    def __call__(self, x):
        sl = _block(self.exchange, x.shape[self.dim])
        return x[sl] if self.dim == 0 else x[:, sl]


def batch_shardings(mesh, axis="data"):
    """`(dense, cat, label)` block shardings of a global batch, dims 0, 1
    and 0 (JAX's `P(data)`, `P(None, data)`, `P(data)`): `local_batch` one
    array at a time. The two-tower batch `(dense, q_cat, item_ids)` takes
    the same."""
    ex = Exchange(mesh, axis)
    return BlockSharding(ex, 0), BlockSharding(ex, 1), BlockSharding(ex, 0)


def _padded_stack_inputs(st: ShardedStackedTables, cat: torch.Tensor,
                         combiner: str, pad_idx, *,
                         global_sentinel: bool = False):
    """`(shifted (T, b[, bag]) global ids, per-occurrence scale or None)`.
    Pads are found before the shift: they go to each table's row 0 with
    scale 0 (the gather exchange), or with `global_sentinel` to -1, which
    the butterfly drops at routing. The scale is the lazy update's weights:
    the pad mask, normalized per (table, example) for the mean."""
    offs = torch.tensor(st.offsets[:-1], dtype=torch.int32,
                        device=cat.device).view(-1, *([1] * (cat.dim() - 1)))
    cat = cat.to(torch.int32)
    if pad_idx is None:
        return cat + offs, None
    valid = cat != pad_idx
    if global_sentinel:
        shifted = torch.where(valid, cat + offs, -1)
    else:
        shifted = torch.where(valid, cat, 0) + offs
    w = valid.float()
    if combiner == "mean" and cat.dim() == 3:
        w = w / torch.clamp_min(w.sum(dim=2, keepdim=True), 1e-12)
    return shifted.to(torch.int32), w


def _check_sharded_opt(sparse_opt, exchange: str = "gather") -> None:
    """The sharded steps take SGD, row-wise AdaGrad, lazy Adam and FTRL,
    stochastic rounding included."""
    allowed = (SparseSGD, SparseRowWiseAdaGrad, SparseLazyAdam, SparseFTRL)
    if not isinstance(sparse_opt, allowed):
        raise NotImplementedError(
            f"sharded train step (exchange={exchange!r}) supports "
            f"{' / '.join(c.__name__ for c in allowed)}, "
            f"got {type(sparse_opt).__name__}")


def _local_grads(params, acts, loss_fn):
    """Local-mean loss, tower gradients (zeros for a parameter the forward
    does not use) and the cotangents of the activation sets `acts` of one
    block; `loss_fn(acts)` is the block's loss."""
    with torch.enable_grad():
        acts = [a.detach().requires_grad_(True) for a in acts]
        with phase("step.forward"):
            loss = loss_fn(acts)
        with phase("step.backward"):
            out = torch.autograd.grad(loss, params + acts, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, out[:len(params)])]
    return loss.detach(), grads, tuple(out[len(params):])


def _global_mean(ex: Exchange, loss, grads):
    """The global mean loss and its tower gradients: ONE all-reduce of the
    flattened local ones over the data axis, divided by its size."""
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.reshape(1).float()])
    with ex.timed("all_reduce"):
        dist.all_reduce(flat, group=ex.data_group)
    flat = flat / ex.n_data
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    return flat[-1], out


def _lookup_gather(mesh, st, cfg, cat):
    """The gather exchange's `(T, b, D)` activations (JAX's `lookup_fn`)."""
    with torch.no_grad():
        if cfg.pad_idx is not None:
            return sharded_ensemble_lookup(mesh, st, cat, stacked=True,
                                           combiner=cfg.combiner,
                                           pad_idx=cfg.pad_idx)
        e = sharded_ensemble_lookup(mesh, st, cat, stacked=True)
        if cfg.combiner == "mean" and cat.dim() == 3:
            e = e / cat.shape[2]
        return e


def tables_device(tables) -> torch.device:
    """The device of a model's tables: a sharded stack's shard, or a
    planned placement's (`parallel.planner.PlannedTables.device`)."""
    data = getattr(tables, "data", None)
    return data.device if data is not None else tables.device


def owned_updates(cfg, sparse_opt, stacks):
    """The gather exchange's update hook of `gather_train_step`:
    `stacks(model, deltas)` names `[(tables attr, state attr, delta)]`, the
    lazy update of each stack, and each stack takes one `owned_apply`, in
    order, drawing its stochastic rounding from the one generator."""

    def update(model, cat, deltas, lr, kw):
        shifted, scale = _padded_stack_inputs(model.tables, cat, cfg.combiner,
                                              cfg.pad_idx)
        idx = shifted.transpose(0, 1).contiguous()
        scale = None if scale is None else scale.transpose(0, 1).contiguous()
        for tables_attr, state_attr, delta in stacks(model, deltas):
            setattr(model, state_attr, owned_apply(
                getattr(model, tables_attr), idx,
                delta.transpose(0, 1).contiguous(), scale, sparse_opt,
                getattr(model, state_attr), lr=lr, **kw))

    return update


def gather_train_step(cfg, sparse_opt, dense_lr: float, dense_tx, microbatch,
                      *, lookups, forward, update, entry: str,
                      init_name: str):
    """The gather exchange's train step of any sharded or planned CTR
    family, `step(model, dense, cat, label, lr=None, generator=None) ->
    loss`, in place:

      lookups(model, cat) -> [acts]    the `(T, b, D_i)` activation sets,
                                       looked up without gradients
      forward(model, dense, acts)      the block's logits `(b,)`
      update(model, cat, deltas, lr, kw)
                                       the lazy update of the tables from
                                       the activation sets' cotangents
                                       (`owned_updates`, or the planner's
                                       `planned_apply`); `kw` holds the
                                       stochastic-rounding generator

    The local-mean gradients (over `microbatch=k` slices of the block when
    k > 1) become the global mean's (`_global_mean`); the deltas are
    divided by the data-axis size (and by the bag for an unpadded mean)
    before the update; the towers then step. The step opens the single-card
    step's telemetry phases (`models/dlrm.py::make_train_step`), and each
    collective its "exchange.<collective>" phase (`Exchange.timed`)."""
    k = microbatch_slices(microbatch)

    def step(model, dense, cat, label, lr=None, generator=None):
        kw = step_generator(sparse_opt, generator, entry)
        require_dense_state(model, dense_tx, init_name)
        device = tables_device(model.tables)
        dense = torch.as_tensor(dense).to(device)
        cat = torch.as_tensor(cat).to(device)
        label = torch.as_tensor(label).to(device)
        params = [p for _, p in model.tower_params()]
        ex = model.tables.exchange

        def slice_grads(d, c, l):
            with phase("step.lookup"):
                acts = lookups(model, c)
            return _local_grads(params, acts, lambda acts:
                                bce_loss(forward(model, d, acts), l))

        if k > 1:
            loss, grads, deltas = microbatch_grads(params, dense, cat, label,
                                                   k, slice_grads)
        else:
            loss, grads, deltas = slice_grads(dense, cat, label)
        loss, grads = _global_mean(ex, loss, grads)
        with phase("step.sparse_update"):
            deltas = [d.float() / ex.n_data for d in deltas]
            if cfg.pad_idx is None and cfg.combiner == "mean" and \
                    cat.dim() == 3:
                deltas = [d / cat.shape[2] for d in deltas]
            update(model, cat, deltas, lr, kw)
        with phase("step.dense_update"):
            apply_dense_tx(params, grads, dense_tx, model.dense_opt_state,
                           dense_lr)
        return loss

    return step


def make_sharded_train_step(cfg: DLRMConfig, mesh, axis="data",
                            sparse_opt=None, dense_lr: float = 0.01,
                            exchange: str = "gather",
                            capacity_factor: float = 2.0,
                            with_overflow: bool = False, dense_tx=None,
                            wire_dtype=None, microbatch=None):
    """The multi-card train step,
    `step(model, dense, cat, label, lr=None, generator=None) -> loss`, on
    this rank's block of the batch (`local_batch`), in place.

    exchange: "gather" (exact: `sharded.py`, `gather_train_step`) or "a2a"
    (the butterfly: occurrences past `capacity_factor`'s headroom per owner
    are dropped); with `with_overflow` the a2a step returns `(loss,
    overflow)`, the forward's and the update's dropped occurrences summed
    over the ranks. `wire_dtype` casts the butterfly's row payloads.
    `dense_tx` steps the replicated towers with a `torch.optim` factory
    (the model holds its state). `microbatch=k` (gather only) takes the
    gradients over k slices of the block before ONE update. `generator`:
    this rank's stochastic rounding noise, required with
    `stochastic_rounding`."""
    sparse_opt = sparse_opt or SparseSGD()
    check_dense_tx(dense_tx)
    if exchange not in ("gather", "a2a"):
        raise ValueError(exchange)
    if microbatch and microbatch > 1 and exchange != "gather":
        raise NotImplementedError(
            "microbatch accumulation rides the gather exchange only (the "
            "a2a butterfly's per-slice capacity buckets would change the "
            "drop semantics); pass exchange='gather' or drop microbatch")
    if wire_dtype is not None and exchange != "a2a":
        raise ValueError(
            "wire_dtype applies to the a2a butterfly's row payloads only "
            "(the gather exchange reduces on the wire); pass "
            "exchange='a2a' or drop wire_dtype")
    _check_sharded_opt(sparse_opt, exchange=exchange)
    if exchange == "gather":
        return gather_train_step(
            cfg, sparse_opt, dense_lr, dense_tx, microbatch,
            lookups=lambda m, c: [_lookup_gather(mesh, m.tables, cfg, c)],
            forward=lambda m, d, acts: forward_from_embeddings(
                m.bottom, m.top, cfg, d, acts[0]),
            update=owned_updates(cfg, sparse_opt, lambda m, deltas: [
                ("tables", "emb_state", deltas[0])]),
            entry="train_dlrm", init_name="init_sharded_dlrm")

    def step_a2a(model, dense, cat, label, lr=None, generator=None):
        kw = step_generator(sparse_opt, generator, "train_dlrm")
        require_dense_state(model, dense_tx, "init_sharded_dlrm")
        device = model.tables.data.device
        dense = torch.as_tensor(dense).to(device)
        cat = torch.as_tensor(cat).to(device)
        label = torch.as_tensor(label).to(device)
        params = [p for _, p in model.tower_params()]
        if lr is not None and isinstance(sparse_opt, SparseFTRL):
            raise ValueError(
                "SparseFTRL cannot change lr per step: alpha is baked into "
                "the accumulated z state (drop lr_schedule or use another "
                "optimizer)")
        st = model.tables
        ex = st.exchange
        t, dim = st.ntables, cfg.dim
        bag = cat.shape[2] if cat.dim() == 3 else None
        shifted_tb, scale_tb = _padded_stack_inputs(
            st, cat, cfg.combiner, cfg.pad_idx, global_sentinel=True)
        shifted_bt = shifted_tb.transpose(0, 1).contiguous()
        b = shifted_bt.shape[0]
        a2a_pad = None if cfg.pad_idx is None else -1
        opts = dict(capacity_factor=capacity_factor, pad_idx=a2a_pad,
                    wire_dtype=wire_dtype)
        with phase("step.lookup"), torch.no_grad():
            if bag is None:
                emb_bt, ovf_fwd = sharded_lookup_a2a(
                    mesh, st, shifted_bt, reducing=False, **opts)
            else:
                rows, ovf_fwd = sharded_lookup_a2a(
                    mesh, st, shifted_bt.reshape(b, t * bag),
                    reducing=False, **opts)
                emb_bt = rows.reshape(b, t, bag, dim).sum(dim=2)
                if cfg.combiner == "mean":
                    if a2a_pad is not None:
                        denom = torch.clamp_min(
                            (shifted_bt >= 0).sum(dim=2).float(), 1e-12)
                        emb_bt = emb_bt / denom[..., None].to(emb_bt.dtype)
                    else:
                        emb_bt = emb_bt / bag
        loss, grads, (delta_t,) = _local_grads(
            params, [emb_bt.transpose(0, 1).contiguous()],
            lambda acts: bce_loss(forward_from_embeddings(
                model.bottom, model.top, cfg, dense, acts[0]), label))
        loss, grads = _global_mean(ex, loss, grads)
        with phase("step.sparse_update"):
            delta_bt = (delta_t.float() / ex.n_data).transpose(0, 1).reshape(
                -1, dim)
            upd_w = None
            if scale_tb is not None:
                scale_bt = scale_tb.transpose(0, 1)
                upd_w = scale_bt.reshape((-1,) if bag is None
                                         else (b * t, bag))
            elif bag is not None and cfg.combiner == "mean":
                delta_bt = delta_bt / bag
            upd = SparseEmbeddingUpdate(
                delta=delta_bt,
                indices=shifted_bt.reshape((-1,) if bag is None
                                           else (b * t, bag)),
                weights=upd_w)
            model.emb_state, ovf_bwd = sharded_update_a2a(
                mesh, st, model.emb_state, upd, sparse_opt, lr=lr, **opts,
                **kw)
        with phase("step.dense_update"):
            apply_dense_tx(params, grads, dense_tx, model.dense_opt_state,
                           dense_lr)
        if with_overflow:
            return loss, ovf_fwd + ovf_bwd
        return loss

    return step_a2a


def make_sharded_eval_step(cfg: DLRMConfig, mesh, axis="data"):
    """`step(model, dense, cat) -> logits` of this rank's block, under
    `torch.inference_mode` (a collective: every rank calls it)."""

    def step(model: ShardedDLRM, dense, cat):
        device = model.tables.data.device
        with torch.inference_mode():
            dense = torch.as_tensor(dense).to(device)
            cat = torch.as_tensor(cat).to(device)
            emb_t = _lookup_gather(mesh, model.tables, cfg, cat)
            return forward_from_embeddings(model.bottom, model.top, cfg,
                                           dense, emb_t)
    return step


def sharded_logits(model: ShardedDLRM, dense, cat,
                   eval_step: Optional[object] = None) -> torch.Tensor:
    """The logits of a whole global batch on every rank: each rank scores
    its block, then the blocks are all-gathered (a collective)."""
    st = model.tables
    step = eval_step or make_sharded_eval_step(model.config, st.mesh,
                                               st.axis)
    d, c = _local_block(st.exchange, dense, cat)
    return st.exchange.gather_batch(step(model, d, c))
