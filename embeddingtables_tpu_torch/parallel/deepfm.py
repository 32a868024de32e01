"""Multi-card DeepFM (counterpart of `embeddingtables_tpu/parallel/deepfm.py`):
the sharded DLRM's decomposition with DeepFM's towers and FM terms.

The deep tower, head, `dense_w` and `bias` are replicated on every rank;
the stack(s) are mod-row-sharded over the mesh axis and ride the gather
exchange (`sharded.py`). Folded (`cfg.folded`): ONE fused `(sum V, D + 1)`
stack, so one exchange each way a step; the two cotangents fuse back
(`fuse_delta`) before the one update. Unfolded: the D-wide stack and the
1-wide first-order stack, each with its own row state, each with its own
exchange; with `use_fm=False` the first-order stack takes no exchange at
all. The train step is `parallel.dlrm.gather_train_step`: under stochastic
rounding the second stack draws its noise from the rank's generator after
the first (JAX folds 1 into the key; ROADMAP.md queue 3).
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.deepfm import (DeepFM, DeepFMConfig, forward_from_embeddings,
                             fuse_delta, split_fused)
from ..models.dlrm import RowState, _param_list, with_dense_tx
from ..ops.ensemble import StackedTables
from ..optim import SparseSGD, check_dense_tx
from .dlrm import (_check_sharded_opt, _copy_layers, _lookup_gather,
                   batch_shardings, gather_train_step,
                   owned_updates)  # noqa: F401
from .sharded import ShardedStackedTables, shard_row_accum, unshard_row_state


class ShardedDeepFM(nn.Module):
    """A DeepFM over a mesh: the replicated deep tower, head, `dense_w` and
    `bias`; this rank's shard of the FM stack (`tables`, fused D + 1 wide
    when folded) and of the first-order stack (`fm_w`, None when folded),
    each stack's row state (`emb_state`, `fm_state`) and the replicated
    tower optimizer state (`dense_opt_state`)."""

    emb_state = RowState("emb")
    fm_state = RowState("fm", optional=True)
    deep, head, dense_params = DeepFM.deep, DeepFM.head, DeepFM.dense_params
    tower_params = DeepFM.tower_params

    def __init__(self, config: DeepFMConfig, deep, head, dense_w, bias,
                 tables: ShardedStackedTables, fm_w=None, emb_state=None,
                 fm_state=None, dense_opt_state=None):
        super().__init__()
        self.config = config
        self.deep_params = _param_list(deep)
        self.head_params = _param_list([head])
        self.dense_w = nn.Parameter(dense_w)
        self.bias = nn.Parameter(bias)
        self.tables = tables
        self.fm_w = fm_w
        self.emb_state = (SparseSGD().init(tables.data) if emb_state is None
                          else emb_state)
        if fm_w is not None and fm_state is None:
            fm_state = SparseSGD().init(fm_w.data)
        self.fm_state = fm_state
        self.dense_opt_state = dense_opt_state

    def forward(self, dense, cat):
        """Logits of this rank's block (a collective)."""
        return make_sharded_deepfm_eval_step(
            self.config, self.tables.mesh, self.tables.axis)(self, dense, cat)


def shard_deepfm(model: DeepFM, mesh, axis="data", sparse_opt=None,
                 dense_tx=None) -> ShardedDeepFM:
    """Place a single-device DeepFM on a mesh (`shard_dlrm`'s rules, on
    both stacks of the unfolded layout)."""
    sparse_opt = sparse_opt or SparseSGD()
    st = ShardedStackedTables.shard(mesh, axis, model.tables)
    sw = fm_state = None
    if model.fm_w is not None:
        sw = ShardedStackedTables.shard(mesh, axis, model.fm_w)
        fm_state = shard_row_accum(mesh, axis, sw, model.fm_state, sparse_opt)
    dstate = model.dense_opt_state
    sm = ShardedDeepFM(
        model.config, _copy_layers(model.deep),
        tuple(t.detach().clone() for t in model.head),
        model.dense_w.detach().clone(), model.bias.detach().clone(), st, sw,
        shard_row_accum(mesh, axis, st, model.emb_state, sparse_opt),
        fm_state, None if dstate is None else dstate.clone())
    if dstate is None:
        with_dense_tx(sm, dense_tx)
    return sm


def _lookups(mesh, cfg: DeepFMConfig, model, cat):
    """`[emb_t (T, b, D), w_t (T, b, 1)]` (w_t left out with
    `use_fm=False`): one exchange of the fused stack split in two, or one
    exchange per stack."""
    g_t = _lookup_gather(mesh, model.tables, cfg, cat)
    if cfg.folded:
        w_t, emb_t = split_fused(g_t)
        return [emb_t, w_t]
    if not cfg.use_fm:
        return [g_t]
    return [g_t, _lookup_gather(mesh, model.fm_w, cfg, cat)]


def _forward(cfg: DeepFMConfig, model, dense, acts):
    return forward_from_embeddings(model.dense_params, cfg, dense, acts[0],
                                   acts[1] if cfg.use_fm else None)


def make_sharded_deepfm_train_step(cfg: DeepFMConfig, mesh, axis="data",
                                   sparse_opt=None, dense_lr: float = 0.01,
                                   dense_tx=None, microbatch=None):
    """`step(model, dense, cat, label, lr=None, generator=None) -> loss` on
    this rank's block, in place. Folded: one fused lazy update; unfolded:
    the FM stack's, then the first-order stack's (none with
    `use_fm=False`). `dense_tx` and `microbatch` as the sharded DLRM step
    takes them."""
    sparse_opt = sparse_opt or SparseSGD()
    check_dense_tx(dense_tx)
    _check_sharded_opt(sparse_opt)

    def stacks(m, deltas):
        if cfg.folded:
            return [("tables", "emb_state", fuse_delta(deltas[1], deltas[0]))]
        fm = [("fm_w", "fm_state", deltas[1])] if cfg.use_fm else []
        return [("tables", "emb_state", deltas[0])] + fm

    return gather_train_step(
        cfg, sparse_opt, dense_lr, dense_tx, microbatch,
        lookups=lambda m, c: _lookups(mesh, cfg, m, c),
        forward=lambda m, d, acts: _forward(cfg, m, d, acts),
        update=owned_updates(cfg, sparse_opt, stacks), entry="train_deepfm",
        init_name="shard_deepfm")


def make_sharded_deepfm_eval_step(cfg: DeepFMConfig, mesh, axis="data"):
    """`step(model, dense, cat) -> logits` of this rank's block, under
    `torch.inference_mode` (a collective)."""

    def step(model: ShardedDeepFM, dense, cat):
        device = model.tables.data.device
        with torch.inference_mode():
            acts = _lookups(mesh, cfg, model, torch.as_tensor(cat).to(device))
            return _forward(cfg, model, torch.as_tensor(dense).to(device),
                            acts)
    return step


def unshard_deepfm(model: ShardedDeepFM) -> DeepFM:
    """The single-device DeepFM on every rank (a collective)."""
    st, sw = model.tables, model.fm_w
    dstate = model.dense_opt_state
    return DeepFM(
        model.config, _copy_layers(model.deep),
        tuple(t.detach().clone() for t in model.head),
        model.dense_w.detach().clone(), model.bias.detach().clone(),
        StackedTables(st.unshard(), st.offsets, st.dim),
        None if sw is None else StackedTables(sw.unshard(), sw.offsets, 1),
        unshard_row_state(st, model.emb_state),
        None if sw is None else unshard_row_state(sw, model.fm_state),
        None if dstate is None else dstate.clone())
