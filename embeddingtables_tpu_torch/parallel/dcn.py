"""Multi-card DCN-v2 (counterpart of `embeddingtables_tpu/parallel/dcn.py`):
the sharded DLRM's decomposition with DCN's towers.

The cross layers, deep tower and head are replicated on every rank; the
stacked table is mod-row-sharded over the mesh axis and rides the gather
exchange (`sharded.py`). The train step is `parallel.dlrm.gather_train_step`
with DCN's forward: the tower gradients are the global mean's
(`_global_mean`) and the lazy update goes through `owned_apply`. Every rank
must call every step, eval and `unshard_dcn` in the same order: they are
collectives. The batch is each rank's data-axis block (`local_batch`, or
`batch_shardings`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.dcn import (DCN, DCNConfig, forward_from_embeddings,
                          single_device_only)
from ..models.dlrm import RowState, _param_list, with_dense_tx
from ..ops.ensemble import StackedTables
from ..optim import SparseSGD, check_dense_tx
from .dlrm import (_check_sharded_opt, _copy_layers, _lookup_gather,
                   batch_shardings, gather_train_step,
                   owned_updates)  # noqa: F401
from .sharded import ShardedStackedTables, shard_row_accum, unshard_row_state


class ShardedDCN(nn.Module):
    """A DCN over a mesh: replicated cross layers, deep tower and head,
    this rank's shard of the stacked table (`tables`), its rows' sparse
    optimizer state (`emb_state`) and the replicated tower optimizer state
    (`dense_opt_state`)."""

    emb_state = RowState("emb")
    cross, deep, head = DCN.cross, DCN.deep, DCN.head
    tower_params = DCN.tower_params

    def __init__(self, config: DCNConfig, cross, deep, head,
                 tables: ShardedStackedTables, emb_state=None,
                 dense_opt_state=None):
        super().__init__()
        self.config = config
        self.cross_params = _param_list(cross)
        self.deep_params = _param_list(deep)
        self.head_params = _param_list([head])
        self.tables = tables
        self.emb_state = (SparseSGD().init(tables.data) if emb_state is None
                          else emb_state)
        self.dense_opt_state = dense_opt_state

    def forward(self, dense, cat):
        """Logits of this rank's block (a collective)."""
        return make_sharded_dcn_eval_step(self.config, self.tables.mesh,
                                          self.tables.axis)(self, dense, cat)


def shard_dcn(model: DCN, mesh, axis="data", sparse_opt=None,
              dense_tx=None) -> ShardedDCN:
    """Place a single-device DCN on a mesh (`parallel.dlrm.shard_dlrm`'s
    rules): copy the towers, keep this rank's rows of the table and of its
    state, copy the tower state or make `dense_tx`'s."""
    single_device_only(model.config, "shard_dcn")
    st = ShardedStackedTables.shard(mesh, axis, model.tables)
    state = shard_row_accum(mesh, axis, st, model.emb_state,
                            sparse_opt or SparseSGD())
    dstate = model.dense_opt_state
    sm = ShardedDCN(model.config, _copy_layers(model.cross),
                    _copy_layers(model.deep),
                    tuple(t.detach().clone() for t in model.head), st, state,
                    None if dstate is None else dstate.clone())
    if dstate is None:
        with_dense_tx(sm, dense_tx)
    return sm


def make_sharded_dcn_train_step(cfg: DCNConfig, mesh, axis="data",
                                sparse_opt=None, dense_lr: float = 0.01,
                                dense_tx=None, microbatch=None):
    """`step(model, dense, cat, label, lr=None, generator=None) -> loss` on
    this rank's block, in place: the gather exchange (exact), `dense_tx`
    and `microbatch` as the sharded DLRM step takes them; `generator` is
    this rank's stochastic-rounding noise."""
    sparse_opt = sparse_opt or SparseSGD()
    check_dense_tx(dense_tx)
    _check_sharded_opt(sparse_opt)
    return gather_train_step(
        cfg, sparse_opt, dense_lr, dense_tx, microbatch,
        lookups=lambda m, c: [_lookup_gather(mesh, m.tables, cfg, c)],
        forward=lambda m, d, acts: forward_from_embeddings(
            m.cross, m.deep, m.head, cfg, d, acts[0]),
        update=owned_updates(cfg, sparse_opt, lambda m, deltas: [
            ("tables", "emb_state", deltas[0])]),
        entry="train_dcn", init_name="shard_dcn")


def make_sharded_dcn_eval_step(cfg: DCNConfig, mesh, axis="data"):
    """`step(model, dense, cat) -> logits` of this rank's block, under
    `torch.inference_mode` (a collective)."""

    def step(model: ShardedDCN, dense, cat):
        device = model.tables.data.device
        with torch.inference_mode():
            emb_t = _lookup_gather(mesh, model.tables, cfg,
                                   torch.as_tensor(cat).to(device))
            return forward_from_embeddings(model.cross, model.deep,
                                           model.head, cfg,
                                           torch.as_tensor(dense).to(device),
                                           emb_t)
    return step


def unshard_dcn(model: ShardedDCN) -> DCN:
    """The single-device DCN on every rank (a collective)."""
    st = model.tables
    dstate = model.dense_opt_state
    return DCN(model.config, _copy_layers(model.cross),
               _copy_layers(model.deep),
               tuple(t.detach().clone() for t in model.head),
               StackedTables(st.unshard(), st.offsets, st.dim),
               unshard_row_state(st, model.emb_state),
               None if dstate is None else dstate.clone())
