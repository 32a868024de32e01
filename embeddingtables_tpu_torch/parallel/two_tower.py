"""The two-tower retriever over a mesh (counterpart of
`embeddingtables_tpu/parallel/two_tower.py`).

Serving (`build_sharded_item_index`, `make_sharded_retriever`,
`sharded_retrieve`): the corpus index is block-row sharded. The item table
is padded to a multiple of n by repeating its last row, and rank r embeds
only the rows `[r * v_pad / n, (r + 1) * v_pad / n)`. The queries are
replicated: every rank scores its block, masks ids `>= item_vocab` to
-inf, takes a local top k, and the n * k candidates are all-gathered and
merged into the global top k. Scores come in descending order; among equal
scores the ids' order is `torch.topk`'s (ROADMAP.md queue 3, "Top-k
ties").

Training (`ShardedTwoTower`, `shard_two_tower`,
`make_sharded_tt_train_step`, `unshard_two_tower`): the MLPs are replicated,
the query stack and the item table are mod-row-sharded, and the batch is
split over the data axis (`tt_batch_shardings`). The in-batch softmax
couples the whole global batch, which JAX leaves to GSPMD; here it is
written out:

  - the item embeddings are all-gathered over the data group, with an
    autograd function whose backward reduce-scatters (sums) their
    cotangents, so each rank's item rows get every rank's gradient;
  - each rank's b query rows are scored against all B items, its positive
    on the diagonal at offset `data_index * b`;
  - the local means of the loss and accuracy and the MLP gradients go
    through ONE all-reduce (`_global_mean`), which gives the global mean's;
  - both lazy updates ride the gather exchange (`owned_apply`), the
    cotangents divided by the data-axis size.

On one rank the step is bitwise the single-device `make_train_step`; on
more, the all-gathered logits add in another order (ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.dlrm import RowState, _param_list, step_generator
from ..models.two_tower import (TwoTower, TwoTowerConfig,
                                item_embed_from_rows, query_embed_from_rows,
                                _query_ids, _rows_btd)
from ..ops.ensemble import StackedTables
from ..ops.lookup import lookup
from ..optim import SparseSGD, apply_dense_tx
from ..tables import SimpleEmbedding
from .dlrm import (_check_sharded_opt, _copy_layers, _global_mean,
                   _local_grads, batch_shardings)
from .sharded import (Exchange, ShardedStackedTables, owned_apply,
                      shard_row_accum, sharded_ensemble_lookup,
                      sharded_lookup, unshard_row_state)


# ---------------------------------------------------------------------------
# Serving: the block-row-sharded index
# ---------------------------------------------------------------------------

def build_sharded_item_index(model: TwoTower, mesh, axis="data",
                             batch: int = 65_536) -> torch.Tensor:
    """This rank's block `(v_pad / n, embed_dim)` of the corpus index: the
    item tower over rows `[me * v_pad / n, (me + 1) * v_pad / n)` of the
    item table padded with its last row, `batch` rows (one `gather_rows`)
    at a time. Each rank embeds only its own rows."""
    cfg = model.config
    ex = Exchange(mesh, axis)
    v = cfg.item_vocab
    rows = -(-v // ex.n)
    lo = ex.me * rows
    device = model.item_data.device
    outs = []
    with torch.inference_mode():
        for s in range(lo, lo + rows, batch):
            ids = torch.arange(s, min(lo + rows, s + batch), dtype=torch.int32,
                               device=device).clamp_(max=v - 1)
            outs.append(item_embed_from_rows(model.item_mlp, cfg,
                                             model.item_table.rows(ids)))
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def make_sharded_retriever(model: TwoTower, mesh, k: int = 10, axis="data"):
    """A retriever over a sharded index (a collective: every rank calls it
    with the same queries): `fn(index, dense, q_cat[, query_mlp,
    query_tables_data]) -> (scores (B, k), ids (B, k) int32)`, the same on
    every rank; `index` is this rank's block (`build_sharded_item_index`).
    The optional trailing arguments serve updated parameters."""
    cfg = model.config
    qt = model.query_tables
    ex = Exchange(mesh, axis)
    v = cfg.item_vocab

    def fn(index, dense, q_cat, query_mlp=None, query_tables_data=None):
        qmlp = model.query_mlp if query_mlp is None else query_mlp
        qdata = qt.data if query_tables_data is None else query_tables_data
        with torch.inference_mode():
            rows = lookup(SimpleEmbedding(qdata), _query_ids(qt, q_cat))
            q = query_embed_from_rows(
                qmlp, cfg, torch.as_tensor(dense).to(qdata.device),
                _rows_btd(rows, qt.ntables, cfg.dim))
            scores = q @ index.T                               # (B, v_pad/n)
            gids = ex.me * index.shape[0] + torch.arange(
                index.shape[0], device=index.device, dtype=torch.int32)
            scores = scores.masked_fill((gids >= v)[None, :], -float("inf"))
            ls, li = torch.topk(scores, k, dim=-1)
            lids = gids[li]
            b = ls.shape[0]
            cs = ex.gather_flat(ls).permute(1, 0, 2).reshape(b, -1)
            ci = ex.gather_flat(lids).permute(1, 0, 2).reshape(b, -1)
            gs, gi = torch.topk(cs, k, dim=-1)
        return gs, ci.gather(1, gi)

    return fn


def sharded_retrieve(model: TwoTower, index: torch.Tensor, mesh, dense,
                     q_cat, k: int = 10, axis="data"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a sharded index, one shot (`make_sharded_retriever`)."""
    return make_sharded_retriever(model, mesh, k=k, axis=axis)(index, dense,
                                                               q_cat)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class ShardedTwoTower(nn.Module):
    """A two-tower model over a mesh: the replicated MLPs, this rank's
    shards of the query stack (`query_tables`) and of the item table
    (`item_table`), each with its rows' sparse optimizer state (`q_state`,
    `i_state`)."""

    q_state = RowState("q")
    i_state = RowState("i")
    query_mlp, item_mlp = TwoTower.query_mlp, TwoTower.item_mlp

    def __init__(self, config: TwoTowerConfig,
                 query_tables: ShardedStackedTables,
                 item_table: ShardedStackedTables, query_mlp, item_mlp,
                 q_state=None, i_state=None):
        super().__init__()
        self.config = config
        self.query_tables = query_tables
        self.item_table = item_table
        self.query_mlp_params = _param_list(query_mlp)
        self.item_mlp_params = _param_list(item_mlp)
        self.q_state = (SparseSGD().init(query_tables.data) if q_state is None
                        else q_state)
        self.i_state = (SparseSGD().init(item_table.data) if i_state is None
                        else i_state)


def shard_two_tower(model: TwoTower, mesh, axis="data",
                    sparse_opt=None) -> ShardedTwoTower:
    """Place a single-device two-tower model on a mesh: copy the MLPs,
    keep this rank's rows of both tables and of their states."""
    sparse_opt = sparse_opt or SparseSGD(0.05)
    st_q = ShardedStackedTables.shard(mesh, axis, model.query_tables)
    st_i = ShardedStackedTables.shard(mesh, axis, model.item_data)
    return ShardedTwoTower(
        model.config, st_q, st_i, _copy_layers(model.query_mlp),
        _copy_layers(model.item_mlp),
        shard_row_accum(mesh, axis, st_q, model.q_state, sparse_opt),
        shard_row_accum(mesh, axis, st_i, model.i_state, sparse_opt))


def tt_batch_shardings(mesh, axis="data"):
    """`(dense, q_cat, item_ids)` block shardings of a global two-tower
    batch, dims 0, 1 and 0 (`parallel.dlrm.batch_shardings`)."""
    return batch_shardings(mesh, axis)


class _GatherItems(torch.autograd.Function):
    """All-gather `(b, E)` over the data group -> `(n_data * b, E)`; the
    backward reduce-scatters the cotangent, summing every rank's part."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return ex.gather_batch(x)

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        out = torch.empty((g.shape[0] // ex.n_data,) + tuple(g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        with ex.timed("reduce_scatter"):
            dist.reduce_scatter_tensor(out, g.contiguous(),
                                       group=ex.data_group)
        return out, None


def _softmax_over_ranks(ex: Exchange, q, i, temperature: float):
    """The block's local-mean in-batch softmax loss and accuracy against
    every rank's items: row r's positive is global item
    `data_index * b + r`."""
    logits = (q @ _GatherItems.apply(i, ex).T) / temperature
    off = ex.data_index * q.shape[0]
    loss = -torch.mean(F.log_softmax(logits, dim=-1).diagonal(off))
    labels = off + torch.arange(q.shape[0], device=q.device)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, acc


def make_sharded_tt_train_step(cfg: TwoTowerConfig, mesh, axis="data",
                               sparse_opt=None, dense_lr: float = 0.05):
    """The contrastive train step on this rank's block (`tt_batch_shardings`),
    `step(model, dense, q_cat, item_ids, generator=None) -> (loss, acc)`,
    in place: the global batch's loss and in-batch top-1 accuracy. The
    query stack's update, then the item table's (under stochastic rounding
    both from this rank's `generator`), then plain SGD on both MLPs."""
    sparse_opt = sparse_opt or SparseSGD(0.05)
    _check_sharded_opt(sparse_opt)

    def step(model: ShardedTwoTower, dense, q_cat, item_ids, generator=None):
        kw = step_generator(sparse_opt, generator, "train_two_tower")
        st_q, st_i = model.query_tables, model.item_table
        ex = st_q.exchange
        device = st_q.data.device
        dense = torch.as_tensor(dense).to(device)
        q_cat = torch.as_tensor(q_cat).to(device, torch.int32)
        item_ids = torch.as_tensor(item_ids).to(device, torch.int32)
        with torch.no_grad():
            q_rows = sharded_ensemble_lookup(mesh, st_q, q_cat,
                                             stacked=True).permute(1, 0, 2)
            i_rows = sharded_lookup(mesh, st_i, item_ids)
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
        shifted = torch.stack([q_cat[t] + st_q.offsets[t]
                               for t in range(st_q.ntables)])
        model.q_state = owned_apply(
            st_q, shifted.transpose(0, 1).contiguous(),
            q_delta.float() / ex.n_data, None, sparse_opt, model.q_state,
            **kw)
        model.i_state = owned_apply(st_i, item_ids,
                                    i_delta.float() / ex.n_data, None,
                                    sparse_opt, model.i_state, **kw)
        apply_dense_tx(params, grads, None, None, dense_lr)
        return loss, acc

    return step


def unshard_two_tower(model: ShardedTwoTower) -> TwoTower:
    """The single-device two-tower model on every rank (a collective)."""
    st_q, st_i = model.query_tables, model.item_table
    return TwoTower(model.config,
                    StackedTables(st_q.unshard(), st_q.offsets, st_q.dim),
                    st_i.unshard(), _copy_layers(model.query_mlp),
                    _copy_layers(model.item_mlp),
                    unshard_row_state(st_q, model.q_state),
                    unshard_row_state(st_i, model.i_state))
