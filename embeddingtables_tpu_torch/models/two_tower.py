"""Two-tower retrieval (counterpart of `embeddingtables_tpu/models/two_tower.py`).

The engine's other workload next to CTR ranking: a query tower over the
query's categorical features (one `StackedTables`) and dense features, and an
item tower over one large item table (`SimpleEmbedding`). Training is an
in-batch-negatives softmax; serving builds the item index once (the item
tower over every item) and retrieves the top k by a `(b, V)` score product.

As in the DLRM, the loss is differentiated with respect to the looked-up
rows, never the tables, and each table takes one lazy update in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import resolve_device
from ..ops.ensemble import StackedTables
from ..ops.lookup import lookup
from ..ops.sparse_update import SparseEmbeddingUpdate
from ..optim import SparseSGD, apply_dense_tx
from ..tables import SimpleEmbedding
from .dlrm import (RowState, _init_mlp, _mlp, _pairs, _param_list,
                   stacked_table_init, step_generator, uniform_rows)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    query_vocab_sizes: Tuple[int, ...]      # query-side categorical features
    item_vocab: int                          # item corpus size
    num_dense: int = 0                       # query-side dense features
    dim: int = 64                            # table feature size
    embed_dim: int = 64                      # final tower output dim
    query_mlp: Tuple[int, ...] = (128, 64)
    item_mlp: Tuple[int, ...] = (128, 64)
    temperature: float = 0.05
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    # Storage dtype of the embedding tables only (None = param_dtype).
    table_dtype: Optional[torch.dtype] = None

    @property
    def tables_dtype(self):
        return self.table_dtype if self.table_dtype is not None \
            else self.param_dtype

    def __post_init__(self):
        if self.query_mlp[-1] != self.embed_dim:
            raise ValueError("query_mlp must end at embed_dim")
        if self.item_mlp[-1] != self.embed_dim:
            raise ValueError("item_mlp must end at embed_dim")

    @property
    def num_query_tables(self) -> int:
        return len(self.query_vocab_sizes)


class TwoTower(nn.Module):
    """The query stack, the item table (`item_table`, a `SimpleEmbedding`
    over the `item_data` buffer), the two MLPs as `(W, b)` pairs, and each
    table's sparse-optimizer state (`q_state`, `i_state`) as buffers."""

    q_state = RowState("q")
    i_state = RowState("i")

    def __init__(self, config: TwoTowerConfig, query_tables: StackedTables,
                 item_data: torch.Tensor, query_mlp, item_mlp, q_state=None,
                 i_state=None):
        super().__init__()
        self.config = config
        self.query_tables = query_tables
        self.register_buffer("item_data", item_data)
        self.query_mlp_params = _param_list(query_mlp)
        self.item_mlp_params = _param_list(item_mlp)
        self.q_state = (SparseSGD().init(query_tables.data) if q_state is None
                        else q_state)
        self.i_state = (SparseSGD().init(item_data) if i_state is None
                        else i_state)

    @property
    def item_table(self) -> SimpleEmbedding:
        return SimpleEmbedding(self.item_data)

    @property
    def query_mlp(self):
        return _pairs(self.query_mlp_params)

    @property
    def item_mlp(self):
        return _pairs(self.item_mlp_params)


def init_two_tower(cfg: TwoTowerConfig,
                   generator: torch.Generator | None = None, device=None,
                   sparse_opt=None) -> TwoTower:
    """Random two-tower model on `device` (CUDA unless given): tables uniform
    in [-1, 1) / sqrt(dim), Glorot-normal MLPs, zero biases, and
    `sparse_opt`'s initial state for each table (default `SparseSGD`).
    `generator` must live on that device; by default one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sparse_opt = sparse_opt or SparseSGD()
    qtables = stacked_table_init(cfg.query_vocab_sizes, cfg.dim,
                                 cfg.tables_dtype, generator, device)
    items = uniform_rows(cfg.item_vocab, cfg.dim, cfg.tables_dtype,
                         generator, device)
    q_in = cfg.num_dense + cfg.num_query_tables * cfg.dim
    return TwoTower(
        cfg, qtables, items,
        _init_mlp((q_in,) + cfg.query_mlp, cfg.param_dtype, generator,
                  device),
        _init_mlp((cfg.dim,) + cfg.item_mlp, cfg.param_dtype, generator,
                  device),
        sparse_opt.init(qtables.data), sparse_opt.init(items))


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def query_embed_from_rows(qmlp, cfg: TwoTowerConfig, dense, q_rows):
    """Query tower given looked-up feature rows `(B, T, dim)`: the input is
    `[dense, feats]`, dense first (with `num_dense`)."""
    b = q_rows.shape[0]
    feats = q_rows.reshape(b, -1).to(cfg.compute_dtype)
    if cfg.num_dense:
        feats = torch.cat([dense.to(cfg.compute_dtype), feats], dim=-1)
    return _l2norm(_mlp(qmlp, feats, cfg.compute_dtype,
                        final_activation=False).float())


def item_embed_from_rows(imlp, cfg: TwoTowerConfig, i_rows):
    """Item tower given looked-up item rows `(B, dim)`."""
    return _l2norm(_mlp(imlp, i_rows.to(cfg.compute_dtype), cfg.compute_dtype,
                        final_activation=False).float())


def _query_ids(query_tables: StackedTables, q_cat) -> torch.Tensor:
    """`(T, B)` per-table ids -> flat stacked ids, T-major."""
    return query_tables.shift_indices(
        torch.as_tensor(q_cat).to(query_tables.data.device)).reshape(-1)


def _rows_btd(flat_rows: torch.Tensor, t: int, dim: int) -> torch.Tensor:
    """T-major `(T*B, dim)` rows -> `(B, T, dim)`."""
    return flat_rows.reshape(t, -1, dim).permute(1, 0, 2)


def _query_rows(model: TwoTower, q_cat) -> torch.Tensor:
    """`(T, B)` query feature ids -> `(B, T, dim)` by one stacked gather
    (note: not the DLRM's `(T, B, dim)`)."""
    qt = model.query_tables
    rows = lookup(SimpleEmbedding(qt.data), _query_ids(qt, q_cat))
    return _rows_btd(rows, qt.ntables, model.config.dim)


def two_tower_scores(model: TwoTower, dense, q_cat, item_ids) -> torch.Tensor:
    """Similarity q.i for aligned (query, item) pairs -> `(B,)`."""
    device = model.item_data.device
    q = query_embed_from_rows(model.query_mlp, model.config,
                              torch.as_tensor(dense).to(device),
                              _query_rows(model, q_cat))
    ids = torch.as_tensor(item_ids).to(device)
    i = item_embed_from_rows(model.item_mlp, model.config,
                             model.item_table.rows(ids))
    return torch.sum(q * i, dim=-1)


def in_batch_softmax_loss(q: torch.Tensor, i: torch.Tensor, temp: float):
    """In-batch-negatives softmax: row b's positive is item b, every other
    row a negative. Returns `(loss, accuracy)`; the `(B, B)` logits stay in
    float32."""
    logits = (q @ i.T) / temp
    labels = torch.arange(q.shape[0], device=q.device)
    loss = -torch.mean(F.log_softmax(logits, dim=-1).diagonal())
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, acc


def make_train_step(cfg: TwoTowerConfig, sparse_opt=None,
                    dense_lr: float = 0.05):
    """The contrastive train step,
    `step(model, dense, q_cat, item_ids, generator=None) -> (loss, acc)`,
    updating the model in place: two lazy updates, the query stack's (its
    ids T-major) and the item table's (by `item_ids`), each with its own
    state, then plain SGD on both MLPs. Defaults: `SparseSGD(0.05)`,
    `dense_lr=0.05`. Under stochastic rounding the item update draws its
    noise from the same generator after the query update."""
    sparse_opt = sparse_opt or SparseSGD(0.05)

    def step(model: TwoTower, dense, q_cat, item_ids, generator=None):
        kw = step_generator(sparse_opt, generator, "train_two_tower")
        device = model.item_data.device
        dense = torch.as_tensor(dense).to(device)
        item_ids = torch.as_tensor(item_ids).to(device)
        qt = model.query_tables
        q_ids = _query_ids(qt, q_cat)
        params = list(model.parameters())         # the tables are buffers
        with torch.no_grad():
            q_rows = _query_rows(model, q_cat).detach().requires_grad_(True)
            i_rows = model.item_table.rows(item_ids).requires_grad_(True)
        with torch.enable_grad():
            q = query_embed_from_rows(model.query_mlp, cfg, dense, q_rows)
            i = item_embed_from_rows(model.item_mlp, cfg, i_rows)
            loss, acc = in_batch_softmax_loss(q, i, cfg.temperature)
            *mlp_grads, q_delta, i_delta = torch.autograd.grad(
                loss, params + [q_rows, i_rows])
        q_upd = SparseEmbeddingUpdate(
            delta=q_delta.permute(1, 0, 2).reshape(-1, cfg.dim).float(),
            indices=q_ids)
        qt.data, model.q_state = sparse_opt.apply(qt.data, q_upd,
                                                  model.q_state, **kw)
        i_upd = SparseEmbeddingUpdate(delta=i_delta.float(),
                                      indices=item_ids.to(torch.int32))
        model.item_data, model.i_state = sparse_opt.apply(
            model.item_data, i_upd, model.i_state, **kw)
        apply_dense_tx(params, mlp_grads, None, None, dense_lr)
        return loss.detach(), acc.detach()

    return step


# ---------------------------------------------------------------------------
# Serving: the corpus index and top-k retrieval
# ---------------------------------------------------------------------------

def build_item_index(model: TwoTower, batch: int = 65_536) -> torch.Tensor:
    """The `(item_vocab, embed_dim)` corpus index: the item tower over every
    item, `batch` items (one `gather_rows`) at a time."""
    cfg = model.config
    device = model.item_data.device
    outs = []
    with torch.inference_mode():
        for lo in range(0, cfg.item_vocab, batch):
            ids = torch.arange(lo, min(cfg.item_vocab, lo + batch),
                               dtype=torch.int32, device=device)
            outs.append(item_embed_from_rows(model.item_mlp, cfg,
                                             model.item_table.rows(ids)))
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def make_retriever(model: TwoTower, k: int = 10):
    """A retriever for serving loops:
    `fn(index, dense, q_cat[, query_mlp, query_tables_data]) -> (scores (B,
    k), ids (B, k))`; the optional trailing arguments serve updated
    parameters without rebuilding. The query rows come through `lookup`
    (`gather_rows` on the card); the `(B, V)` score product and the top k are
    `torch.matmul` and `torch.topk`. Scores come in descending order; among
    equal scores the order of the ids, and which tied ids make the k-th
    place, are `torch.topk`'s (JAX's `top_k` puts the lower id first)."""
    cfg = model.config
    qt = model.query_tables

    def fn(index, dense, q_cat, query_mlp=None, query_tables_data=None):
        qmlp = model.query_mlp if query_mlp is None else query_mlp
        qdata = qt.data if query_tables_data is None else query_tables_data
        with torch.inference_mode():
            rows = lookup(SimpleEmbedding(qdata), _query_ids(qt, q_cat))
            q = query_embed_from_rows(
                qmlp, cfg, torch.as_tensor(dense).to(qdata.device),
                _rows_btd(rows, qt.ntables, cfg.dim))
            scores, ids = torch.topk(q @ index.T, k, dim=-1)
        return scores, ids.to(torch.int32)

    return fn


def retrieve(model: TwoTower, index: torch.Tensor, dense, q_cat,
             k: int = 10):
    """Top-k retrieval, one shot: the query tower, one `(B, V)` product and
    `torch.topk`. Returns `(scores (B, k), item_ids (B, k) int32)`."""
    return make_retriever(model, k)(index, dense, q_cat)
