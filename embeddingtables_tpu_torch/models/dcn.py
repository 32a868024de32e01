"""DCN-v2, the Deep & Cross Network (counterpart of
`embeddingtables_tpu/models/dcn.py`).

Wang et al., "DCN V2: Improved Deep & Cross Network for Practical CTR
Prediction" (WWW 2021). The cross layers learn bounded-degree feature
crosses explicitly,

    x_{l+1} = x0 * (W_l x_l + b_l) + x_l,

with `W_l` full `(F, F)` or low-rank, applied as `(x @ V) @ U^T`. The input
`x0` is `[emb (B, T*D), dense]`, embeddings first. Structures: "stacked"
(the deep tower eats the cross output) and "parallel" (cross and deep side
by side, concatenated into the head).

The embedding path is the DLRM's: one `StackedTables`, one gather, and a
train step that differentiates the loss with respect to the looked-up
`(T, B, D)` activations and applies one lazy update to the stacked table in
place. The towers take a plain SGD step or one of `dense_tx`, and
`microbatch=k` takes the gradients over k slices of the batch, as in the
DLRM step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import resolve_device
from ..ops.ensemble import StackedTables
from ..optim import (SparseSGD, apply_dense_tx, check_dense_tx,
                     require_dense_state)
from ..utils.telemetry import phase
from .dlrm import (RowState, _init_mlp, _mlp, _pairs, _param_list,
                   _stacked_lookup, bce_loss, embedding_forward,
                   lazy_stack_update, microbatch_slices, stacked_flat_indices,
                   stacked_table_init, step_generator, with_dense_tx)
from .microbatch import microbatch_grads


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    vocab_sizes: Tuple[int, ...]
    num_dense: int = 13
    dim: int = 128                      # embedding feature size
    num_cross: int = 3                  # cross layers (degree num_cross+1)
    cross_rank: Optional[int] = 64      # None = full (F, F) weights
    deep_mlp: Tuple[int, ...] = (512, 256)
    structure: str = "stacked"          # "stacked" | "parallel"
    bag: Optional[int] = None
    combiner: str = "sum"
    pad_idx: Optional[int] = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # Storage dtype of the embedding tables only (None = param_dtype).
    table_dtype: Optional[torch.dtype] = None

    @property
    def tables_dtype(self):
        return self.table_dtype if self.table_dtype is not None \
            else self.param_dtype

    def __post_init__(self):
        if self.structure not in ("stacked", "parallel"):
            raise ValueError(self.structure)
        if self.combiner not in ("sum", "mean"):
            raise ValueError(self.combiner)
        if self.num_cross < 1:
            raise ValueError("num_cross must be >= 1")

    @property
    def num_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def input_features(self) -> int:
        """x0 width: all embeddings flattened + raw dense features."""
        return self.num_tables * self.dim + self.num_dense

    @property
    def head_features(self) -> int:
        if self.structure == "stacked":
            return self.deep_mlp[-1]
        return self.input_features + self.deep_mlp[-1]


def dcn_small_config(vocab: int = 100_000, **kw) -> DCNConfig:
    """Criteo-Kaggle-shaped small config (26 tables)."""
    kw.setdefault("vocab_sizes", tuple([vocab] * 26))
    return DCNConfig(**kw)


class DCN(nn.Module):
    """Cross layers (`(U, V, b)` low-rank or `(W, b)` full), the deep tower
    and the head as `(W, b)` pairs in the JAX layout `(fan_in, fan_out)`,
    the stacked ensemble, the sparse optimizer's row state (`emb_state`),
    held as buffers, and the towers' optimizer state (`dense_opt_state`, a
    `DenseOptState`, or None for plain SGD)."""

    emb_state = RowState("emb")

    def __init__(self, config: DCNConfig, cross, deep, head,
                 tables: StackedTables, emb_state=None, dense_opt_state=None):
        super().__init__()
        self.config = config
        self.cross_params = _param_list(cross)
        self.deep_params = _param_list(deep)
        self.head_params = _param_list([head])
        self.tables = tables
        self.emb_state = (SparseSGD().init(tables.data) if emb_state is None
                          else emb_state)
        self.dense_opt_state = dense_opt_state

    def tower_params(self) -> list:
        """`(name, parameter)` in JAX's order, `(cross, deep, head)`."""
        return list(self.named_parameters())

    @property
    def cross(self):
        p = list(self.cross_params)
        k = 2 if self.config.cross_rank is None else 3
        return [tuple(p[i:i + k]) for i in range(0, len(p), k)]

    @property
    def deep(self):
        return _pairs(self.deep_params)

    @property
    def head(self):
        return tuple(self.head_params)

    def forward(self, dense, cat):
        return dcn_forward(self, dense, cat)


def init_dense_params(cfg: DCNConfig, generator: torch.Generator, device):
    """(cross, deep, head): cross weights normal with std (1/F)^0.5 (V and
    full W) and (1/r)^0.5 (U), zero biases; Glorot-normal deep tower and
    head."""
    f, dt = cfg.input_features, cfg.param_dtype
    cross = []
    for _ in range(cfg.num_cross):
        b = torch.zeros((f,), dtype=dt, device=device)
        if cfg.cross_rank is None:
            w = torch.randn((f, f), generator=generator, device=device)
            cross.append(((w * (1.0 / f) ** 0.5).to(dt), b))
        else:
            r = cfg.cross_rank
            u = torch.randn((f, r), generator=generator, device=device)
            v = torch.randn((f, r), generator=generator, device=device)
            cross.append(((u * (1.0 / r) ** 0.5).to(dt),
                          (v * (1.0 / f) ** 0.5).to(dt), b))
    # Cross layers keep the width, so the deep tower eats input_features in
    # both structures.
    deep = _init_mlp((cfg.input_features,) + cfg.deep_mlp, dt, generator,
                     device)
    head = _init_mlp((cfg.head_features, 1), dt, generator, device)[0]
    return cross, deep, head


def init_dcn(cfg: DCNConfig, generator: torch.Generator | None = None,
             device=None, sparse_opt=None, dense_tx=None) -> DCN:
    """Random DCN on `device` (CUDA unless given) with `sparse_opt`'s
    initial row state (default `SparseSGD`) and `dense_tx`'s initial tower
    state (`init_dlrm`). `generator` must live on that device; by default
    one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cross, deep, head = init_dense_params(cfg, generator, device)
    tables = stacked_table_init(cfg.vocab_sizes, cfg.dim, cfg.tables_dtype,
                                generator, device)
    state = (sparse_opt or SparseSGD()).init(tables.data)
    return with_dense_tx(DCN(cfg, cross, deep, head, tables, state),
                         dense_tx)


def cross_layers(cross, x0: torch.Tensor, compute_dtype) -> torch.Tensor:
    """L applications of `x <- x0 * (W x + b) + x` (low-rank W = U V^T,
    applied as `(x @ V) @ U^T`)."""
    x0 = x0.to(compute_dtype)
    x = x0
    for layer in cross:
        if len(layer) == 2:
            w, b = layer
            xw = x @ w.to(compute_dtype)
        else:
            u, v, b = layer
            xw = (x @ v.to(compute_dtype)) @ u.to(compute_dtype).T
        x = x0 * (xw + b.to(compute_dtype)) + x
    return x


def forward_from_embeddings(cross, deep, head, cfg: DCNConfig,
                            dense: torch.Tensor,
                            emb_t: torch.Tensor) -> torch.Tensor:
    """Forward given looked-up embeddings `(T, B, dim)`; float32 logits
    `(B,)`."""
    cd = cfg.compute_dtype
    b = emb_t.shape[1]
    emb = emb_t.permute(1, 0, 2).reshape(b, -1)            # (B, T*dim)
    x0 = torch.cat([emb.to(cd), dense.to(cd)], dim=-1)
    xc = cross_layers(cross, x0, cd)
    if cfg.structure == "stacked":
        feat = _mlp(deep, xc, cd)
    else:
        feat = torch.cat([xc, _mlp(deep, x0, cd)], dim=-1)
    w, bh = head
    logits = feat @ w.to(cd) + bh.to(cd)
    return logits[:, 0].float()


def dcn_forward(model: DCN, dense, cat) -> torch.Tensor:
    """Logits `(B,)` for dense `(B, num_dense)` and cat `(T, B[, bag])`
    (tensors or arrays; moved to the model's device)."""
    dense = torch.as_tensor(dense).to(model.tables.data.device)
    emb_t = embedding_forward(model.tables, cat, model.config.combiner,
                              model.config.pad_idx)
    return forward_from_embeddings(model.cross, model.deep, model.head,
                                   model.config, dense, emb_t)


def make_eval_step(cfg: DCNConfig):
    """`step(model, dense, cat) -> logits`, under `torch.inference_mode`."""
    del cfg  # the model carries its config; kept for the JAX signature

    def step(model: DCN, dense, cat):
        with torch.inference_mode():
            return dcn_forward(model, dense, cat)
    return step


def make_train_step(cfg: DCNConfig, sparse_opt=None, dense_lr: float = 0.01,
                    dense_tx=None, microbatch: Optional[int] = None):
    """The single-device train step,
    `step(model, dense, cat, label, lr=None, generator=None) -> loss`, the
    DLRM step's discipline (`models/dlrm.py::make_train_step`): one lazy
    update of the stacked table and its row state in place, then plain SGD
    on the cross layers, deep tower and head, or one step of `dense_tx`
    (`init_dcn(dense_tx=)` holds its state); `microbatch=k` takes the
    gradients over k slices of the batch before that one update. It opens
    the DLRM step's telemetry phases ("step.lookup", "step.forward", ...)."""
    check_dense_tx(dense_tx)
    sparse_opt = sparse_opt or SparseSGD()
    k = microbatch_slices(microbatch)

    def grads(model, params, dense, cat, label):
        tables = model.tables
        with phase("step.lookup"):
            flat, valid = stacked_flat_indices(tables, cat, cfg.pad_idx)
            with torch.no_grad():
                emb_t = _stacked_lookup(tables, flat, valid, cfg.combiner,
                                        cat.shape[1])
        with torch.enable_grad():
            emb_t.requires_grad_(True)
            with phase("step.forward"):
                loss = bce_loss(forward_from_embeddings(
                    model.cross, model.deep, model.head, cfg, dense, emb_t),
                    label)
            with phase("step.backward"):
                *dense_grads, delta_t = torch.autograd.grad(loss,
                                                            params + [emb_t])
        return loss.detach(), dense_grads, (delta_t,), (flat, valid)

    def step(model: DCN, dense, cat, label, lr=None, generator=None):
        kw = step_generator(sparse_opt, generator, "train_dcn")
        require_dense_state(model, dense_tx, "init_dcn")
        tables = model.tables
        device = tables.data.device
        dense = torch.as_tensor(dense).to(device)
        cat = torch.as_tensor(cat).to(device)
        label = torch.as_tensor(label).to(device)
        params = [p for _, p in model.tower_params()]  # the tables are buffers
        if k > 1:
            loss, dense_grads, (delta_t,) = microbatch_grads(
                params, dense, cat, label, k,
                lambda *s: grads(model, params, *s)[:3])
            flat, valid = stacked_flat_indices(tables, cat, cfg.pad_idx)
        else:
            loss, dense_grads, (delta_t,), (flat, valid) = grads(
                model, params, dense, cat, label)
        with phase("step.sparse_update"):
            upd = lazy_stack_update(flat, valid, delta_t, cfg.dim,
                                    cfg.combiner)
            tables.data, model.emb_state = sparse_opt.apply(
                tables.data, upd, model.emb_state, lr=lr, **kw)
        with phase("step.dense_update"):
            apply_dense_tx(params, dense_grads, dense_tx,
                           model.dense_opt_state, dense_lr)
        return loss

    return step
