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

MLPerf's DLRM-DCNv2 adds two things (`bag_sizes`, `dense_mlp`): multi-hot
features whose bag width is fixed per table (a batch's `cat` is then one
`(S, B)` array, S the sum of the widths, table t's bag in its `bag_sizes[t]`
consecutive slot rows, summed by one ragged gather), and a dense arch, a
ReLU MLP from the dense features to `dim`, whose output takes the raw
features' place in x0, `[emb (B, T*D), dense_mlp(dense) (B, D)]`.

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
from ..utils.telemetry import get_telemetry, phase
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
    # Multi-hot bags of one fixed width a table (sum; no bag, pad_idx).
    bag_sizes: Optional[Tuple[int, ...]] = None
    # The dense arch's widths, the last = dim (None: raw dense in x0).
    dense_mlp: Optional[Tuple[int, ...]] = None

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
        if self.bag_sizes is not None:
            if (len(self.bag_sizes) != self.num_tables
                    or min(self.bag_sizes) < 1):
                raise ValueError("bag_sizes needs one width >= 1 a table, got "
                                 f"{self.bag_sizes}")
            if (self.bag is not None or self.pad_idx is not None
                    or self.combiner != "sum"):
                raise ValueError("bag_sizes takes summed bags without bag "
                                 "or pad_idx")
        if self.dense_mlp is not None and (not self.dense_mlp or
                                           self.dense_mlp[-1] != self.dim):
            raise ValueError(f"dense_mlp must end in dim={self.dim}, got "
                             f"{self.dense_mlp}")

    @property
    def num_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def input_features(self) -> int:
        """x0 width: all embeddings flattened + the raw dense features, or
        the dense arch's `dim` outputs."""
        if self.dense_mlp is not None:
            return (self.num_tables + 1) * self.dim
        return self.num_tables * self.dim + self.num_dense

    @property
    def head_features(self) -> int:
        if self.structure == "stacked":
            return self.deep_mlp[-1]
        return self.input_features + self.deep_mlp[-1]


def single_device_only(cfg: DCNConfig, what: str) -> None:
    """Refuse `bag_sizes` and `dense_mlp` on a path that has neither (the
    sharded, planned and quantized DCN)."""
    if cfg.bag_sizes is not None or cfg.dense_mlp is not None:
        raise NotImplementedError(f"{what}: bag_sizes and dense_mlp run on "
                                  "the single-device DCN only")


def dcn_small_config(vocab: int = 100_000, **kw) -> DCNConfig:
    """Criteo-Kaggle-shaped small config (26 tables)."""
    kw.setdefault("vocab_sizes", tuple([vocab] * 26))
    return DCNConfig(**kw)


class DCN(nn.Module):
    """Cross layers (`(U, V, b)` low-rank or `(W, b)` full), the deep tower
    and the head as `(W, b)` pairs in the JAX layout `(fan_in, fan_out)`,
    the stacked ensemble, the sparse optimizer's row state (`emb_state`),
    held as buffers, and the towers' optimizer state (`dense_opt_state`, a
    `DenseOptState`, or None for plain SGD). With `config.dense_mlp`, the
    dense arch's `(W, b)` pairs (`dense_arch`), after the head."""

    emb_state = RowState("emb")

    def __init__(self, config: DCNConfig, cross, deep, head,
                 tables: StackedTables, emb_state=None, dense_opt_state=None,
                 dense_arch=()):
        super().__init__()
        if len(dense_arch) != len(config.dense_mlp or ()):
            raise ValueError(f"{len(dense_arch)} dense arch layers for "
                             f"dense_mlp={config.dense_mlp}")
        self.config = config
        self.cross_params = _param_list(cross)
        self.deep_params = _param_list(deep)
        self.head_params = _param_list([head])
        self.dense_params = _param_list(dense_arch)
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

    @property
    def dense_arch(self):
        return _pairs(self.dense_params)

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
    state (`init_dlrm`); the dense arch, if any, Glorot-normal like the
    DLRM's bottom MLP, drawn after the tables. `generator` must live on
    that device; by default one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cross, deep, head = init_dense_params(cfg, generator, device)
    tables = stacked_table_init(cfg.vocab_sizes, cfg.dim, cfg.tables_dtype,
                                generator, device)
    dense_arch = () if cfg.dense_mlp is None else _init_mlp(
        (cfg.num_dense,) + tuple(cfg.dense_mlp), cfg.param_dtype, generator,
        device)
    state = (sparse_opt or SparseSGD()).init(tables.data)
    return with_dense_tx(DCN(cfg, cross, deep, head, tables, state,
                             dense_arch=dense_arch), dense_tx)


def grid_width(f: int, dtype: torch.dtype) -> int:
    """`f` rounded up to a whole number of 16-byte units of `dtype`: the
    width at which every row of a `(B, f)` activation starts on the 16-byte
    grid, which cuBLAS's Hopper GEMM kernels need (off it, only its
    alignment-1 kernels run)."""
    unit = max(1, 16 // dtype.itemsize)
    return -(-f // unit) * unit


def _padded(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    """`t` cast to `dtype` at the top-left of a zeroed `shape` buffer, in
    one copy (differentiable: the gradient is the buffer's, sliced back);
    `t.to(dtype)` where the shapes agree."""
    if tuple(t.shape) == tuple(shape):
        return t.to(dtype)
    out = t.new_zeros(shape, dtype=dtype)
    out[tuple(slice(0, n) for n in t.shape)].copy_(t)
    return out


def cross_layers(cross, x0: torch.Tensor, compute_dtype) -> torch.Tensor:
    """L applications of `x <- x0 * (W x + b) + x` (low-rank W = U V^T,
    applied as `(x @ V) @ U^T`). `x0` may be wider than the weights' F
    rows, with zero columns past F: the weights are then zero-padded to its
    width, the padded columns stay 0 through every layer (`0 * (...) + 0`)
    and the first F columns are the unpadded network's."""
    x0 = x0.to(compute_dtype)
    fp = x0.shape[-1]
    x = x0
    for layer in cross:
        if len(layer) == 2:
            w, b = layer
            xw = x @ _padded(w, (fp, fp), compute_dtype)
        else:
            u, v, b = layer
            r = v.shape[1]
            xw = (x @ _padded(v, (fp, r), compute_dtype)) @ \
                _padded(u, (fp, r), compute_dtype).T
        x = x0 * (xw + _padded(b, (fp,), compute_dtype)) + x
    return x


def forward_from_embeddings(cross, deep, head, cfg: DCNConfig,
                            dense: torch.Tensor, emb_t: torch.Tensor,
                            dense_arch=()) -> torch.Tensor:
    """Forward given looked-up embeddings `(T, B, dim)`; float32 logits
    `(B,)`. With `cfg.dense_mlp`, `dense_arch` holds its layers (ReLU on
    each), whose `(B, dim)` output follows the embeddings in x0.

    The cross network and the deep tower's first layer run at
    `grid_width(F, compute_dtype)` columns, x0 and their weights
    zero-padded (exact: see `cross_layers`), so that every GEMM of width F
    has its leading dimensions on the 16-byte grid; the counter
    `dcn.x0_pad_cols` adds the padded columns of x0 in each forward. The
    parameters keep their logical shapes."""
    cd = cfg.compute_dtype
    b = emb_t.shape[1]
    f = cfg.input_features
    fp = grid_width(f, cd)
    emb = emb_t.permute(1, 0, 2).reshape(b, -1)            # (B, T*dim)
    if cfg.dense_mlp is not None:
        if len(dense_arch) != len(cfg.dense_mlp):
            raise ValueError("cfg.dense_mlp is set: pass the dense arch's "
                             "layers as dense_arch")
        dense = _mlp(dense_arch, dense, cd)                 # (B, dim)
    zeros = []
    if fp > f:
        zeros = [emb.new_zeros((b, fp - f), dtype=cd)]
        (w0, b0), *rest = deep
        deep = [(_padded(w0, (fp, w0.shape[1]), cd), b0)] + rest
        get_telemetry().count("dcn.x0_pad_cols", fp - f)
    # No name holds the casts: each is freed once x0 is built.
    x0 = torch.cat([emb.to(cd), dense.to(cd)] + zeros, dim=-1)
    xc = cross_layers(cross, x0, cd)
    if cfg.structure == "stacked":
        feat = _mlp(deep, xc, cd)
    else:
        feat = torch.cat([xc[:, :f], _mlp(deep, x0, cd)], dim=-1)
    w, bh = head
    logits = feat @ w.to(cd) + bh.to(cd)
    return logits[:, 0].float()


def dcn_forward(model: DCN, dense, cat) -> torch.Tensor:
    """Logits `(B,)` for dense `(B, num_dense)` and cat `(T, B[, bag])`, or
    `(S, B)` with `bag_sizes` (tensors or arrays; moved to the model's
    device)."""
    cfg = model.config
    dense = torch.as_tensor(dense).to(model.tables.data.device)
    emb_t = embedding_forward(model.tables, cat, cfg.combiner, cfg.pad_idx,
                              cfg.bag_sizes)
    return forward_from_embeddings(model.cross, model.deep, model.head,
                                   cfg, dense, emb_t, model.dense_arch)


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
            flat, valid = stacked_flat_indices(tables, cat, cfg.pad_idx,
                                               cfg.bag_sizes)
            with torch.no_grad():
                emb_t = _stacked_lookup(tables, flat, valid, cfg.combiner,
                                        cat.shape[1], cfg.bag_sizes)
        with torch.enable_grad():
            emb_t.requires_grad_(True)
            with phase("step.forward"):
                loss = bce_loss(forward_from_embeddings(
                    model.cross, model.deep, model.head, cfg, dense, emb_t,
                    model.dense_arch), label)
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
            flat, valid = stacked_flat_indices(tables, cat, cfg.pad_idx,
                                               cfg.bag_sizes)
        else:
            loss, dense_grads, (delta_t,), (flat, valid) = grads(
                model, params, dense, cat, label)
        with phase("step.sparse_update"):
            bags = None if cfg.bag_sizes is None \
                else tables.bag_layout(cfg.bag_sizes).bags(cat.shape[1])
            upd = lazy_stack_update(flat, valid, delta_t, cfg.dim,
                                    cfg.combiner, bags)
            tables.data, model.emb_state = sparse_opt.apply(
                tables.data, upd, model.emb_state, lr=lr, **kw)
        with phase("step.dense_update"):
            apply_dense_tx(params, dense_grads, dense_tx,
                           model.dense_opt_state, dense_lr)
        return loss

    return step
