"""DLRM forward (counterpart of `embeddingtables_tpu/models/dlrm.py`).

  - The embedding ensemble is a `StackedTables`: all tables in ONE
    `(sum V, D)` tensor, so the ensemble lookup is ONE gather.
  - The dense towers run in `compute_dtype` (bfloat16 by default); weights
    keep the JAX layout `(fan_in, fan_out)`, applied as `x @ W + b`.
  - The dot interaction is assembled from Gram blocks on the table-major
    `(T, B, D)` embeddings (`_block_interaction`); the top MLP's first-layer
    ROWS are permuted to compensate for the block feature order
    (`_block_w1_perm`), which is exact. Past `_SEL_MAX_ENTRIES` the
    canonical `[bottom; emb]` Gram with triangle indexing takes over.
  - Training (`make_train_step`) differentiates the loss with respect to the
    looked-up `(T, B, D)` activations, never the tables: the block
    interaction is a `torch.autograd.Function` whose backward is the JAX
    package's symmetrized-selection VJP, the towers take a plain SGD step
    or one of a `torch.optim` optimizer (`dense_tx`, its state held by the
    model as `dense_opt_state`), and the embedding gradient becomes one lazy
    `SparseEmbeddingUpdate` on the stacked table, applied in place by the
    sparse optimizer. `microbatch=k` takes the gradients over k slices of
    the batch (`models/microbatch.py`) before that one update.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..ops.ensemble import StackedTables
from ..ops.lookup import lookup, lookup_ragged
from ..ops.sparse_update import SparseEmbeddingUpdate
from ..optim import (DenseOptState, SparseAdamState, SparseFTRLState,
                     SparseOptState, SparseSGD, apply_dense_tx,
                     check_dense_tx, require_dense_state)
from ..tables import SimpleEmbedding
from ..utils.telemetry import get_telemetry, phase
from .microbatch import microbatch_grads


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    vocab_sizes: Tuple[int, ...]
    num_dense: int = 13
    dim: int = 128                                   # embedding feature size
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)    # last entry must == dim
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    interaction: str = "dot"                         # "dot" | "cat"
    self_interaction: bool = False                   # include diagonal of Z Z^T
    bag: Optional[int] = None                        # multi-hot bag size (None = one-hot)
    combiner: str = "sum"                            # bag reduction: "sum" | "mean"
    # Padding sentinel for variable-length bags (fixed-width bags
    # right-padded with this id): pads contribute zero rows and are excluded
    # from mean denominators.
    pad_idx: Optional[int] = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16      # dtype of the dense towers
    # Storage dtype of the embedding tables only (None = param_dtype).
    table_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.dim:
            raise ValueError(
                f"bottom_mlp must end at dim={self.dim}, got {self.bottom_mlp}")
        if self.interaction not in ("dot", "cat"):
            raise ValueError(self.interaction)
        if self.combiner not in ("sum", "mean"):
            raise ValueError(self.combiner)

    @property
    def num_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def tables_dtype(self):
        """Embedding-table storage dtype (table_dtype or param_dtype)."""
        return self.table_dtype if self.table_dtype is not None \
            else self.param_dtype

    @property
    def interaction_features(self) -> int:
        t1 = self.num_tables + 1
        if self.interaction == "cat":
            return self.dim * t1
        pairs = t1 * (t1 - 1) // 2 + (t1 if self.self_interaction else 0)
        return self.dim + pairs


def dlrm_small_config(vocab: int = 100_000, **kw) -> DLRMConfig:
    """Criteo-Kaggle-shaped small config (26 tables)."""
    kw.setdefault("vocab_sizes", tuple([vocab] * 26))
    return DLRMConfig(**kw)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _pairs(params: nn.ParameterList):
    p = list(params)
    return [(p[i], p[i + 1]) for i in range(0, len(p), 2)]


def _param_list(layers) -> nn.ParameterList:
    """`[(W, b), ...]` (or any tuples of tensors) -> one flat ParameterList."""
    return nn.ParameterList([nn.Parameter(t) for layer in layers
                             for t in layer])


# The sparse optimizers' state types; a model holds each of its states as
# buffers named `<prefix>_<field>` (`RowState`).
_STATE_TYPES = (SparseOptState, SparseAdamState, SparseFTRLState)


class RowState:
    """A sparse optimizer's row state, held by an `nn.Module` as one buffer
    per field, `<prefix>_<field>` (SGD and AdaGrad: `<prefix>_accum`). The
    first assignment picks the state type; later ones must keep it. An
    optional state (DeepFM's `fm_state`) may be None, and stays None."""

    def __init__(self, prefix: str, optional: bool = False):
        self.prefix, self.optional = prefix, optional

    def __set_name__(self, owner, name):
        self.name = name

    def _type(self, obj):
        return obj.__dict__.get("_state_types", {}).get(self.prefix)

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        cls = self._type(obj)
        if cls is None:
            return None
        return cls(*[getattr(obj, f"{self.prefix}_{f}") for f in cls._fields])

    def __set__(self, obj, state) -> None:
        types = obj.__dict__.setdefault("_state_types", {})
        if self.prefix in types:
            held = types[self.prefix]
            if (held is None) != (state is None) or (
                    state is not None and type(state) is not held):
                raise TypeError(f"the model holds a "
                                f"{getattr(held, '__name__', 'None')} as "
                                f"{self.name}, got a {type(state).__name__}")
            if state is not None:
                for name, value in zip(state._fields, state):
                    setattr(obj, f"{self.prefix}_{name}", value)
            return
        if state is None and self.optional:
            types[self.prefix] = None
            return
        if type(state) not in _STATE_TYPES:
            raise TypeError(f"{self.name} must be one of "
                            f"{[c.__name__ for c in _STATE_TYPES]}, got "
                            f"{type(state).__name__}")
        types[self.prefix] = type(state)
        for name, value in zip(state._fields, state):
            obj.register_buffer(f"{self.prefix}_{name}", value)


class DLRM(nn.Module):
    """Dense towers as `(W, b)` pairs in the JAX layout `(fan_in, fan_out)`,
    the stacked embedding ensemble, and the sparse optimizer's row state
    (`emb_state`: a `SparseOptState`, with a zero-size accumulator for SGD,
    a `SparseAdamState` or a `SparseFTRLState`), held as buffers; and the
    towers' optimizer state (`dense_opt_state`: a `DenseOptState`
    submodule, or None for plain SGD)."""

    emb_state = RowState("emb")

    def __init__(self, config: DLRMConfig, bottom, top, tables: StackedTables,
                 emb_state=None, dense_opt_state=None):
        super().__init__()
        self.config = config
        self.bottom_params = _param_list(bottom)
        self.top_params = _param_list(top)
        self.tables = tables
        self.emb_state = (SparseSGD().init(tables.data) if emb_state is None
                          else emb_state)
        self.dense_opt_state = dense_opt_state

    def tower_params(self) -> list:
        """`(name, parameter)` of the towers in JAX's order,
        `(bottom, top)`: what the train step passes to `dense_tx`."""
        return list(self.named_parameters())

    @property
    def bottom(self):
        return _pairs(self.bottom_params)

    @property
    def top(self):
        return _pairs(self.top_params)

    def forward(self, dense, cat):
        return dlrm_forward(self, dense, cat)


def _init_mlp(sizes, dtype, generator, device):
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        std = (2.0 / (fan_in + fan_out)) ** 0.5
        w = torch.randn((fan_in, fan_out), generator=generator, device=device)
        layers.append(((w * std).to(dtype),
                       torch.zeros((fan_out,), dtype=dtype, device=device)))
    return layers


def uniform_rows(rows: int, dim: int, dtype, generator, device
                 ) -> torch.Tensor:
    """A `(rows, dim)` table uniform in [-1, 1) / sqrt(dim), drawn in f32
    and stored as `dtype`."""
    data = torch.empty((rows, dim), dtype=torch.float32, device=device)
    data.uniform_(-1.0, 1.0, generator=generator)
    data /= float(dim) ** 0.5
    return data.to(dtype)


def stacked_table_init(vocab_sizes, dim: int, dtype, generator, device
                       ) -> StackedTables:
    """The stacked ensemble of `vocab_sizes` rows (`uniform_rows`)."""
    offs = np.concatenate([[0], np.cumsum(vocab_sizes)]).tolist()
    return StackedTables(uniform_rows(offs[-1], dim, dtype, generator,
                                      device), offs, dim)


def with_dense_tx(model, dense_tx):
    """`model` holding `dense_tx`'s initial tower state (None: none)."""
    if dense_tx is not None:
        model.dense_opt_state = DenseOptState.create(model.tower_params(),
                                                     dense_tx)
    return model


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator | None = None,
              device=None, sparse_opt=None, dense_tx=None) -> DLRM:
    """Random DLRM on `device` (CUDA unless given): Glorot-normal towers,
    zero biases, tables uniform in [-1, 1) / sqrt(dim), `sparse_opt`'s
    initial row state (default `SparseSGD`) and, with `dense_tx` (a
    factory from the tower parameters to a `torch.optim.Optimizer`), its
    initial tower state as `dense_opt_state`. `generator` must live on that
    device; by default one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    bottom = _init_mlp((cfg.num_dense,) + cfg.bottom_mlp, cfg.param_dtype,
                       generator, device)
    top = _init_mlp((cfg.interaction_features,) + cfg.top_mlp,
                    cfg.param_dtype, generator, device)
    tables = stacked_table_init(cfg.vocab_sizes, cfg.dim, cfg.tables_dtype,
                                generator, device)
    state = (sparse_opt or SparseSGD()).init(tables.data)
    return with_dense_tx(DLRM(cfg, bottom, top, tables, state), dense_tx)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mlp(layers, x, compute_dtype, final_activation=True):
    x = x.to(compute_dtype)
    for i, (w, b) in enumerate(layers):
        x = x @ w.to(compute_dtype) + b.to(compute_dtype)
        if i < len(layers) - 1 or final_activation:
            x = torch.relu(x)
    return x


# The triangle is extracted with a constant 0/1 selection-matrix product,
# which is exact (one nonzero per column). The (t1^2, pairs) constant grows
# ~t1^4/2, so past this many entries the canonical Gram plus index gather
# takes over (the same threshold as the JAX package, so both packages take
# the same branch for the same config).
_SEL_MAX_ENTRIES = 8 << 20


@functools.lru_cache(maxsize=8)
def _tril_selection_np(t1: int, offset: int):
    li, lj = np.tril_indices(t1, k=offset)
    sel = np.zeros((t1 * t1, li.size), np.float32)
    sel[li * t1 + lj, np.arange(li.size)] = 1.0
    return sel


# The cached device constants are built outside inference mode, so one first
# made by the serving path stays usable by a forward that autograd tracks.

@functools.lru_cache(maxsize=16)
def _selection(t1: int, offset: int, dtype: torch.dtype, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(_tril_selection_np(t1, offset)).to(device,
                                                                   dtype)


def _tri_interaction(z: torch.Tensor, offset: int) -> torch.Tensor:
    """Gram + triangle selection on `z` (B, t1, D): `(z z^T).reshape @ SEL`."""
    b, t1, _ = z.shape
    zzt = torch.einsum("bij,bkj->bik", z, z)
    return zzt.reshape(b, t1 * t1) @ _selection(t1, offset, z.dtype, z.device)


@functools.lru_cache(maxsize=16)
def _symmetric_selection_t(t: int, offset: int, dtype: torch.dtype,
                           device: torch.device):
    """`(SEL + SEL_swap)^T`, `(pairs, t*t)`: the block backward's selection.
    SEL has one 1 per column at flat index i*t + j; the swap moves it to
    j*t + i (a diagonal pair under self-interaction gets 2)."""
    li, lj = np.tril_indices(t, k=offset)
    ss = _tril_selection_np(t, offset).copy()
    ss[lj * t + li, np.arange(li.size)] += 1.0
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(ss.T)).to(device, dtype)


def _block_interaction_fwd(bot: torch.Tensor, emb_t: torch.Tensor,
                           offset: int) -> torch.Tensor:
    t, b = emb_t.shape[0], bot.shape[0]
    gee = torch.einsum("ibd,jbd->bij", emb_t, emb_t)
    flat_ee = gee.reshape(b, t * t) @ _selection(t, offset, bot.dtype,
                                                 bot.device)
    gbe = torch.einsum("bd,jbd->bj", bot, emb_t)
    parts = [gbe, flat_ee]
    if offset == 0:
        parts.insert(0, torch.sum(bot * bot, dim=-1, keepdim=True))
    return torch.cat(parts, dim=-1)


class _BlockInteraction(torch.autograd.Function):
    """The block interaction with the JAX package's hand-written VJP
    (`_block_interaction_fn`): the Gram's adjoint symmetrizes, so the
    selection's cotangent is one `(B, pairs) @ (pairs, T*T)` product with
    `SEL + SEL_swap` and one batched product, in the `(T, B, D)` layout and
    in the operands' dtype at every step, so bf16 rounds where JAX's does."""

    @staticmethod
    def forward(ctx, bot, emb_t, offset):
        ctx.save_for_backward(bot, emb_t)
        ctx.offset = offset
        return _block_interaction_fwd(bot, emb_t, offset)

    @staticmethod
    def backward(ctx, dflat):
        bot, emb_t = ctx.saved_tensors
        t, b = emb_t.shape[0], bot.shape[0]
        nbb = 1 if ctx.offset == 0 else 0
        dgbe = dflat[:, nbb:nbb + t]
        ss_t = _symmetric_selection_t(t, ctx.offset, dflat.dtype,
                                      dflat.device)
        m = (dflat[:, nbb + t:] @ ss_t).reshape(b, t, t)
        demb = (torch.einsum("bij,jbd->ibd", m, emb_t)
                + torch.einsum("bj,bd->jbd", dgbe, bot))
        dbot = torch.einsum("bj,jbd->bd", dgbe, emb_t)
        if nbb:
            dbot = dbot + 2.0 * dflat[:, :1] * bot
        return dbot, demb, None


def _block_interaction(bot: torch.Tensor, emb_t: torch.Tensor,
                       offset: int) -> torch.Tensor:
    """Block-Gram interaction on table-major embeddings `emb_t` (T, B, D):
    `[bb? | be | ee-tril]` in block order, where `G_ee` is the (T, T) Gram of
    the embedding rows, `G_be` their dots with the bottom output and `G_bb`
    (self-interaction only) the bottom output's own square norm. Under
    autograd the backward is `_BlockInteraction`'s."""
    if torch.is_grad_enabled() and (bot.requires_grad or emb_t.requires_grad):
        return _BlockInteraction.apply(bot, emb_t, offset)
    return _block_interaction_fwd(bot, emb_t, offset)


@functools.lru_cache(maxsize=8)
def _block_w1_perm(t: int, offset: int, dim: int):
    """Inverse row-permutation for the top MLP's first matmul so
    `[bot | flat_block] @ W1[perm]` equals the canonical
    `[bot | flat_canonical] @ W1`: canonical feature k sits at block
    position P[k], so W1_eff[j] = W1[P^-1(j)]."""
    t1 = t + 1
    li, lj = np.tril_indices(t1, k=offset)
    li_e, lj_e = np.tril_indices(t, k=offset)
    ee_pos = {(a, b): k for k, (a, b) in enumerate(zip(li_e, lj_e))}
    nbb = 1 if offset == 0 else 0
    p = np.empty(li.size, np.int64)
    for k, (a, b) in enumerate(zip(li, lj)):
        if b == 0:
            p[k] = (0 if a == 0 else nbb + (a - 1)) if offset == 0 \
                else (a - 1)
        else:
            p[k] = nbb + t + ee_pos[(a - 1, b - 1)]
    return np.argsort(np.concatenate([np.arange(dim), dim + p]))


@functools.lru_cache(maxsize=16)
def _block_w1_perm_tensor(t: int, offset: int, dim: int, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(_block_w1_perm(t, offset, dim)).to(device)


def dot_interaction(bottom_out: torch.Tensor, emb: torch.Tensor,
                    self_interaction: bool) -> torch.Tensor:
    """Pairwise interactions of Z = [bottom; emb] (B, T+1, D): the (strict)
    lower triangle of Z Z^T, concatenated after the bottom output."""
    z = torch.cat([bottom_out[:, None, :], emb], dim=1)
    t1 = z.shape[1]
    offset = 0 if self_interaction else -1
    npairs = t1 * (t1 + 1) // 2 if self_interaction else t1 * (t1 - 1) // 2
    if t1 * t1 * npairs <= _SEL_MAX_ENTRIES:
        flat = _tri_interaction(z, offset)
    else:
        zzt = torch.einsum("bij,bkj->bik", z, z)
        li, lj = np.tril_indices(t1, k=offset)
        flat = zzt[:, torch.from_numpy(li).to(z.device),
                   torch.from_numpy(lj).to(z.device)]
    return torch.cat([bottom_out, flat], dim=-1)


def stacked_flat_indices(tables: StackedTables, cat: torch.Tensor,
                         pad_idx: Optional[int] = None, bag_sizes=None):
    """(T, B[, bag]) local ids -> (flat global int32 ids, valid mask or None).
    With `bag_sizes`, a multi-hot `(S, B)` batch (`StackedTables.
    shift_indices`) -> its `(S * B,)` global ids, slot-major, and None.

    Pad detection must precede the stacked-offset shift (a shifted pad no
    longer matches the sentinel), so pads are remapped to local row 0 here
    and reported through the mask."""
    cat = torch.as_tensor(cat).to(tables.data.device)
    if bag_sizes is not None:
        if pad_idx is not None:
            raise ValueError("per-table bag widths take no pad_idx")
        return tables.shift_indices(cat, bag_sizes).reshape(-1), None
    if pad_idx is None:
        g = tables.shift_indices(cat)
        return g.reshape(-1, *g.shape[2:]), None
    valid = cat != pad_idx
    g = tables.shift_indices(torch.where(valid, cat, 0))
    flat = g.reshape(-1, *g.shape[2:])
    return flat, valid.reshape(flat.shape)


def stacked_update_weights(valid, combiner: str, shape):
    """Per-occurrence update weights matching `embedding_forward`'s output
    scale on the flat stacked stream: None for a plain sum, 1/bag for a
    padless mean, and the (mean-normalized) validity mask with pads."""
    if valid is None:
        if combiner == "mean" and len(shape) == 2:
            return torch.full(tuple(shape), 1.0 / shape[1],
                              dtype=torch.float32)
        return None
    w = valid.float()
    if combiner == "mean" and valid.dim() == 2:
        w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    return w


def _stacked_lookup(tables: StackedTables, flat, valid, combiner: str,
                    batch: int, bag_sizes=None) -> torch.Tensor:
    """The `(T, B, dim)` lookup of the flat ids (`stacked_flat_indices`),
    one launch. Counts the id slots it gathers, pads included, in the
    telemetry counter `lookup.ids` and the sums or rows it writes in
    `lookup.bags` (from shapes: no sync)."""
    tel = get_telemetry()
    tel.count("lookup.ids", flat.numel())
    tel.count("lookup.bags", tables.ntables * batch)
    if bag_sizes is not None:
        return lookup_ragged(tables.data, flat.view(-1, batch),
                             tables.bag_layout(bag_sizes))
    w = None if valid is None else valid.float()
    out = lookup(SimpleEmbedding(tables.data), flat, combiner=combiner,
                 weights=w)
    return out.reshape(tables.ntables, batch, tables.dim)


def embedding_forward(tables: StackedTables, cat: torch.Tensor,
                      combiner: str = "sum", pad_idx: Optional[int] = None,
                      bag_sizes=None) -> torch.Tensor:
    """Ensemble lookup as ONE gather on the stacked tensor.

    cat: (T, B) or (T, B, bag) per-table local ids, or with `bag_sizes`
    (S, B) multi-hot ids -> (T, B, dim)."""
    flat, valid = stacked_flat_indices(tables, cat, pad_idx, bag_sizes)
    return _stacked_lookup(tables, flat, valid, combiner, cat.shape[1],
                           bag_sizes)


def forward_from_embeddings(bottom, top, cfg: DLRMConfig, dense: torch.Tensor,
                            emb_t: torch.Tensor) -> torch.Tensor:
    """Dense towers given already looked-up embeddings `(T, B, dim)`; returns
    float32 logits `(B,)`."""
    cd = cfg.compute_dtype
    bot = _mlp(bottom, dense, cd)                        # (B, dim)
    if cfg.interaction == "dot":
        t = emb_t.shape[0]
        t1 = t + 1
        offset = 0 if cfg.self_interaction else -1
        npairs = t1 * (t1 + 1) // 2 if cfg.self_interaction \
            else t1 * (t1 - 1) // 2
        if t1 * t1 * npairs <= _SEL_MAX_ENTRIES:
            flat = _block_interaction(bot, emb_t.to(cd), offset)
            feat = torch.cat([bot, flat], dim=-1)
            w1, b1 = top[0]
            perm = _block_w1_perm_tensor(t, offset, bot.shape[1], w1.device)
            top = [(w1.index_select(0, perm), b1)] + list(top[1:])
        else:
            emb = emb_t.permute(1, 0, 2).to(cd)
            feat = dot_interaction(bot, emb, cfg.self_interaction)
    else:
        # "cat": the bottom output followed by every table's embedding.
        emb = emb_t.permute(1, 0, 2).to(cd)               # (B, T, dim)
        feat = torch.cat([bot, emb.reshape(emb.shape[0], -1)], dim=-1)
    logits = _mlp(top, feat, cd, final_activation=False)  # (B, 1)
    return logits[:, 0].float()


def dlrm_forward(model: DLRM, dense, cat) -> torch.Tensor:
    """Logits `(B,)` for dense `(B, num_dense)` and cat `(T, B[, bag])`
    (tensors or arrays; moved to the model's device)."""
    device = model.tables.data.device
    dense = torch.as_tensor(dense).to(device)
    emb_t = embedding_forward(model.tables, cat, model.config.combiner,
                              model.config.pad_idx)
    return forward_from_embeddings(model.bottom, model.top, model.config,
                                   dense, emb_t)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy, mean over batch."""
    z, y = logits, labels.float()
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def make_eval_step(cfg: DLRMConfig):
    """`step(model, dense, cat) -> logits`, run under `torch.inference_mode`."""
    del cfg  # the model carries its config; kept for the JAX signature

    def step(model: DLRM, dense, cat):
        with torch.inference_mode():
            return dlrm_forward(model, dense, cat)
    return step


def lazy_stack_update(flat, valid, delta_t: torch.Tensor, dim: int,
                      combiner: str, bags=None) -> SparseEmbeddingUpdate:
    """The lazy update of a stacked ensemble from its flat ids and validity
    mask (`stacked_flat_indices`) and the `(T, B, dim)` activation
    cotangent, weighted as the forward combined the bags. `bags`
    (`BagLayout.bags`) names each multi-hot id's row of the
    cotangent: the update then carries the `(T * B, dim)` cotangent as it
    is, not one row an id."""
    w = stacked_update_weights(valid, combiner, flat.shape)
    return SparseEmbeddingUpdate(
        delta=delta_t.reshape(-1, dim).float(), indices=flat,
        weights=None if w is None else w.to(flat.device), bags=bags)


def step_generator(sparse_opt, generator, loop: str) -> dict:
    """`apply`'s stochastic-rounding keywords for one step: the generator
    when `sparse_opt` rounds stochastically (required then), else none."""
    if not getattr(sparse_opt, "stochastic_rounding", False):
        return {}
    if generator is None:
        raise ValueError(
            "sparse_opt.stochastic_rounding=True: pass a torch.Generator "
            f"as generator= ({loop} passes one)")
    return {"generator": generator}


def microbatch_slices(microbatch) -> int:
    """The k of `microbatch=`: None, 0 and 1 are the monolithic step."""
    return microbatch if microbatch and microbatch > 1 else 1


def make_train_step(cfg: DLRMConfig, sparse_opt=None, dense_lr: float = 0.01,
                    dense_tx=None, microbatch: Optional[int] = None):
    """The single-device train step,
    `step(model, dense, cat, label, lr=None, generator=None) -> loss`.

    It updates `model` in place (the port's counterpart of JAX's donated
    model): the stacked table and its row state by ONE `sparse_opt.apply`
    (default `SparseSGD()`; also `SparseRowWiseAdaGrad`, `SparseLazyAdam`,
    `SparseFTRL`) of the lazy `(delta, indices)` update, then the towers by
    plain SGD at `dense_lr`, or by one step of `dense_tx` (a factory from
    the tower parameters to a `torch.optim.Optimizer`, whose state the model
    holds: `init_dlrm(dense_tx=)`). The table is read by the forward lookup
    before the update writes it (one stream, in order), and an `apply` that
    refuses the step (FTRL given another `lr`) leaves the model as it was.
    `lr` overrides `sparse_opt.lr` for this step; `generator` feeds
    stochastic rounding and is required when
    `sparse_opt.stochastic_rounding` is set.

    `microbatch=k` (k > 1) takes the loss and gradients over k equal slices
    of the batch, one lookup and one backward each, so only B/k examples'
    activations are live at once (`models/microbatch.py`); the update is
    still one `apply` of the whole batch's delta: the monolithic step up to
    float re-association.

    Each layer of the step is a telemetry phase (`utils/telemetry.py`,
    no synchronisation): "step.lookup" (the flat ids and the gather),
    "step.forward" (towers, interaction, loss), "step.backward"
    (`torch.autograd.grad`), "step.sparse_update" (the lazy update and
    `sparse_opt.apply`, whose run-scatter path opens "update.sort",
    "update.permute" and "update.scatter") and "step.dense_update"; under
    `microbatch=k` the first three open k times a step."""
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
                logits = forward_from_embeddings(model.bottom, model.top, cfg,
                                                 dense, emb_t)
                loss = bce_loss(logits, label)
            with phase("step.backward"):
                *dense_grads, delta_t = torch.autograd.grad(loss,
                                                            params + [emb_t])
        return loss.detach(), dense_grads, (delta_t,), (flat, valid)

    def step(model: DLRM, dense, cat, label, lr=None, generator=None):
        kw = step_generator(sparse_opt, generator, "train_dlrm")
        require_dense_state(model, dense_tx, "init_dlrm")
        tables = model.tables
        device = tables.data.device
        dense = torch.as_tensor(dense).to(device)
        cat = torch.as_tensor(cat).to(device)
        label = torch.as_tensor(label).to(device)
        params = [p for _, p in model.tower_params()]
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
