"""DeepFM (counterpart of `embeddingtables_tpu/models/deepfm.py`).

Guo et al., "DeepFM: A Factorization-Machine based Neural Network for CTR
Prediction" (IJCAI 2017): an FM and a deep tower sharing one set of field
embeddings,

    logit = <w, x>                      (first order: one weight a category)
          + sum_{i<j} <v_i, v_j>        (second order over field vectors)
          + MLP([v_1; ...; v_T; dense]) (deep component)

  - Field vectors: the DLRM's one-gather `StackedTables` ensemble (dim D).
  - First-order weights, folded (`fold_fm_w=True`, the default): column 0 of
    one fused `(sum V, D+1)` stack, so one gather fetches both and one lazy
    update (one run-scatter) trains both. Unfolded: a second stack of dim 1
    that shares the ids and has its own optimizer state.
  - Second order by the sum-square identity
    `0.5 * sum_d [(sum_i v_id)^2 - sum_i v_id^2]`, in float32.
  - The FM terms are float32 even under bf16 towers; the deep tower takes
    the D-wide part of each row only.

Training differentiates the loss with respect to the looked-up activation
sets; each stack gets its lazy update, applied in place. The towers take
plain SGD or one step of `dense_tx` over JAX's `(deep, head, dense_w,
bias)`; `microbatch=k` takes the gradients over k slices of the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import resolve_device
from ..ops.ensemble import StackedTables
from ..optim import (SparseAdamState, SparseFTRLState, SparseOptState,
                     SparseSGD, apply_dense_tx, check_dense_tx,
                     require_dense_state)
from .dlrm import (RowState, _init_mlp, _mlp, _pairs, _param_list,
                   bce_loss, embedding_forward, lazy_stack_update,
                   microbatch_slices, stacked_flat_indices,
                   stacked_table_init, step_generator, with_dense_tx)
from .microbatch import microbatch_grads


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    vocab_sizes: Tuple[int, ...]
    num_dense: int = 13
    dim: int = 128                       # FM embedding size
    deep_mlp: Tuple[int, ...] = (400, 400)
    use_fm: bool = True                  # ablations: FM-only / deep-only
    use_deep: bool = True
    bag: Optional[int] = None
    combiner: str = "sum"
    pad_idx: Optional[int] = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # Storage dtype of the embedding tables only (None = param_dtype).
    table_dtype: Optional[torch.dtype] = None
    # First-order weights as column 0 of the FM-vector stack. With row-wise
    # AdaGrad the fused row shares ONE accumulator (mean of g^2 over D+1
    # columns); elementwise optimizers are the same in either layout.
    fold_fm_w: bool = True

    @property
    def tables_dtype(self):
        return self.table_dtype if self.table_dtype is not None \
            else self.param_dtype

    @property
    def folded(self) -> bool:
        """True when the first-order weights live inside the FM stack."""
        return self.use_fm and self.fold_fm_w

    @property
    def stack_dim(self) -> int:
        """Storage width of `tables` (D, or D+1 with the folded column)."""
        return self.dim + (1 if self.folded else 0)

    def __post_init__(self):
        if self.combiner not in ("sum", "mean"):
            raise ValueError(self.combiner)
        if not (self.use_fm or self.use_deep):
            raise ValueError("at least one of use_fm/use_deep must be on")
        if self.use_deep and not self.deep_mlp:
            raise ValueError("use_deep=True requires a non-empty deep_mlp "
                             "(pass use_deep=False for a plain FM)")

    @property
    def num_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def deep_features(self) -> int:
        return self.num_tables * self.dim + self.num_dense


def deepfm_small_config(vocab: int = 100_000, **kw) -> DeepFMConfig:
    """Criteo-Kaggle-shaped small config (26 tables)."""
    kw.setdefault("vocab_sizes", tuple([vocab] * 26))
    return DeepFMConfig(**kw)


class DeepFM(nn.Module):
    """The deep tower and head as `(W, b)` pairs, the dense features'
    first-order weights `dense_w (num_dense,)`, the global `bias ()`, and
    the stacked ensemble(s) with their row states as buffers. Folded layout
    (`config.folded`): `tables` is the fused `(sum V, D+1)` stack and `fm_w`
    and `fm_state` are None. Unfolded: `tables` holds the D-wide vectors and
    `fm_w` the 1-wide first-order weights, each with its own state. Without
    the deep tower (`use_deep=False`) the head is a `(1, 1)` placeholder of
    zeros and the tower is empty, so the parameters round-trip with JAX.
    `dense_opt_state` is the towers' optimizer state (a `DenseOptState`),
    or None for plain SGD."""

    emb_state = RowState("emb")
    fm_state = RowState("fm", optional=True)

    def __init__(self, config: DeepFMConfig, deep, head, dense_w, bias,
                 tables: StackedTables, fm_w: Optional[StackedTables] = None,
                 emb_state=None, fm_state=None, dense_opt_state=None):
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

    def tower_params(self) -> list:
        """`(name, parameter)` in JAX's order, `(deep, head, dense_w,
        bias)` (the module registers `dense_w` and `bias` first)."""
        named = list(self.named_parameters())
        rank = {"deep_params": 0, "head_params": 1, "dense_w": 2, "bias": 3}
        return sorted(named, key=lambda nv: rank[nv[0].split(".")[0]])

    @property
    def deep(self):
        return _pairs(self.deep_params)

    @property
    def head(self):
        return tuple(self.head_params)

    @property
    def dense_params(self) -> tuple:
        """`(deep, head, dense_w, bias)`, as `forward_from_embeddings`
        takes them."""
        return self.deep, self.head, self.dense_w, self.bias

    def forward(self, dense, cat):
        return deepfm_forward(self, dense, cat)


def _stack_offsets(vocab_sizes):
    offs, acc = [0], 0
    for v in vocab_sizes:
        acc += v
        offs.append(acc)
    return tuple(offs), acc


def init_deepfm(cfg: DeepFMConfig, generator: torch.Generator | None = None,
                device=None, sparse_opt=None, dense_tx=None) -> DeepFM:
    """Random DeepFM on `device` (CUDA unless given): Glorot-normal tower,
    zero biases, FM vectors uniform in [-1, 1) / sqrt(dim), first-order
    weights, `dense_w` and `bias` at zero, `sparse_opt`'s initial row
    state for each stack (default `SparseSGD`) and `dense_tx`'s initial
    tower state (`init_dlrm`). `generator` must live on that device; by
    default one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = cfg.param_dtype
    if cfg.use_deep:
        deep = _init_mlp((cfg.deep_features,) + cfg.deep_mlp, dt, generator,
                         device)
        head = _init_mlp((cfg.deep_mlp[-1], 1), dt, generator, device)[0]
    else:
        deep = []
        head = (torch.zeros((1, 1), dtype=dt, device=device),
                torch.zeros((1,), dtype=dt, device=device))
    vecs = stacked_table_init(cfg.vocab_sizes, cfg.dim, cfg.tables_dtype,
                              generator, device)
    offs, total_v = _stack_offsets(cfg.vocab_sizes)
    zeros = torch.zeros((total_v, 1), dtype=cfg.tables_dtype, device=device)
    sparse_opt = sparse_opt or SparseSGD()
    if cfg.folded:
        tables = StackedTables(torch.cat([zeros, vecs.data], dim=1), offs,
                               cfg.stack_dim)
        fm_w, fm_state = None, None
    else:
        tables = vecs
        fm_w = StackedTables(zeros, offs, 1)
        fm_state = sparse_opt.init(fm_w.data)
    return with_dense_tx(DeepFM(
        cfg, deep, head, torch.zeros((cfg.num_dense,), dtype=dt,
                                     device=device),
        torch.zeros((), dtype=dt, device=device), tables, fm_w,
        sparse_opt.init(tables.data), fm_state), dense_tx)


def split_fused(g_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused activations `(T, B, D+1)` -> `(w_t (T, B, 1), emb_t (T, B, D))`;
    `fuse_delta` is the adjoint."""
    return g_t[..., :1], g_t[..., 1:]


def fuse_delta(delta_w: torch.Tensor, delta_emb: torch.Tensor) -> torch.Tensor:
    """Adjoint of `split_fused`: one `(T, B, D+1)` cotangent for the fused
    stack, so both parameter groups ride one lazy update."""
    return torch.cat([delta_w, delta_emb], dim=-1)


def lookup_acts(tables: StackedTables, cfg: DeepFMConfig, cat):
    """`(emb_t, w_t)` from one gather of `tables`; `w_t` is None unless the
    layout is folded (the unfolded layout looks it up from `fm_w`)."""
    g_t = embedding_forward(tables, cat, cfg.combiner, cfg.pad_idx)
    if cfg.folded:
        w_t, emb_t = split_fused(g_t)
        return emb_t, w_t
    return g_t, None


def fm_second_order(emb_t: torch.Tensor) -> torch.Tensor:
    """`sum_{i<j} <v_i, v_j>` per example by the sum-square identity:
    `emb_t (T, B, D) -> (B,)`, no pairwise expansion."""
    s = emb_t.sum(dim=0)                  # (B, D): sum_i v_i
    sq = torch.square(emb_t).sum(dim=0)   # (B, D): sum_i v_i^2
    return 0.5 * (torch.square(s) - sq).sum(dim=-1)


def forward_from_embeddings(dense_params, cfg: DeepFMConfig,
                            dense: torch.Tensor, emb_t: torch.Tensor,
                            w_t) -> torch.Tensor:
    """Logits `(B,)` from looked-up activations: `emb_t (T, B, D)` and
    `w_t (T, B, 1)` (None iff use_fm=False). use_fm gates the whole FM part
    (first order, the dense linear term, second order), in float32;
    use_deep gates the tower, in `compute_dtype`."""
    deep, head, dense_w, bias = dense_params
    cd = cfg.compute_dtype
    b = emb_t.shape[1]
    logit = bias.float().expand(b)
    if cfg.use_fm:
        logit = logit + w_t[..., 0].float().sum(dim=0)
        logit = logit + dense.float() @ dense_w.float()
        logit = logit + fm_second_order(emb_t.float())
    if cfg.use_deep:
        flat = emb_t.permute(1, 0, 2).reshape(b, -1)
        x = torch.cat([flat.to(cd), dense.to(cd)], dim=-1)
        hw, hb = head
        out = _mlp(deep, x, cd) @ hw.to(cd) + hb.to(cd)
        logit = logit + out[:, 0].float()
    return logit


def _fm_weight_forward(fm_w: StackedTables, cat, combiner: str,
                       pad_idx=None) -> torch.Tensor:
    """`(T, B, 1)` first-order weights of the unfolded layout (the same
    one-gather ensemble path)."""
    return embedding_forward(fm_w, cat, combiner, pad_idx)


def _acts(model: DeepFM, cat):
    cfg = model.config
    emb_t, w_t = lookup_acts(model.tables, cfg, cat)
    if cfg.use_fm and not cfg.folded:
        w_t = _fm_weight_forward(model.fm_w, cat, cfg.combiner, cfg.pad_idx)
    return emb_t, w_t


def deepfm_forward(model: DeepFM, dense, cat) -> torch.Tensor:
    """Logits `(B,)` for dense `(B, num_dense)` and cat `(T, B[, bag])`
    (tensors or arrays; moved to the model's device)."""
    device = model.tables.data.device
    emb_t, w_t = _acts(model, torch.as_tensor(cat).to(device))
    return forward_from_embeddings(model.dense_params, model.config,
                                   torch.as_tensor(dense).to(device), emb_t,
                                   w_t)


def _lazy_update(tables: StackedTables, cat, delta_t: torch.Tensor, dim: int,
                 combiner: str, pad_idx=None):
    """`(T, B[, bag])` ids and `(T, B, dim)` deltas -> one stacked lazy
    update."""
    flat, valid = stacked_flat_indices(tables, cat, pad_idx)
    return lazy_stack_update(flat, valid, delta_t, dim, combiner)


def make_eval_step(cfg: DeepFMConfig):
    """`step(model, dense, cat) -> logits`, under `torch.inference_mode`."""
    del cfg  # the model carries its config; kept for the JAX signature

    def step(model: DeepFM, dense, cat):
        with torch.inference_mode():
            return deepfm_forward(model, dense, cat)
    return step


def make_train_step(cfg: DeepFMConfig, sparse_opt=None,
                    dense_lr: float = 0.01, dense_tx=None, microbatch=None):
    """The single-device train step,
    `step(model, dense, cat, label, lr=None, generator=None) -> loss`,
    updating the model in place: the loss is differentiated with respect to
    the looked-up activation sets. Folded: the two cotangents fuse back
    into one `(T, B, D+1)` delta, one update of the fused stack. Unfolded:
    two updates, the FM vectors' and then the first-order weights', each
    with its own state (under stochastic rounding the second draws its
    noise from the same generator after the first). The towers take plain
    SGD, or one step of `dense_tx` over `(deep, head, dense_w, bias)`
    (`init_deepfm(dense_tx=)` holds its state). `microbatch=k` takes both
    activation sets' gradients over k slices of the batch before those
    updates."""
    check_dense_tx(dense_tx)
    sparse_opt = sparse_opt or SparseSGD()
    k = microbatch_slices(microbatch)

    def grads(model, params, dense, cat, label):
        with torch.no_grad():
            emb_t, w_t = _acts(model, cat)
        acts = [emb_t.detach().requires_grad_(True)]
        if cfg.use_fm:
            acts.append(w_t.detach().requires_grad_(True))
        with torch.enable_grad():
            loss = bce_loss(forward_from_embeddings(
                model.dense_params, cfg, dense, acts[0],
                acts[1] if cfg.use_fm else None), label)
            out = torch.autograd.grad(loss, params + acts, allow_unused=True)
        # The placeholder head (use_deep=False) and dense_w (use_fm=False)
        # take no part in the forward: zero gradients, as in JAX.
        dense_grads = [torch.zeros_like(p) if g is None else g
                       for p, g in zip(params, out[:len(params)])]
        return loss.detach(), dense_grads, tuple(out[len(params):])

    def step(model: DeepFM, dense, cat, label, lr=None, generator=None):
        kw = step_generator(sparse_opt, generator, "train_deepfm")
        require_dense_state(model, dense_tx, "init_deepfm")
        device = model.tables.data.device
        dense = torch.as_tensor(dense).to(device)
        cat = torch.as_tensor(cat).to(device)
        label = torch.as_tensor(label).to(device)
        params = [p for _, p in model.tower_params()]  # the tables are buffers
        if k > 1:
            loss, dense_grads, deltas = microbatch_grads(
                params, dense, cat, label, k,
                lambda *s: grads(model, params, *s))
        else:
            loss, dense_grads, deltas = grads(model, params, dense, cat,
                                              label)
        delta_emb, *delta_w = deltas
        if cfg.folded:
            delta_emb = fuse_delta(delta_w[0], delta_emb)
        upd = _lazy_update(model.tables, cat, delta_emb, cfg.stack_dim,
                           cfg.combiner, cfg.pad_idx)
        model.tables.data, model.emb_state = sparse_opt.apply(
            model.tables.data, upd, model.emb_state, lr=lr, **kw)
        if cfg.use_fm and not cfg.folded:
            upd_w = _lazy_update(model.fm_w, cat, delta_w[0], 1,
                                 cfg.combiner, cfg.pad_idx)
            model.fm_w.data, model.fm_state = sparse_opt.apply(
                model.fm_w.data, upd_w, model.fm_state, lr=lr, **kw)
        apply_dense_tx(params, dense_grads, dense_tx, model.dense_opt_state,
                       dense_lr)
        return loss

    return step


# ---------------------------------------------------------------------------
# Layout conversion (between the fold_fm_w layouts)
# ---------------------------------------------------------------------------

def _fuse_states(emb_state, fm_state, dim: int):
    """The fused stack's state from the unfolded pair, exact for every
    sparse optimizer: elementwise states (Adam's m, v; FTRL's z, n) concat
    along the feature axis, first-order column first; SGD's empty state
    passes through; row-wise AdaGrad's accumulators are running means over
    columns, so fused = (D * acc_v + acc_w) / (D + 1)."""
    if isinstance(emb_state, SparseAdamState):
        return SparseAdamState(m=torch.cat([fm_state.m, emb_state.m], 1),
                               v=torch.cat([fm_state.v, emb_state.v], 1),
                               count=emb_state.count.clone())
    if isinstance(emb_state, SparseFTRLState):
        return SparseFTRLState(z=torch.cat([fm_state.z, emb_state.z], 1),
                               n=torch.cat([fm_state.n, emb_state.n], 1))
    if isinstance(emb_state, SparseOptState):
        if emb_state.accum.numel() == 0:          # SGD: stateless
            return SparseOptState(emb_state.accum.clone())
        return SparseOptState(accum=(dim * emb_state.accum
                                     + fm_state.accum) / (dim + 1))
    raise TypeError(f"unknown sparse-optimizer state {type(emb_state)}")


def _copy_dense(model: DeepFM):
    """The dense parameters as fresh tensors: a converted model trains in
    place without touching the one it came from."""
    deep = [(w.detach().clone(), b.detach().clone()) for w, b in model.deep]
    head = tuple(t.detach().clone() for t in model.head)
    return deep, head, model.dense_w.detach().clone(), \
        model.bias.detach().clone()


def _copy_dense_state(model: DeepFM):
    """The tower optimizer state as fresh tensors (None stays None): a
    layout conversion keeps it, as JAX's does."""
    st = model.dense_opt_state
    return None if st is None else st.clone()


def fuse_deepfm(model: DeepFM) -> DeepFM:
    """Unfolded DeepFM -> the folded fused-stack layout, as a new model
    (exact for every optimizer state, `_fuse_states`). A folded model comes
    back as it is."""
    cfg = model.config
    if cfg.folded:
        return model
    if not cfg.use_fm:
        raise ValueError("use_fm=False has no first-order stack to fold")
    new_cfg = dataclasses.replace(cfg, fold_fm_w=True)
    data = torch.cat([model.fm_w.data, model.tables.data], dim=1)
    return DeepFM(new_cfg, *_copy_dense(model),
                  StackedTables(data, model.tables.offsets, new_cfg.stack_dim),
                  None, _fuse_states(model.emb_state, model.fm_state, cfg.dim),
                  dense_opt_state=_copy_dense_state(model))


def unfuse_deepfm(model: DeepFM, sparse_opt=None) -> DeepFM:
    """Folded DeepFM -> the unfolded two-stack layout, as a new model. Exact
    for elementwise states (SGD, Adam, FTRL: a column split); row-wise
    AdaGrad's fused `(V,)` accumulator cannot be split, so each stack gets a
    copy of it (the v-stack's scale to within 1/(D+1)). An unfolded model
    comes back as it is; `sparse_opt` is unused, kept for the JAX
    signature."""
    del sparse_opt
    cfg = model.config
    if not cfg.folded:
        return model
    new_cfg = dataclasses.replace(cfg, fold_fm_w=False)
    data = model.tables.data
    st = model.emb_state
    if isinstance(st, SparseAdamState):
        fm_state = SparseAdamState(m=st.m[:, :1].contiguous(),
                                   v=st.v[:, :1].contiguous(),
                                   count=st.count.clone())
        emb_state = SparseAdamState(m=st.m[:, 1:].contiguous(),
                                    v=st.v[:, 1:].contiguous(),
                                    count=st.count.clone())
    elif isinstance(st, SparseFTRLState):
        fm_state = SparseFTRLState(z=st.z[:, :1].contiguous(),
                                   n=st.n[:, :1].contiguous())
        emb_state = SparseFTRLState(z=st.z[:, 1:].contiguous(),
                                    n=st.n[:, 1:].contiguous())
    elif isinstance(st, SparseOptState):
        # SGD's empty state, or AdaGrad's shared accumulator: one copy each.
        fm_state = SparseOptState(st.accum.clone())
        emb_state = SparseOptState(st.accum.clone())
    else:
        raise TypeError(f"unknown sparse-optimizer state {type(st)}")
    offs = model.tables.offsets
    return DeepFM(new_cfg, *_copy_dense(model),
                  StackedTables(data[:, 1:].contiguous(), offs, cfg.dim),
                  StackedTables(data[:, :1].contiguous(), offs, 1),
                  emb_state, fm_state,
                  dense_opt_state=_copy_dense_state(model))
