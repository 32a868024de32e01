"""Sparse optimizers: fused, dedup-correct row updates for embedding tables
(counterpart of `embeddingtables_tpu/optim.py`).

`SparseSGD`, `SparseRowWiseAdaGrad` (one f32 accumulator per row),
`SparseLazyAdam` (f32 moments `m`, `v` per coordinate and a global step
count) and `SparseFTRL` (FTRL-Proximal: f32 `z`, `n` per coordinate) apply a
lazy `SparseEmbeddingUpdate` to a `(V, D)` table. Each unique row is written
once and its state advanced once per step. Two realizations, chosen as the
JAX package chooses them, so both packages take the same branch for the same
call:

  - the run-scatter (`ops/cuda/scatter.py`): SGD without regularization, and
    AdaGrad's "indexer" method. Ids follow JAX's `.at[]` contract: `[-V, 0)`
    wraps, other out-of-range ids are dropped.
  - the dense realization (`sgd_dense_body`, `adagrad_dense_body`,
    `adam_dense_body`, `ftrl_dense_body`): a `(V, D)` f32 gradient from
    `_dense_grad`, then elementwise passes. It carries Adam and FTRL,
    `weight_decay`, `clipnorm`, stochastic rounding and `dense_grad_dtype`,
    and takes tables of at most `_SEGSUM_MAX_VPAD` padded rows through
    `hot_accumulate`.

`apply` updates the table and the row state in place and returns them: the
port's counterpart of JAX's donated buffers (Adam's `count` comes back as a
new 0-d int32 tensor). Where JAX's `apply` takes a PRNG `key=` for
stochastic rounding, the port takes a `torch.Generator` as `generator=`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from .ops.cuda.scatter import scatter_update
from .ops.cuda.segsum import hot_accumulate
from .ops.sparse_update import (SparseEmbeddingUpdate, dense_scatter,
                                occurrence_values, resolve_rows)
from .rounding import stochastic_cast


class SparseOptState(NamedTuple):
    """Per-table optimizer state: `accum` is `(vocab,)` f32 for row-wise
    AdaGrad, or a zero-size placeholder for stateless SGD."""

    accum: torch.Tensor


class SparseAdamState(NamedTuple):
    """Lazy-Adam state: `(vocab, dim)` f32 first and second moments (two
    distinct buffers) and the global step count, a 0-d int32 tensor (bias
    correction uses the global step, the TF-LazyAdam convention)."""

    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor


class SparseFTRLState(NamedTuple):
    """FTRL-Proximal state: `(vocab, dim)` f32 accumulated adjusted gradient
    `z` and squared-gradient sum `n` (McMahan et al. 2013, Alg. 1)."""

    z: torch.Tensor
    n: torch.Tensor


def _occurrence_grads(upd: SparseEmbeddingUpdate, row_offset: int = 0):
    """Per-occurrence `(rows, grad)` streams; `row_offset` shifts local rows
    into a stacked ensemble's global row space."""
    rows, vals = occurrence_values(upd)
    return rows + row_offset, vals


# The JAX package's crossover between its one-hot segment sum and XLA's
# scatter, measured on a TPU v5e (512 padded rows). Kept so that both
# packages take the same branch; the H100's own crossover is measured by
# chip_smoke.py and not set yet.
_SEGSUM_MAX_VPAD = 512


def _segsum_vpad(data) -> Optional[int]:
    """Padded segment count when `hot_accumulate` takes this table's dense
    gradient (padded vocab <= _SEGSUM_MAX_VPAD, D % 128 == 0), else None."""
    v, d = data.shape
    vpad = -(-v // 128) * 128
    if d % 128 == 0 and vpad <= _SEGSUM_MAX_VPAD:
        return vpad
    return None


def _dense_grad(data, rows, g, grad_dtype=None):
    """Duplicate-accumulated `(V, D)` f32 gradient.

    Tiny tables (`_segsum_vpad`) go to `hot_accumulate` in f32: ids outside
    `[0, vpad)` are dropped and ids in `[V, vpad)` land on pad rows that are
    cut off. Every other table scatters into a `(V, D)` scratch of
    `grad_dtype` (None = f32) with `index_add_`: ids in `[-V, 0)` wrap and
    the rest are dropped (JAX's `.at[].add(mode="drop")`)."""
    v = data.shape[0]
    vpad = _segsum_vpad(data)
    if vpad is not None and rows.numel() > 0:
        return hot_accumulate(rows.to(torch.int32), g.float(), vpad,
                              compute_dtype=torch.float32)[:v]
    sdt = torch.float32 if grad_dtype is None else _as_dtype(grad_dtype)
    if not sdt.is_floating_point:
        # e.g. int32 would truncate every sub-1 gradient to zero and turn
        # the update into a no-op.
        raise ValueError(
            f"dense_grad_dtype must be a floating dtype, got {sdt}")
    return dense_scatter(rows, g.to(sdt), v).float()


def run_scatter_dense_grad(data, rows, g, grad_dtype=None):
    """`_dense_grad`'s contract through the run-scatter: the occurrences
    sorted (stable), then summed into a zeroed scratch at scale 1 with one
    write per row. The run-scatter has no atomics, so the same ids and
    values give the same bits on every card and every run, where
    `index_add_` and `hot_accumulate` add in a varying order. The scratch
    is f32 or bfloat16 (`grad_dtype`); any other float dtype sums in f32 and
    rounds once to it. The planner's replicated group takes this, so its
    replicas stay bitwise equal without an all-reduce."""
    v, d = data.shape
    sdt = torch.float32 if grad_dtype is None else _as_dtype(grad_dtype)
    if not sdt.is_floating_point:
        raise ValueError(
            f"dense_grad_dtype must be a floating dtype, got {sdt}")
    run_dtype = sdt if sdt in (torch.float32, torch.bfloat16) \
        else torch.float32
    grad = torch.zeros((v, d), dtype=run_dtype, device=data.device)
    scatter_update(grad, resolve_rows(rows, v), g.float().contiguous(), 1.0)
    return grad.to(sdt).float()


def _as_dtype(d) -> torch.dtype:
    """A torch dtype from a dtype or its name ("bfloat16", "float32")."""
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def _touched(grad_dense):
    """(V,) bool: rows that carry any gradient this step."""
    return torch.any(grad_dense != 0.0, dim=-1)


def _clip_rows(grad_dense, clipnorm):
    """Per-row L2 clip of the accumulated row gradient (clip after dedup)."""
    if clipnorm is None:
        return grad_dense
    norm = torch.linalg.vector_norm(grad_dense, dim=-1, keepdim=True)
    scale = torch.clamp_max(clipnorm / torch.clamp_min(norm, 1e-12), 1.0)
    return grad_dense * scale


def sgd_dense_body(data, rows, g, lr, weight_decay: float = 0.0,
                   clipnorm: Optional[float] = None, generator=None,
                   grad_dtype=None, dense_grad=_dense_grad) -> torch.Tensor:
    """`data[r] -= lr * clip(sum g_r)` with lazy decay on touched rows,
    written into `data` in place. With `generator` and a bf16 table the one
    cast back to storage rounds stochastically; untouched rows stay exact.
    `dense_grad(data, rows, g, grad_dtype)` realizes the `(V, D)` f32
    gradient (every body takes it: `_dense_grad`, or
    `run_scatter_dense_grad` where the bits must not vary)."""
    grad = _clip_rows(dense_grad(data, rows, g, grad_dtype), clipnorm)
    new = data.float() - lr * grad
    if weight_decay == 0.0:
        # Untouched rows: grad = 0 gives new == data, and SR is exact on
        # representable values, so no mask is needed.
        return data.copy_(stochastic_cast(new, data.dtype, generator))
    touched = _touched(grad)
    new = new * torch.where(touched, 1.0 - lr * weight_decay, 1.0)[:, None]
    out = stochastic_cast(new, data.dtype, generator)
    if generator is not None:
        out = torch.where(touched[:, None], out, data)
    return data.copy_(out)


def adagrad_dense_body(data, accum, rows, g, lr, eps,
                       weight_decay: float = 0.0,
                       clipnorm: Optional[float] = None, generator=None,
                       grad_dtype=None, dense_grad=_dense_grad):
    """Row-wise AdaGrad through the dense gradient, in place: returns
    `(data, accum)`. Untouched rows are exact fixed points, at eps = 0 too
    (the 1e-30 clamp keeps rsqrt finite)."""
    grad = _clip_rows(dense_grad(data, rows, g, grad_dtype), clipnorm)
    accum.add_(torch.mean(grad * grad, dim=-1))
    denom = torch.rsqrt(torch.clamp_min(accum + eps, 1e-30))
    step = lr * grad * denom[:, None]
    if weight_decay == 0.0:
        return data.copy_(stochastic_cast(data.float() - step, data.dtype,
                                          generator)), accum
    touched = _touched(grad)
    new = data.float() - torch.where(touched[:, None], step, 0.0)
    new = new * torch.where(touched, 1.0 - lr * weight_decay, 1.0)[:, None]
    out = stochastic_cast(new, data.dtype, generator)
    if generator is not None:
        out = torch.where(touched[:, None], out, data)
    return data.copy_(out), accum


def adam_dense_body(data, m, v, t, rows, g, lr, b1, b2, eps,
                    weight_decay: float = 0.0,
                    clipnorm: Optional[float] = None, generator=None,
                    grad_dtype=None, dense_grad=_dense_grad):
    """Lazy Adam through the dense gradient, in place: returns
    `(data, m, v)`. `t` is the global step (an int or a 0-d tensor). Touched
    rows advance their moments and take a step; untouched rows are exact
    fixed points. `weight_decay` is decoupled (AdamW-style) and lazy."""
    grad = _clip_rows(dense_grad(data, rows, g, grad_dtype), clipnorm)
    touched = _touched(grad)[:, None]
    m.copy_(torch.where(touched, b1 * m + (1 - b1) * grad, m))
    v.copy_(torch.where(touched, b2 * v + (1 - b2) * grad * grad, v))
    tf = t.float() if torch.is_tensor(t) else float(t)
    mhat = m / (1 - b1 ** tf)
    vhat = v / (1 - b2 ** tf)
    step = lr * mhat / (torch.sqrt(vhat) + eps)
    new = data.float() - torch.where(touched, step, 0.0)
    if weight_decay != 0.0:
        new = new * torch.where(touched, 1.0 - lr * weight_decay, 1.0)
    out = stochastic_cast(new, data.dtype, generator)
    if generator is not None:
        out = torch.where(touched, out, data)
    return data.copy_(out), m, v


def ftrl_init_arrays(data, alpha, beta, l1, l2, initial_accum):
    """`(z0, n0)` that reproduce `data` under FTRL's closed form:
    `z0 = -w0 * ((beta + sqrt(n0)) / alpha + l2) - sign(w0) * l1` (zero
    where `w0` is zero), so the first touch of a row does not snap it to
    the l1-shrunk origin."""
    w0 = data.float()
    n0 = torch.full(data.shape, initial_accum, dtype=torch.float32,
                    device=data.device)
    denom = (beta + torch.sqrt(n0)) / alpha + l2
    z0 = torch.where(w0 != 0.0, -w0 * denom - torch.sign(w0) * l1, 0.0)
    return z0, n0


def ftrl_dense_body(data, z, n, rows, g, alpha, beta, l1, l2,
                    clipnorm: Optional[float] = None, generator=None,
                    grad_dtype=None, dense_grad=_dense_grad):
    """FTRL-Proximal through the dense gradient, in place: returns
    `(data, z, n)`. Per touched row, per coordinate:

        n' = n + g^2
        z' = z + g - ((sqrt(n') - sqrt(n)) / alpha) * w
        w' = 0                                  if |z'| <= l1
             -(z' - sign(z') * l1) / ((beta + sqrt(n')) / alpha + l2)  else

    Untouched rows are exact fixed points; `l1` gives exact zeros. On bf16
    tables the recomputed weights of a touched row re-round."""
    grad = _clip_rows(dense_grad(data, rows, g, grad_dtype), clipnorm)
    touched = _touched(grad)[:, None]
    w = data.float()
    new_n = n + grad * grad
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / alpha
    z.copy_(torch.where(touched, z + grad - sigma * w, z))
    n.copy_(torch.where(touched, new_n, n))
    del new_n, sigma
    denom = (beta + torch.sqrt(n)) / alpha + l2
    w_new = torch.where(torch.abs(z) > l1, -(z - torch.sign(z) * l1) / denom,
                        0.0)
    out = stochastic_cast(torch.where(touched, w_new, w), data.dtype,
                          generator)
    return data.copy_(torch.where(touched, out, data)), z, n


def _adam_state(group, p: torch.Tensor) -> dict:
    """The state `torch.optim.Adam` / `AdamW` create at a parameter's first
    step, made now: `step` on the parameter's device when the group is
    `capturable` or `fused`, else a 0-d f32 tensor on the CPU (torch's
    choice, which keeps the bias correction off the device), and zero
    moments beside the parameter."""
    on_device = group.get("capturable") or group.get("fused")
    state = {"step": torch.zeros((), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
             "exp_avg": torch.zeros_like(p),
             "exp_avg_sq": torch.zeros_like(p)}
    if group.get("amsgrad"):
        state["max_exp_avg_sq"] = torch.zeros_like(p)
    return state


def _initial_state(opt: torch.optim.Optimizer, p: torch.Tensor) -> dict:
    """`opt`'s state for `p` before its first step: what the optimizer made
    at construction (`Adagrad`), Adam's, or none for momentum-free SGD.
    Other optimizers make their state at their first step, so a model could
    not hold it (and a checkpoint could not carry it) before then."""
    if opt.state.get(p):
        return dict(opt.state[p])
    group = next(g for g in opt.param_groups
                 if any(q is p for q in g["params"]))
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return _adam_state(group, p)
    if isinstance(opt, torch.optim.SGD) and not group.get("momentum"):
        return {}
    raise ValueError(
        f"dense_tx built a {type(opt).__name__}, whose state appears at its "
        "first step; the port holds tower state from init_*(dense_tx=) on, "
        "for Adam, AdamW, Adagrad and SGD without momentum")


class DenseOptState(nn.Module):
    """A tower optimizer's state (the port's `dense_opt_state`): one buffer
    per parameter and state field, `<parameter name>__<field>`, made when the
    model is made, so the model's `state_dict()` (its checkpoints, the
    guard's rollback, a resume) carries it with the towers.

    `dense_tx` is a factory from the tower parameters to a
    `torch.optim.Optimizer`, such as `functools.partial(torch.optim.Adam,
    lr=1e-2)`. `optimizer(dense_tx, params)` builds it over the model's own
    parameters and points its state at these buffers, so every step updates
    them in place; the optimizer's `param_groups` (lr, betas) come from the
    factory at each step and are not part of the state, so a restored or
    copied model steps with the factory it is given."""

    def __init__(self, names, fields: dict):
        """`names`: the tower parameters' names, in the order the train step
        passes the parameters; `fields[name]`: that parameter's state
        tensors by field."""
        super().__init__()
        self.names = list(names)
        self.fields = {n: list(fields[n]) for n in self.names}
        for n in self.names:
            for f, t in fields[n].items():
                self.register_buffer(self._key(n, f), t)

    @staticmethod
    def _key(name: str, field: str) -> str:
        return f"{name.replace('.', '_')}__{field}"

    @classmethod
    def create(cls, named_params, dense_tx) -> "DenseOptState":
        """The initial state of `dense_tx(params)` for `named_params`
        (`(name, parameter)` pairs, the train step's order)."""
        check_dense_tx(dense_tx)
        named_params = list(named_params)
        opt = dense_tx([p for _, p in named_params])
        return cls([n for n, _ in named_params],
                   {n: _initial_state(opt, p) for n, p in named_params})

    def clone(self) -> "DenseOptState":
        """A copy with its own buffers (a converted model's state)."""
        return DenseOptState(self.names, {
            n: {f: t.clone() for f, t in self.state_of(n).items()}
            for n in self.names})

    def state_of(self, name: str) -> dict:
        return {f: getattr(self, self._key(name, f))
                for f in self.fields[name]}

    def optimizer(self, dense_tx, params) -> torch.optim.Optimizer:
        """`dense_tx(params)` with its state pointed at this module's
        buffers."""
        params = list(params)
        if len(params) != len(self.names):
            raise ValueError(f"the tower state holds {len(self.names)} "
                             f"parameters, the step passed {len(params)}")
        opt = dense_tx(params)
        for name, p in zip(self.names, params):
            opt.state[p] = self.state_of(name)
        return opt


def check_dense_tx(dense_tx) -> None:
    """`dense_tx` is None (plain SGD) or a callable optimizer factory."""
    if dense_tx is not None and not callable(dense_tx):
        raise TypeError(
            "dense_tx must be a factory from the tower parameters to a "
            "torch.optim.Optimizer (e.g. functools.partial("
            f"torch.optim.Adam, lr=1e-2)), got {type(dense_tx).__name__}")


def require_dense_state(model, dense_tx, init: str) -> None:
    """A step with `dense_tx` needs the tower state `init(dense_tx=)`
    makes; raised before the step changes anything."""
    if dense_tx is not None and getattr(model, "dense_opt_state",
                                        None) is None:
        raise ValueError(
            f"dense_tx= needs the model's tower optimizer state: build the "
            f"model with {init}(dense_tx=...) (or *_from_arrays("
            "dense_opt_state=...))")


@torch.no_grad()
def apply_dense_tx(params, grads, dense_tx, state, lr):
    """Tower update, in place: plain SGD `p -= lr * g` when `dense_tx` is
    None, else one step of `state.optimizer(dense_tx, params)` (a
    `DenseOptState`) on `grads`, which `lr` does not touch (the factory
    holds the optimizer's lr, as JAX's optax transform does). Returns
    `(params, state)`."""
    check_dense_tx(dense_tx)
    if dense_tx is None:
        for p, g in zip(params, grads):
            p.copy_((p - lr * g).to(p.dtype))
        return params, state
    if state is None:
        raise ValueError("dense_tx= needs a DenseOptState (init_*(dense_tx=))")
    opt = state.optimizer(dense_tx, params)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
    return params, state


@dataclasses.dataclass(frozen=True)
class SparseSGD:
    """Stateless sparse SGD: `table[r] -= lr * sum over the occurrences of r
    of delta`.

    weight_decay / clipnorm are lazy (touched rows only) and, like
    stochastic_rounding (bf16 tables; needs `apply(generator=...)`), route
    through the dense realization, whose gradient scratch dtype is
    dense_grad_dtype. Plain SGD takes the run-scatter (no scratch, so
    dense_grad_dtype does not apply, as in JAX), except on tables of at most
    `_SEGSUM_MAX_VPAD` padded rows, which take the dense body."""

    lr: float = 0.01
    weight_decay: float = 0.0
    clipnorm: Optional[float] = None
    stochastic_rounding: bool = False
    dense_grad_dtype: Optional[str] = None

    def init(self, data: torch.Tensor) -> SparseOptState:
        return SparseOptState(accum=torch.zeros((0,), dtype=data.dtype,
                                                device=data.device))

    def apply(self, data: torch.Tensor, upd: SparseEmbeddingUpdate,
              state: SparseOptState, *, row_offset: int = 0, lr=None,
              generator: torch.Generator | None = None):
        """One step, in place; returns `(data, state)`."""
        lr = self.lr if lr is None else lr
        rows, g = _occurrence_grads(upd, row_offset)
        if self.stochastic_rounding and generator is None:
            raise ValueError(
                "stochastic_rounding=True needs apply(generator=...)")
        gen = generator if self.stochastic_rounding else None
        if self.weight_decay == 0.0 and self.clipnorm is None and gen is None:
            if _segsum_vpad(data) is not None:
                return sgd_dense_body(data, rows, g, lr), state
            scatter_update(data, resolve_rows(rows, data.shape[0]),
                           g.float(), -float(lr))
            return data, state
        return sgd_dense_body(data, rows, g, lr, self.weight_decay,
                              self.clipnorm, generator=gen,
                              grad_dtype=self.dense_grad_dtype), state


@dataclasses.dataclass(frozen=True)
class SparseRowWiseAdaGrad:
    """Row-wise AdaGrad: one f32 accumulator per row.

        G_r   += mean(g_r^2)              (g_r: the deduped row gradient)
        row_r -= lr * g_r / sqrt(max(G_r + eps, 1e-30))

    method: "indexer" runs the run-scatter with the AdaGrad epilogue (one
    read and one write per unique row); "dense" the `(V, D)` dense pass;
    "auto" takes dense when regularized, when dense_grad_dtype is set, or
    when n * 16 >= V, else indexer (the JAX package's rule).
    weight_decay, clipnorm and stochastic_rounding need the dense method;
    so does dense_grad_dtype, which the indexer method refuses."""

    lr: float = 0.01
    eps: float = 1e-8
    initial_accum: float = 0.0
    weight_decay: float = 0.0
    clipnorm: Optional[float] = None
    stochastic_rounding: bool = False
    dense_grad_dtype: Optional[str] = None
    method: str = "auto"

    def init(self, data: torch.Tensor) -> SparseOptState:
        return SparseOptState(accum=torch.full(
            (data.shape[0],), self.initial_accum, dtype=torch.float32,
            device=data.device))

    def apply(self, data: torch.Tensor, upd: SparseEmbeddingUpdate,
              state: SparseOptState, *, row_offset: int = 0, lr=None,
              idx_result=None, method: str | None = None,
              generator: torch.Generator | None = None):
        """One step, in place; returns `(data, state)`. With `idx_result`
        (an `IndexerResult` of the update's ids) "auto" takes the indexer
        method; its rows are the update's own ids either way, since the
        run-scatter dedups them itself."""
        lr = self.lr if lr is None else lr
        rows, g = _occurrence_grads(upd, row_offset)
        method = method or self.method
        if self.stochastic_rounding and generator is None:
            raise ValueError(
                "stochastic_rounding=True needs apply(generator=...)")
        regularized = (self.weight_decay != 0.0 or self.clipnorm is not None
                       or self.stochastic_rounding)
        if method == "auto":
            if regularized or self.dense_grad_dtype is not None:
                method = "dense"
            elif idx_result is not None:
                method = "indexer"
            else:
                method = ("dense" if rows.numel() * 16 >= data.shape[0]
                          else "indexer")
        if regularized and method != "dense":
            raise ValueError(
                "weight_decay/clipnorm/stochastic_rounding require the "
                "dense realization (they apply per touched row)")
        if method == "dense":
            adagrad_dense_body(
                data, state.accum, rows, g, lr, self.eps, self.weight_decay,
                self.clipnorm,
                generator=generator if self.stochastic_rounding else None,
                grad_dtype=self.dense_grad_dtype)
            return data, state
        if method != "indexer":
            raise ValueError(
                f"method must be 'auto', 'dense' or 'indexer', got {method!r}")
        if self.dense_grad_dtype is not None:
            raise ValueError("dense_grad_dtype applies to the dense method "
                             "only; the indexer method sums in f32")
        scatter_update(data, resolve_rows(rows, data.shape[0]), g.float(), -float(lr), accum=state.accum,
                       eps=self.eps)
        return data, state


@dataclasses.dataclass(frozen=True)
class SparseLazyAdam:
    """Lazy Adam: moments and rows advance only for the rows touched this
    step (a strict Adam would decay every row's moments every step).

        m_r = b1*m_r + (1-b1)*g_r         (touched rows only)
        v_r = b2*v_r + (1-b2)*g_r^2
        row_r -= lr * (m_r/(1-b1^t)) / (sqrt(v_r/(1-b2^t)) + eps)

    Realized through the dense gradient (`adam_dense_body`). Memory: two
    table-sized f32 buffers. weight_decay (decoupled) and per-row clipnorm
    apply to touched rows only; stochastic_rounding needs
    `apply(generator=...)`."""

    lr: float = 0.001
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clipnorm: Optional[float] = None
    stochastic_rounding: bool = False
    dense_grad_dtype: Optional[str] = None

    def init(self, data: torch.Tensor) -> SparseAdamState:
        return SparseAdamState(
            m=torch.zeros(data.shape, dtype=torch.float32, device=data.device),
            v=torch.zeros(data.shape, dtype=torch.float32, device=data.device),
            count=torch.zeros((), dtype=torch.int32, device=data.device))

    def apply(self, data: torch.Tensor, upd: SparseEmbeddingUpdate,
              state: SparseAdamState, *, row_offset: int = 0, lr=None,
              generator: torch.Generator | None = None):
        """One step, in place; returns `(data, state)`."""
        lr = self.lr if lr is None else lr
        if self.stochastic_rounding and generator is None:
            raise ValueError(
                "stochastic_rounding=True needs apply(generator=...)")
        rows, g = _occurrence_grads(upd, row_offset)
        t = state.count + 1
        adam_dense_body(
            data, state.m, state.v, t, rows, g, lr, self.b1, self.b2,
            self.eps, self.weight_decay, self.clipnorm,
            generator=generator if self.stochastic_rounding else None,
            grad_dtype=self.dense_grad_dtype)
        return data, SparseAdamState(m=state.m, v=state.v, count=t)


@dataclasses.dataclass(frozen=True)
class SparseFTRL:
    """FTRL-Proximal (McMahan et al. 2013; TF `FtrlOptimizer` semantics):
    per-coordinate adaptive rates and l1/l2 regularization with exact
    zeros. `lr` is FTRL's alpha.

    The weight is a closed form of the state, so `init(data)` solves for the
    `z` that reproduces the table exactly (`ftrl_init_arrays`), and `apply`
    refuses a per-step `lr` other than the built one: alpha is baked into
    the accumulated `z`. Lazy: only touched rows advance. On bf16 tables a
    touched row's untouched coordinates re-round, so keep FTRL tables f32."""

    lr: float = 0.05
    beta: float = 1.0
    l1: float = 0.0
    l2: float = 0.0
    initial_accum: float = 0.0
    clipnorm: Optional[float] = None
    stochastic_rounding: bool = False
    dense_grad_dtype: Optional[str] = None

    def init(self, data: torch.Tensor) -> SparseFTRLState:
        return SparseFTRLState(*ftrl_init_arrays(
            data, self.lr, self.beta, self.l1, self.l2, self.initial_accum))

    def apply(self, data: torch.Tensor, upd: SparseEmbeddingUpdate,
              state: SparseFTRLState, *, row_offset: int = 0, lr=None,
              generator: torch.Generator | None = None):
        """One step, in place; returns `(data, state)`."""
        if lr is not None and lr != self.lr:
            raise ValueError(
                "SparseFTRL cannot change lr per step: alpha is baked into "
                "the accumulated z state. Build a new SparseFTRL and "
                "re-init (or keep lr fixed).")
        if self.stochastic_rounding and generator is None:
            raise ValueError(
                "stochastic_rounding=True needs apply(generator=...)")
        rows, g = _occurrence_grads(upd, row_offset)
        ftrl_dense_body(
            data, state.z, state.n, rows, g, self.lr, self.beta, self.l1,
            self.l2, self.clipnorm,
            generator=generator if self.stochastic_rounding else None,
            grad_dtype=self.dense_grad_dtype)
        return data, state


def warmup_cosine_lr(base_lr: float, total_steps: int,
                     warmup_steps: int = 0, final_scale: float = 0.0):
    """Linear warmup to `base_lr` over `warmup_steps`, then cosine decay to
    `final_scale * base_lr` at `total_steps`."""

    def schedule(step: int) -> float:
        if warmup_steps and step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        if total_steps <= warmup_steps:
            return base_lr
        frac = min(1.0, (step - warmup_steps)
                   / max(1, total_steps - warmup_steps))
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return base_lr * (final_scale + (1.0 - final_scale) * cos)

    return schedule


def warmup_constant_lr(base_lr: float, warmup_steps: int):
    """Linear warmup to `base_lr`, then constant."""

    def schedule(step: int) -> float:
        if warmup_steps and step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        return base_lr

    return schedule
