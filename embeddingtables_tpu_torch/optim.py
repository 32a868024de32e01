"""Sparse optimizers: fused, dedup-correct row updates for embedding tables
(counterpart of `embeddingtables_tpu/optim.py`).

`SparseSGD` and `SparseRowWiseAdaGrad` (one f32 accumulator per row) apply a
lazy `SparseEmbeddingUpdate` to a `(V, D)` table. Each unique row is written
once and its state advanced once per step. Two realizations, chosen as the
JAX package chooses them, so both packages take the same branch for the same
call:

  - the run-scatter (`ops/cuda/scatter.py`): SGD without regularization, and
    AdaGrad's "indexer" method. Ids follow JAX's `.at[]` contract: `[-V, 0)`
    wraps, other out-of-range ids are dropped.
  - the dense realization (`sgd_dense_body`, `adagrad_dense_body`): a `(V, D)`
    f32 gradient from `_dense_grad`, then one elementwise pass. It carries
    `weight_decay`, `clipnorm`, stochastic rounding and `dense_grad_dtype`,
    and takes tables of at most `_SEGSUM_MAX_VPAD` padded rows through
    `hot_accumulate`.

`apply` updates the table (and AdaGrad's accumulator) in place and returns
them: the port's counterpart of JAX's donated buffers. Where JAX's `apply`
takes a PRNG `key=` for stochastic rounding, the port takes a
`torch.Generator` as `generator=`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from .ops.cuda.scatter import scatter_update
from .ops.cuda.segsum import hot_accumulate
from .ops.sparse_update import (SparseEmbeddingUpdate, dense_scatter,
                                occurrence_values, resolve_rows)
from .rounding import stochastic_cast


class SparseOptState(NamedTuple):
    """Per-table optimizer state: `accum` is `(vocab,)` f32 for row-wise
    AdaGrad, or a zero-size placeholder for stateless SGD."""

    accum: torch.Tensor


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
                   grad_dtype=None) -> torch.Tensor:
    """`data[r] -= lr * clip(sum g_r)` with lazy decay on touched rows,
    written into `data` in place. With `generator` and a bf16 table the one
    cast back to storage rounds stochastically; untouched rows stay exact."""
    grad = _clip_rows(_dense_grad(data, rows, g, grad_dtype), clipnorm)
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
                       grad_dtype=None):
    """Row-wise AdaGrad through the dense gradient, in place: returns
    `(data, accum)`. Untouched rows are exact fixed points, at eps = 0 too
    (the 1e-30 clamp keeps rsqrt finite)."""
    grad = _clip_rows(_dense_grad(data, rows, g, grad_dtype), clipnorm)
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


@torch.no_grad()
def apply_dense_tx(params, grads, dense_tx, state, lr):
    """Tower update: plain SGD `p -= lr * g` in place when `dense_tx` is
    None. Returns `(params, state)`."""
    if dense_tx is not None:
        raise NotImplementedError(
            "dense_tx waits for the port's torch.optim support")
    for p, g in zip(params, grads):
        p.copy_((p - lr * g).to(p.dtype))
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
        """One step, in place; returns `(data, state)`."""
        if idx_result is not None:
            raise NotImplementedError(
                "idx_result= waits for the port's ops/indexer.py")
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
        scatter_update(data, resolve_rows(rows, data.shape[0]), g.float(),
                       -float(lr), accum=state.accum, eps=self.eps)
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
