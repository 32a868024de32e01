"""torch.nn integration: embedding-table modules for stock torch models
(counterpart of `embeddingtables_tpu/nn.py`).

  - `Embed`: a dense-gradient table. `table` is an `nn.Parameter`; the
    lookup runs the port's gathers, and autograd gives the table the dense
    scatter-add gradient (`uncompress` of the lazy cotangent): the
    plain-matrix behaviour, for small tables or a stock optimizer that owns
    every parameter.
  - `SparseEmbed`: the lazy discipline in a stock torch loop. `table` is a
    buffer, out of autograd, so no table-sized gradient exists anywhere.
    Each call's looked-up rows are a leaf tensor that requires grad (the
    counterpart of JAX's `perturb` slot), and the module records the call's
    ids and effective combiner weights (JAX's `sow`). After
    `loss.backward()`, `sparse_updates_from_grads(model)` pairs each rows'
    gradient (the per-example delta) with its ids into a
    `SparseEmbeddingUpdate`, and `apply_sparse_updates` runs the fused
    optimizer step on each table in place: one write per unique row.

Training-loop shape (tests/test_torch_compat.py runs it):

    out = model(idx)                 # SparseEmbed modules inside
    loss_fn(out).backward()          # towers: p.grad; tables: nothing
    upds = sparse_updates_from_grads(model)
    _, states = apply_sparse_updates(model, upds, opt, states)
    torch_opt.step()                 # the towers

Pads follow `lookup`'s contract: an occurrence equal to `pad_idx` adds
nothing, is left out of a mean's denominator, and its update weight is 0.
A `SparseEmbed` records only calls made with autograd on; the calls of one
backward are merged into one update (`accumulate_updates`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .config import resolve_device
from .models.dlrm import uniform_rows
from .ops.lookup import effective_weights, lookup, lookup_vjp
from .ops.sparse_update import (SparseEmbeddingUpdate, accumulate_updates,
                                uncompress)


def _initial_table(vocab: int, dim: int, dtype, table, generator, device):
    """`table` copied to `device`, or rows uniform in
    `[-1/sqrt(dim), 1/sqrt(dim))` (JAX's `_default_init`)."""
    device = resolve_device(device)
    if table is not None:
        t = table if torch.is_tensor(table) else torch.from_numpy(
            np.array(table))
        t = t.to(device, dtype).clone()
        if tuple(t.shape) != (vocab, dim):
            raise ValueError(f"table must be ({vocab}, {dim}), got "
                             f"{tuple(t.shape)}")
        return t
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return uniform_rows(vocab, dim, dtype, generator, device)


class _DenseLookup(torch.autograd.Function):
    """`lookup` whose backward is the dense `(V, D)` gradient of the table:
    the lazy pullback's update, uncompressed."""

    @staticmethod
    def forward(ctx, table, indices, weights, combiner, pad_idx):
        out, pullback = lookup_vjp(table.detach(), indices, combiner=combiner,
                                   weights=weights, pad_idx=pad_idx)
        ctx.pullback, ctx.shape = pullback, table.shape
        ctx.dtype = table.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        dense = uncompress(ctx.pullback(grad), ctx.shape[0])
        return dense.to(ctx.dtype), None, None, None, None


class Embed(nn.Module):
    """Dense-gradient embedding table: ids `(B,)` or `(B, bag)` ->
    `(B, dim)`, combiner / weights / pad_idx as in `lookup`. `table`: the
    initial rows (copied), else `generator`'s uniform rows on `device`
    (CUDA unless given)."""

    def __init__(self, vocab: int, dim: int, combiner: str = "sum",
                 pad_idx: Optional[int] = None,
                 param_dtype: torch.dtype = torch.float32, *, table=None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.vocab, self.dim = vocab, dim
        self.combiner, self.pad_idx = combiner, pad_idx
        self.table = nn.Parameter(_initial_table(vocab, dim, param_dtype,
                                                 table, generator, device))

    def forward(self, indices, weights=None):
        return _DenseLookup.apply(self.table, indices, weights,
                                  self.combiner, self.pad_idx)


class SparseEmbed(nn.Module):
    """Lazy-gradient embedding table for stock torch loops (module
    docstring): the same arguments as `Embed`; `table` is a buffer."""

    def __init__(self, vocab: int, dim: int, combiner: str = "sum",
                 pad_idx: Optional[int] = None,
                 param_dtype: torch.dtype = torch.float32, *, table=None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.vocab, self.dim = vocab, dim
        self.combiner, self.pad_idx = combiner, pad_idx
        self.register_buffer("table", _initial_table(
            vocab, dim, param_dtype, table, generator, device))
        self.calls = []

    def forward(self, indices, weights=None):
        idx = torch.as_tensor(indices).to(self.table.device, torch.int32)
        with torch.no_grad():
            out = lookup(self.table, idx, combiner=self.combiner,
                         weights=weights, pad_idx=self.pad_idx)
        if not torch.is_grad_enabled():
            return out
        out.requires_grad_(True)
        self.calls.append((idx, effective_weights(
            idx, self.combiner, weights, self.pad_idx), out))
        return out


def sparse_updates_from_grads(module: nn.Module) -> dict:
    """`{name: SparseEmbeddingUpdate}` for every `SparseEmbed` in `module`
    (its name in `named_modules()`, "" for `module` itself) that was called
    since the last time: each call's rows' gradient as the delta, with the
    call's ids and effective weights. The recorded calls are consumed."""
    out = {}
    for name, m in module.named_modules():
        if not isinstance(m, SparseEmbed) or not m.calls:
            continue
        upds = []
        for idx, weights, rows in m.calls:
            if rows.grad is None:
                raise ValueError(f"SparseEmbed {name!r}: no gradient reached "
                                 "its lookup; call backward() first")
            upds.append(SparseEmbeddingUpdate(delta=rows.grad, indices=idx,
                                              weights=weights))
        m.calls = []
        out[name] = accumulate_updates(upds)
    return out


def apply_sparse_updates(module: nn.Module, updates: dict, opt,
                         states: Optional[dict] = None):
    """The fused sparse step of `opt` on every `SparseEmbed` that
    `updates` names, in place. `states` maps the same names to optimizer
    states (None, or a missing name: `opt.init` of the table). Returns
    `(module, states)`."""
    states = dict(states or {})
    modules = dict(module.named_modules())
    for name, upd in updates.items():
        m = modules[name]
        state = states.get(name)
        if state is None:
            state = opt.init(m.table)
        _, states[name] = opt.apply(m.table, upd, state)
    return module, states
