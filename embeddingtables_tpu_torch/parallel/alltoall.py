"""The all-to-all "butterfly" exchange (counterpart of
`embeddingtables_tpu/parallel/alltoall.py`).

The gather exchange (`sharded.py`) moves the whole batch's partial rows:
each rank reduce-scatters `(B, T, D)` in which it contributed only the 1/n
it owns. The butterfly moves only real rows:

  1. bucket this rank's occurrences by owner (`owner = row % n`), each in
     stream order;
  2. `all_to_all_single` the buckets' local slots (small);
  3. owners gather their rows with `gather_rows`;
  4. `all_to_all_single` the rows back (about `B_local x D` per rank);
  5. scatter them to their stream positions (then the bag sum).

Capacity: buckets hold `C = ceil(cdiv(m, n) * capacity_factor)` slots for m
occurrences. An occurrence ranked past C in its owner's bucket (ranks are
stable, in stream order) is dropped from the exchange: its lookup reads a
zero row and its update is lost. Pads use no capacity and are not counted.
Every entry returns the `overflow` count of dropped occurrences, summed over
every rank of the placement (so each rank holds the same value), as JAX
returns its global sum.

`wire_dtype` (e.g. `torch.bfloat16`) casts only the row payloads on the
wire: one rounding of each looked-up element or delta element; the slots
stay int32.

On a 2-D mesh the batch is sharded over `data` and replicated over `model`:
each model column routes a disjoint 1/n_model slice of its data block's
stream over the flattened axes, and the looked-up rows are all-gathered over
`model` to reassemble the block.

The updates route the occurrences to their owners (`_route_update_stream`),
then the owner's sparse optimizer `apply`s the received occurrences (the
empty slots left out, which reads their count on the host) to its shard:
`sharded_update_a2a` takes any of the four sparse optimizers, in place of
JAX's four butterfly updates.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ops.cuda.gather import gather_rows
from ..ops.sparse_update import SparseEmbeddingUpdate
from ..types import cdiv
from .sharded import ShardedStackedTables, _fold_combiner


def suggest_capacity_factor(current: float, overflow_fraction: float,
                            target: float = 0.0, headroom: float = 1.5
                            ) -> float:
    """The capacity factor to rebuild the step at: raised by the observed
    overflow plus headroom when drops exceed `target`, else unchanged."""
    if overflow_fraction <= target:
        return current
    return current * (1.0 + overflow_fraction) * headroom


class CapacityAutoTuner:
    """Feedback controller around `suggest_capacity_factor`: `observe` takes
    one step's overflow count and returns the factor to rebuild the step at
    when the drop fraction exceeds `target` (at most once every `cooldown`
    observations, capped at `max_factor`), else None."""

    def __init__(self, initial: float, occurrences_per_step: int, *,
                 target: float = 0.0, headroom: float = 1.5,
                 cooldown: int = 5, max_factor: float = 64.0):
        if occurrences_per_step <= 0:
            raise ValueError("occurrences_per_step must be positive")
        self.factor = float(initial)
        self.occ = int(occurrences_per_step)
        self.target = target
        self.headroom = headroom
        self.cooldown = cooldown
        self.max_factor = max_factor
        self.retunes = 0
        self._since = cooldown    # allow an immediate first retune

    def observe(self, overflow: int):
        self._since += 1
        frac = overflow / self.occ
        if frac <= self.target or self._since <= self.cooldown:
            return None
        new = min(suggest_capacity_factor(self.factor, frac, self.target,
                                          self.headroom), self.max_factor)
        if new <= self.factor:
            return None
        self.factor = new
        self.retunes += 1
        self._since = 0
        return new


def capacity(m: int, n: int, capacity_factor: float) -> int:
    """Slots per owner bucket for m occurrences over n owners."""
    return max(1, int(-(-cdiv(m, n) * capacity_factor // 1)))


def _bucket_by_owner(flat: torch.Tensor, n: int, cap: int, valid=None):
    """Route a stream of global ids into per-owner buckets.

    flat: `(m,)` ids; valid: optional `(m,)` bool, False for pads, which
    take no rank and are not counted. Returns `send_slot` `(n, cap)` int32
    local slots (`row // n`, -1 where empty), `send_pos` `(n, cap)` int64
    stream positions (-1 where empty) and `overflow`, the 0-d count of
    occurrences ranked past `cap`."""
    m, dev = flat.numel(), flat.device
    owner = torch.remainder(flat.long(), n)
    if valid is not None:
        owner = torch.where(valid, owner, n)      # pads: a trailing bucket
    sowner, order = torch.sort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n + 1)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=dev)
    rank = torch.empty_like(pos).scatter_(0, order, pos - start[sowner])
    ok = rank < cap
    if valid is not None:
        ok = ok & valid
        overflow = (~ok & valid).sum()
    else:
        overflow = (~ok).sum()
    dest = torch.where(ok, owner * cap + rank, n * cap)   # n*cap: dropped
    slot = torch.div(flat.long(), n, rounding_mode="floor")
    send_slot = torch.full((n * cap + 1,), -1, dtype=torch.int64, device=dev)
    send_slot.scatter_(0, dest, slot)
    send_pos = torch.full((n * cap + 1,), -1, dtype=torch.int64, device=dev)
    send_pos.scatter_(0, dest, pos)
    return (send_slot[:-1].to(torch.int32).view(n, cap),
            send_pos[:-1].view(n, cap), overflow)


def _column_slice(ex, *streams):
    """On a 2-D mesh, this model column's disjoint 1/n_model share of the
    (model-replicated) streams."""
    m_all = streams[0].shape[0]
    if ex.n_model == 1:
        return streams + (m_all,)
    if m_all % ex.n_model:
        raise ValueError(f"{m_all} local occurrences do not divide the "
                         f"model axis of {ex.n_model}")
    sub = m_all // ex.n_model
    col = ex.model_index
    return tuple(s[col * sub:(col + 1) * sub] for s in streams) + (sub,)


def _total(ex, overflow: torch.Tensor) -> torch.Tensor:
    """The overflow summed over every rank of the placement."""
    overflow = overflow.to(torch.int64).reshape(1)
    with ex.timed("all_reduce"):
        dist.all_reduce(overflow, group=ex.group)
    return overflow.reshape(())


def sharded_lookup_a2a(mesh, st: ShardedStackedTables, idx, *,
                       capacity_factor: float = 2.0,
                       reducing: bool | None = None, combiner: str = "sum",
                       weights=None, pad_idx: int | None = None,
                       wire_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Butterfly lookup. `idx`: this rank's block `(b,)` or `(b, k)` of
    global stacked ids. Returns `(out, overflow)`: `(b, D)` (or `(b, k, D)`
    with `reducing=False`, e.g. an ensemble's `(b, T)` stream); occurrences
    dropped by capacity read zero rows. `pad_idx` is a global sentinel
    (e.g. -1): pads drop at routing and read zero; combiner / weights fold
    into a scale applied before the bag sum."""
    ex = st.exchange
    if len(ex.axes) > 2:
        raise NotImplementedError("the butterfly takes one or two mesh axes")
    idx = torch.as_tensor(idx).to(st.data.device, torch.int32)
    if reducing is None:
        reducing = idx.dim() == 2
    dim, n = st.dim, ex.n
    scale = None
    if weights is not None or combiner != "sum":
        _, scale = _fold_combiner(idx, combiner, weights, pad_idx)
    flat, sub = _column_slice(ex, idx.reshape(-1))
    cap = capacity(sub, n, capacity_factor)
    valid = None if pad_idx is None else flat != pad_idx
    send_slot, send_pos, overflow = _bucket_by_owner(flat, n, cap, valid)
    recv_slot = ex.all_to_all(send_slot).reshape(-1)
    rows = gather_rows(st.data, torch.clamp_min(recv_slot, 0).contiguous())
    rows = torch.where((recv_slot >= 0)[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    if wire_dtype is not None:
        rows = rows.to(wire_dtype)
    back = ex.all_to_all(rows.view(n, cap, dim)).reshape(-1, dim)
    back = back.to(st.data.dtype)
    pos = send_pos.reshape(-1)
    part = torch.zeros((sub + 1, dim), dtype=back.dtype, device=back.device)
    part.index_copy_(0, torch.where(pos >= 0, pos, sub), back)
    part = part[:sub]
    if ex.n_model > 1:
        out = torch.empty((sub * ex.n_model, dim), dtype=part.dtype,
                          device=part.device)
        with ex.timed("all_gather"):
            dist.all_gather_into_tensor(out, part.contiguous(),
                                        group=ex.model_groups[0])
    else:
        out = part
    out = out.reshape(tuple(idx.shape) + (dim,))
    if scale is not None:
        out = out * scale[..., None].to(out.dtype)
    if reducing:
        out = out.sum(dim=1)
    return out, _total(ex, overflow)


def _route_update_stream(st: ShardedStackedTables, upd: SparseEmbeddingUpdate,
                         *, capacity_factor: float, pad_idx, wire_dtype):
    """The shard-local half of every butterfly update: slice the stream on
    a 2-D mesh, bucket it by owner, and all-to-all the `(slot, delta row)`
    buckets. Returns `(lrow, vals, overflow)`: the received occurrences'
    int32 local slots (`rows_local` where empty: out of range, dropped),
    their f32 `(n*cap, D)` values (weights folded in) and the summed
    overflow."""
    ex = st.exchange
    if len(ex.axes) > 2:
        raise NotImplementedError("the butterfly takes one or two mesh axes")
    dim, n = st.dim, ex.n
    idx = torch.as_tensor(upd.indices).to(st.data.device, torch.int32)
    vals = upd.delta.float()
    if idx.dim() == 2:
        vals = torch.repeat_interleave(vals, idx.shape[1], dim=0)
    if upd.weights is not None:
        vals = vals * upd.weights.reshape(-1, 1).float()
    flat, vals, sub = _column_slice(ex, idx.reshape(-1), vals)
    cap = capacity(sub, n, capacity_factor)
    valid = None if pad_idx is None else flat != pad_idx
    send_slot, send_pos, overflow = _bucket_by_owner(flat, n, cap, valid)
    pos = send_pos.reshape(-1)
    staged = gather_rows(vals.contiguous(),
                         torch.clamp_min(pos, 0).to(torch.int32).contiguous())
    staged = torch.where((pos >= 0)[:, None], staged,
                         torch.zeros((), dtype=staged.dtype,
                                     device=staged.device))
    if wire_dtype is not None:
        staged = staged.to(wire_dtype)
    recv_slot = ex.all_to_all(send_slot).reshape(-1)
    recv_vals = ex.all_to_all(staged.view(n, cap, dim)).reshape(-1, dim)
    lrow = torch.where(recv_slot >= 0, recv_slot, st.rows_local)
    return lrow.to(torch.int32), recv_vals.float(), _total(ex, overflow)


def sharded_update_a2a(mesh, st: ShardedStackedTables, state,
                       upd: SparseEmbeddingUpdate, sparse_opt, *,
                       capacity_factor: float = 2.0,
                       pad_idx: int | None = None, wire_dtype=None, lr=None,
                       generator=None):
    """Route `upd` (this rank's block of a lazy update of global ids) to
    the owners, which apply it to their shard with `sparse_opt.apply`, in
    place. Returns `(state, overflow)`."""
    lrow, vals, overflow = _route_update_stream(
        st, upd, capacity_factor=capacity_factor, pad_idx=pad_idx,
        wire_dtype=wire_dtype)
    # The received occurrences, in order, without the empty slots: the
    # optimizer sees the stream the gather exchange would give it.
    keep = (lrow < st.rows_local).nonzero().squeeze(1)
    kw = {} if generator is None else {"generator": generator}
    _, state = sparse_opt.apply(
        st.data, SparseEmbeddingUpdate(delta=vals.index_select(0, keep),
                                       indices=lrow.index_select(0, keep)),
        state, lr=lr, **kw)
    return state, overflow


def sharded_sgd_update_a2a(mesh, st: ShardedStackedTables,
                           upd: SparseEmbeddingUpdate, lr, *,
                           capacity_factor: float = 2.0,
                           weight_decay: float = 0.0, clipnorm=None,
                           pad_idx: int | None = None, wire_dtype=None,
                           generator=None, grad_dtype=None):
    """SGD through the butterfly (`sharded_update_a2a`), in place:
    `(st, overflow)`."""
    from ..optim import SparseSGD
    opt = SparseSGD(lr, weight_decay=weight_decay, clipnorm=clipnorm,
                    stochastic_rounding=generator is not None,
                    dense_grad_dtype=grad_dtype)
    _, overflow = sharded_update_a2a(
        mesh, st, opt.init(st.data), upd, opt,
        capacity_factor=capacity_factor, pad_idx=pad_idx,
        wire_dtype=wire_dtype, generator=generator)
    return st, overflow


def sharded_adagrad_update_a2a(mesh, st: ShardedStackedTables, accum,
                               upd: SparseEmbeddingUpdate, opt, *,
                               capacity_factor: float = 2.0,
                               pad_idx: int | None = None, wire_dtype=None,
                               lr=None, generator=None):
    """Row-wise AdaGrad through the butterfly, in place:
    `(st, accum, overflow)`."""
    from ..optim import SparseOptState
    state, overflow = sharded_update_a2a(
        mesh, st, SparseOptState(accum=accum), upd, opt,
        capacity_factor=capacity_factor, pad_idx=pad_idx,
        wire_dtype=wire_dtype, lr=lr, generator=generator)
    return st, state.accum, overflow


def sharded_adam_update_a2a(mesh, st: ShardedStackedTables, m, v, count,
                            upd: SparseEmbeddingUpdate, opt, *,
                            capacity_factor: float = 2.0,
                            pad_idx: int | None = None, wire_dtype=None,
                            lr=None, generator=None):
    """Lazy Adam through the butterfly, in place:
    `(st, m, v, count, overflow)`."""
    from ..optim import SparseAdamState
    state, overflow = sharded_update_a2a(
        mesh, st, SparseAdamState(m=m, v=v, count=count), upd, opt,
        capacity_factor=capacity_factor, pad_idx=pad_idx,
        wire_dtype=wire_dtype, lr=lr, generator=generator)
    return st, state.m, state.v, state.count, overflow


def sharded_ftrl_update_a2a(mesh, st: ShardedStackedTables, z, n_state,
                            upd: SparseEmbeddingUpdate, opt, *,
                            capacity_factor: float = 2.0,
                            pad_idx: int | None = None, wire_dtype=None):
    """FTRL through the butterfly, in place: `(st, z, n, overflow)`."""
    from ..optim import SparseFTRLState
    state, overflow = sharded_update_a2a(
        mesh, st, SparseFTRLState(z=z, n=n_state), upd, opt,
        capacity_factor=capacity_factor, pad_idx=pad_idx,
        wire_dtype=wire_dtype)
    return st, state.z, state.n, overflow
