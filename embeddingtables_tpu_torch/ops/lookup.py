"""Forward lookup: non-reducing and sum-reducing (multi-hot) embedding gather
(counterpart of `embeddingtables_tpu/ops/lookup.py`).

Semantics:
  non-reducing: ids of shape `(B,)`      -> `O[i, :] = A[I[i], :]`
  reducing:     ids of shape `(B, bag)`  -> `O[i, :] = sum_k A[I[i, k], :]`

Dispatch is by the table's device (`ops/cuda/gather.py`): on a CUDA tensor the
hand-written kernels, on a CPU tensor their plain versions. 1-D ids go to
`gather_rows`, 2-D ids with a plain sum to `gather_bags`; weighted, mean and
padded bags gather their rows with `gather_rows` over the flattened ids and
reduce them in `_combine`. Ids follow the JAX lookup's contract: `[-V, 0)`
wraps, any other out-of-range id gives NaN.
"""
from __future__ import annotations

import torch

from ..tables import SimpleEmbedding, is_table
from ..types import Forward
from .cuda.gather import gather_bags, gather_rows


def _ids(indices, device) -> torch.Tensor:
    return torch.as_tensor(indices).to(device=device,
                                       dtype=torch.int32).contiguous()


def _weights(weights, device):
    """Weights on `device`; float64 narrows to float32, as in the JAX package."""
    if weights is None:
        return None
    w = torch.as_tensor(weights).to(device)
    return w.float() if w.dtype == torch.float64 else w


def lookup_oracle(data: torch.Tensor, indices, combiner: str = "sum",
                  weights=None, pad_idx: int | None = None) -> torch.Tensor:
    """Naive dense implementation on a raw `(vocab, dim)` tensor: the test
    oracle. Occurrences equal to `pad_idx` are absent: they contribute a
    zero row and are excluded from the mean denominator. Plain indexing:
    out-of-range ids raise here."""
    indices = torch.as_tensor(indices).to(data.device).long()
    weights = _weights(weights, data.device)
    if pad_idx is not None:
        valid = indices != pad_idx
        safe = torch.where(valid, indices, 0)
        if indices.dim() == 1:
            out = data[safe, :] * valid[:, None].to(data.dtype)
            if weights is not None:
                out = out * weights.reshape(-1, 1).to(out.dtype)
            return out
        w = valid.float()
        if weights is not None:
            w = w * weights.float()
        rows = data[safe, :] * w[..., None].to(data.dtype)
        out = rows.sum(dim=1)
        if combiner == "mean":
            denom = w.sum(dim=1, keepdim=True)
            out = out / denom.clamp_min(1e-12).to(out.dtype)
        return out
    if indices.dim() == 1:
        out = data[indices, :]
        if weights is not None:
            out = out * weights.reshape(-1, 1).to(out.dtype)
        return out
    if indices.dim() == 2:
        rows = data[indices, :]
        if weights is not None:
            rows = rows * weights[..., None]
        out = rows.sum(dim=1)
        if combiner == "mean":
            denom = (weights.sum(dim=1, keepdim=True)
                     if weights is not None else indices.shape[1])
            out = out / denom
        return out
    raise ValueError(f"indices must be 1-D or 2-D, got shape {tuple(indices.shape)}")


def _lookup_dispatch(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    if indices.dim() == 1:
        return gather_rows(data, indices)
    return gather_bags(data, indices)


def _bag_rows(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """`(B, bag)` ids -> `(B, bag, D)` rows, one `gather_rows` launch."""
    rows = gather_rows(data, indices.reshape(-1))
    return rows.reshape(*indices.shape, data.shape[1])


def _combine(rows: torch.Tensor, indices: torch.Tensor, combiner: str,
             weights) -> torch.Tensor:
    """Reduce `(B, bag, D)` bag rows per the combiner/weights."""
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    out = rows.sum(dim=1)
    if combiner == "mean":
        if weights is not None:
            denom = weights.sum(dim=1, keepdim=True)
            out = out / denom.clamp_min(1e-12).to(out.dtype)
        else:
            out = out / indices.shape[1]
    return out


def lookup(table, indices, context=None, *, combiner: str = "sum",
           weights=None, pad_idx: int | None = None) -> torch.Tensor:
    """Embedding lookup on a `SimpleEmbedding`, any object with the table
    protocol (`spec`, `rows(idx, context=...)`, `example`), or a raw
    `(vocab, dim)` tensor. Ids may be a tensor or array of any integer type
    (they are taken as int32, as the JAX package takes them) and are moved to
    the table's device.

    `(B,)` ids -> non-reducing; `(B, bag)` ids -> bag-reducing. Returns
    `(B, dim)`. combiner: "sum" or "mean"; weights: optional per-occurrence
    weights (a `(B,)` output scale on non-reducing ids). pad_idx: occurrences
    equal to it are absent (zero contribution, excluded from the mean
    denominator); any int works, including -1 or `vocab`, because pads are
    remapped to row 0 before the gather and masked after it. An all-pad bag
    yields a zero row.
    """
    context = Forward if context is None else context
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    if isinstance(table, SimpleEmbedding) or not is_table(table):
        data = table.data if isinstance(table, SimpleEmbedding) \
            else torch.as_tensor(table)
        device = data.device
    else:
        data, device = None, table.example().device
    indices = _ids(indices, device)
    weights = _weights(weights, device)
    if indices.dim() not in (1, 2):
        raise ValueError(f"indices must be 1-D or 2-D, got shape {tuple(indices.shape)}")
    if pad_idx is not None:
        valid = indices != pad_idx
        safe = torch.where(valid, indices, 0)
        if indices.dim() == 1:
            rows = lookup(table, safe, context, weights=weights)
            return rows * valid[:, None].to(rows.dtype)
        w = valid.float()
        if weights is not None:
            w = w * weights.float()
        return lookup(table, safe, context, combiner=combiner, weights=w)
    if indices.dim() == 1:
        # No bag to reduce: combiner is a no-op and weights scale rows.
        out = _lookup_dispatch(data, indices) if data is not None \
            else table.rows(indices, context=context)
        if weights is not None:
            out = out * weights.reshape(-1, 1).to(out.dtype)
        return out
    if data is None:
        return _combine(table.rows(indices, context=context), indices,
                        combiner, weights)
    if combiner == "sum" and weights is None:
        return _lookup_dispatch(data, indices)
    return _combine(_bag_rows(data, indices), indices, combiner, weights)
