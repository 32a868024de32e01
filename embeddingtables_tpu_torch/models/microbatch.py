"""Gradient accumulation over slices of the batch (counterpart of
`embeddingtables_tpu/models/microbatch.py`).

A family's `microbatch=k` step takes its loss and gradients over k equal
slices of the batch, one after the other: each slice runs its own lookup,
its forward and its backward, and its autograd graph is freed before the
next slice starts, so only B/k examples' activations are live at once. The
dense gradients are summed and averaged; each slice's lazy embedding delta
is written into its columns of one `(T, B, D)` buffer, so the sparse
optimizer still makes ONE application over the whole batch.

The math does not depend on the grouping (pointwise BCE, the mean of the
slice means, a 1/B scale per example), so any slicing gives the monolithic
step up to float re-association.
"""
from __future__ import annotations

import torch


def microbatch_grads(params, dense, cat, label, k: int, slice_grads):
    """Run `slice_grads` over k slices of the batch axis and reassemble.

    `slice_grads(dense_i, cat_i, label_i) -> (loss_i, dense_grads_i,
    deltas_i)`, with `deltas_i` a tuple of `(T, mb, D_x)` lazy deltas, one
    per stacked ensemble (DLRM and DCN pass one, the unfolded DeepFM two).
    `dense` is `(B, num_dense)`, `cat` `(T, B[, bag])` and `label` `(B,)`.

    Returns `(loss, dense_grads, deltas)`: the mean of the slice losses,
    the dense gradients summed from zeros in slice order and divided by k
    (the full batch's mean-loss gradient), and each delta as one
    `(T, B, D_x)` f32 tensor divided by k. A batch that k does not divide
    raises `ValueError`, before any slice runs."""
    b = dense.shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by microbatch {k}")
    mb = b // k
    dense_sum = [torch.zeros_like(p) for p in params]
    losses, full = [], None
    for i in range(k):
        cols = slice(i * mb, (i + 1) * mb)
        loss_i, dg_i, deltas_i = slice_grads(dense[cols], cat[:, cols],
                                             label[cols])
        for acc, g in zip(dense_sum, dg_i):
            acc.add_(g)
        if full is None:
            full = [torch.empty((d.shape[0], b, d.shape[2]),
                                dtype=torch.float32, device=d.device)
                    for d in deltas_i]
        for f, d in zip(full, deltas_i):
            f[:, cols] = d
        losses.append(loss_i)
        del dg_i, deltas_i
    for f in full:
        f.div_(k)
    return (torch.stack(losses).mean(), [g / k for g in dense_sum],
            tuple(full))
