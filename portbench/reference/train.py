"""Plain training steps: the reference that a training cell's first steps
are held to.

One step: look up the rows, the family's plain forward, the mean binary
cross-entropy, autograd for the towers and the looked-up rows; the row
gradients summed per row; then the sparse optimizer on the rows and plain
SGD on the towers:

    sgd:              w_r -= lr * g_r
    rowwise_adagrad:  G_r += mean(g_r^2)
                      w_r -= lr * g_r / sqrt(max(G_r + eps, 1e-30))

The rows are a compact copy: the unique rows the checked batches touch, in
ascending order of their stacked id, with each batch's ids given as
positions in that copy. Nothing of the port is imported here.
"""
from __future__ import annotations

import torch

from .numerics import Precision


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def sq_by_table(row_sq: torch.Tensor, table_of_row: torch.Tensor,
                ntables: int) -> torch.Tensor:
    """(T,) f64 sums of the rows' squared norms `row_sq` by table."""
    out = torch.zeros(ntables, dtype=torch.float64, device=row_sq.device)
    return out.index_add_(0, table_of_row, row_sq.double())


def leaf_norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def table_norms(x, table_of_row, ntables) -> dict:
    """{table.<t>: L2 norm} of the rows of `x` (U, D) grouped by table."""
    sq = sq_by_table((x.double() ** 2).sum(dim=1), table_of_row, ntables)
    return {f"table.{t}": v for t, v in enumerate(sq.sqrt().tolist())}


def steps(model, cfg: dict, leaves0: dict, rows0: torch.Tensor,
          table_of_row: torch.Tensor, batches: list, sparse: dict,
          dense_lr: float, prec: Precision, half: bool = False) -> dict:
    """Run the reference over `batches` ({dense, pos (T, B) positions in
    the compact rows, label}); returns {"loss": [per step], "grad": {leaf:
    norm of step 1's gradient}, "change": {leaf: norm of the change after
    the last step}, "touched": rows whose state step 1 changed (their
    value under SGD, their accumulator under row-wise AdaGrad)}. Table
    leaves are `table.<t>`. `half` plants a fault:
    each step's loss leaves out the second half of its batch and takes the
    mean over the rest."""
    ntables = len(cfg["vocab_sizes"])
    leaves = {k: v.detach().clone().float() for k, v in leaves0.items()}
    rows = prec.table(rows0.detach().clone().float())
    accum = torch.zeros(rows.shape[0], device=rows.device)
    d = rows.shape[1]
    out = {"loss": []}
    for k, b in enumerate(batches):
        names = list(leaves)
        params = [leaves[n].requires_grad_(True) for n in names]
        pos, dense, label = b["pos"], b["dense"], b["label"]
        if half:
            n = label.shape[0] // 2
            pos, dense, label = pos[:, :n], dense[:n], label[:n]
        emb = rows[pos].requires_grad_(True)
        loss = bce(model.logits(cfg, leaves, dense, emb, prec), label)
        *gw, gemb = torch.autograd.grad(loss, params + [emb])
        g = torch.zeros_like(rows).index_add_(0, pos.reshape(-1),
                                              gemb.reshape(-1, d))
        out["loss"].append(float(loss.detach()))
        if k == 0:
            out["grad"] = {**leaf_norms(dict(zip(names, gw))),
                           **table_norms(g, table_of_row, ntables)}
        with torch.no_grad():
            lr, old = float(sparse["lr"]), rows
            if sparse["name"] == "sgd":
                rows = rows - lr * g
            elif sparse["name"] == "rowwise_adagrad":
                accum += torch.mean(g * g, dim=1)
                den = torch.rsqrt(torch.clamp_min(accum + float(sparse["eps"]),
                                                  1e-30))
                rows = rows - lr * g * den[:, None]
            else:
                raise ValueError(sparse["name"])
            rows = prec.table(rows)
            if k == 0:
                out["touched"] = int((accum > 0).sum()) \
                    if sparse["name"] == "rowwise_adagrad" \
                    else int((rows != old).any(dim=1).sum())
            leaves = {n: (leaves[n] - dense_lr * gn).detach()
                      for n, gn in zip(names, gw)}
    with torch.no_grad():
        out["change"] = {
            **leaf_norms({n: leaves[n] - leaves0[n].float() for n in leaves}),
            **table_norms(rows - rows0.float(), table_of_row, ntables)}
    return out
