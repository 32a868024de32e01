"""Plain DLRM forward (Naumov et al., arXiv:1906.00091; the MLPerf DLRM
reference's `dot` interaction), f32 from the benchmark's own leaves.

    x   = relu-MLP_bottom(dense)                      (B, D)
    Z   = [x; e_1; ...; e_T]                          (B, T+1, D)
    f   = [x, (Z Z^T)[i, j] for i > j, row-major]     (B, D + (T+1)T/2)
    out = MLP_top(f), relu on every layer but the last

Leaves: `bottom.<i>.w` (fan_in, fan_out), `bottom.<i>.b`, the same for
`top.<i>`. Nothing of the port is imported here.
"""
from __future__ import annotations

import torch

from .numerics import Precision


def leaf_shapes(cfg: dict) -> list:
    """[(name, shape)] of the tower leaves, in the order they are made."""
    out = []
    bottom = [cfg["num_dense"]] + list(cfg["bottom_mlp"])
    t1 = len(cfg["vocab_sizes"]) + 1
    top = [cfg["dim"] + t1 * (t1 - 1) // 2] + list(cfg["top_mlp"])
    for tower, sizes in (("bottom", bottom), ("top", top)):
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out += [(f"{tower}.{i}.w", (a, b)), (f"{tower}.{i}.b", (b,))]
    return out


def _mlp(leaves, tower: str, x, prec: Precision, last_relu: bool):
    n = sum(1 for k in leaves if k.startswith(tower + ".")) // 2
    for i in range(n):
        x = prec.matmul(x, leaves[f"{tower}.{i}.w"]) + leaves[f"{tower}.{i}.b"]
        if i < n - 1 or last_relu:
            x = torch.relu(x)
    return x


def logits(cfg: dict, leaves: dict, dense: torch.Tensor,
           emb_t: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B,) f32 logits from dense (B, num_dense) and the looked-up rows
    emb_t (T, B, D)."""
    x = _mlp(leaves, "bottom", dense, prec, last_relu=True)
    z = torch.cat([x[:, None, :], emb_t.permute(1, 0, 2)], dim=1)
    gram = prec.matmul(z, z.transpose(1, 2))
    t1 = z.shape[1]
    li, lj = torch.tril_indices(t1, t1, offset=-1, device=z.device)
    feat = torch.cat([x, gram[:, li, lj]], dim=1)
    return _mlp(leaves, "top", feat, prec, last_relu=False)[:, 0]


def forward_flops(cfg: dict) -> int:
    """Forward FLOPs of one example: 2 x the multiply-adds of every tower
    layer and of the (T+1)T/2 pair dots of width D."""
    macs = sum(s[0] * s[1] for n, s in leaf_shapes(cfg) if n.endswith(".w"))
    t1 = len(cfg["vocab_sizes"]) + 1
    macs += t1 * (t1 - 1) // 2 * cfg["dim"]
    return 2 * macs
