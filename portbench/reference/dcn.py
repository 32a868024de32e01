"""Plain DCN-v2 forward (Wang et al., arXiv:2008.13535), stacked structure
with low-rank cross layers, f32 from the benchmark's own leaves.

    x0      = [e_1, ..., e_T, dense]                  (B, T*D + num_dense)
    x_{l+1} = x0 * ((x_l V_l) U_l^T + b_l) + x_l      l = 0 .. L-1
    out     = head(relu-MLP_deep(x_L))

Leaves: `cross.<l>.u`, `cross.<l>.v` (F, r), `cross.<l>.b` (F,);
`deep.<i>.w` (fan_in, fan_out), `deep.<i>.b`; `head.w` (H, 1), `head.b`.
Nothing of the port is imported here.
"""
from __future__ import annotations

import torch

from .numerics import Precision


def width(cfg: dict) -> int:
    return len(cfg["vocab_sizes"]) * cfg["dim"] + cfg["num_dense"]


def leaf_shapes(cfg: dict) -> list:
    """[(name, shape)] of the tower leaves, in the order they are made."""
    f, r = width(cfg), cfg["cross_rank"]
    out = []
    for l in range(cfg["num_cross"]):
        out += [(f"cross.{l}.u", (f, r)), (f"cross.{l}.v", (f, r)),
                (f"cross.{l}.b", (f,))]
    sizes = [f] + list(cfg["deep_mlp"])
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out += [(f"deep.{i}.w", (a, b)), (f"deep.{i}.b", (b,))]
    out += [("head.w", (sizes[-1], 1)), ("head.b", (1,))]
    return out


def leaf_std(cfg: dict, name: str, shape) -> float | None:
    """The cross layers' init (the port's `init_dense_params`): U normal
    with std (1/r)^0.5, V with (1/F)^0.5; None (Glorot) elsewhere."""
    if name.startswith("cross.") and name.endswith(".u"):
        return (1.0 / cfg["cross_rank"]) ** 0.5
    if name.startswith("cross.") and name.endswith(".v"):
        return (1.0 / width(cfg)) ** 0.5
    return None


def logits(cfg: dict, leaves: dict, dense: torch.Tensor,
           emb_t: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B,) f32 logits from dense (B, num_dense) and the looked-up rows
    emb_t (T, B, D)."""
    b = emb_t.shape[1]
    x0 = torch.cat([emb_t.permute(1, 0, 2).reshape(b, -1), dense], dim=1)
    x = x0
    for l in range(cfg["num_cross"]):
        xv = prec.matmul(x, leaves[f"cross.{l}.v"])
        xw = prec.matmul(xv, leaves[f"cross.{l}.u"].T)
        x = x0 * (xw + leaves[f"cross.{l}.b"]) + x
    for i in range(len(cfg["deep_mlp"])):
        x = torch.relu(prec.matmul(x, leaves[f"deep.{i}.w"])
                       + leaves[f"deep.{i}.b"])
    return (prec.matmul(x, leaves["head.w"]) + leaves["head.b"])[:, 0]


def forward_flops(cfg: dict) -> int:
    """Forward FLOPs of one example: 2 x the multiply-adds of the cross
    layers' two low-rank products, the deep tower and the head."""
    macs = sum(s[0] * s[1] for n, s in leaf_shapes(cfg)
               if n.endswith((".w", ".u", ".v")))
    return 2 * macs
