"""The DLRM family in the port: the model built on the benchmark's weights
(on one card, or row-sharded over a mesh) and the training loop users call
(`models.train.train_dlrm`)."""
from __future__ import annotations

import torch

from portbench.reference import dlrm as reference
from portbench.weights import offsets


def port_config(cfg: dict):
    from embeddingtables_tpu_torch.models.dlrm import DLRMConfig
    return DLRMConfig(vocab_sizes=tuple(cfg["vocab_sizes"]),
                      num_dense=cfg["num_dense"], dim=cfg["dim"],
                      bottom_mlp=tuple(cfg["bottom_mlp"]),
                      top_mlp=tuple(cfg["top_mlp"]),
                      interaction=cfg["interaction"],
                      compute_dtype=getattr(torch, cfg["compute_dtype"]))


def _pairs(leaves: dict, tower: str) -> list:
    n = sum(1 for k in leaves if k.startswith(tower + ".")) // 2
    return [(leaves[f"{tower}.{i}.w"], leaves[f"{tower}.{i}.b"])
            for i in range(n)]


def port_model(pcfg, cfg: dict, tables: torch.Tensor, leaves: dict,
               sparse_opt, mesh=None):
    """The port's DLRM holding `tables` and `leaves` themselves; with a
    `mesh`, the `ShardedDLRM` whose shard of the table is `tables`."""
    offs = offsets(cfg["vocab_sizes"])
    bottom, top = _pairs(leaves, "bottom"), _pairs(leaves, "top")
    if mesh is not None:
        from embeddingtables_tpu_torch.parallel.dlrm import ShardedDLRM
        from embeddingtables_tpu_torch.parallel.sharded import \
            ShardedStackedTables
        st = ShardedStackedTables(tables, offs, offs[-1], cfg["dim"], "data",
                                  mesh)
        return ShardedDLRM(pcfg, bottom, top, st, sparse_opt.init(tables))
    from embeddingtables_tpu_torch.models.dlrm import DLRM
    from embeddingtables_tpu_torch.ops.ensemble import StackedTables
    return DLRM(pcfg, bottom, top, StackedTables(tables, offs, cfg["dim"]),
                sparse_opt.init(tables))


def tower_leaves(model) -> dict:
    """{reference leaf name: the model's parameter}."""
    out = {}
    for tower, pairs in (("bottom", model.bottom), ("top", model.top)):
        for i, (w, b) in enumerate(pairs):
            out[f"{tower}.{i}.w"], out[f"{tower}.{i}.b"] = w, b
    return out


def train(pcfg, model, batches, steps: int, *, sparse_opt, dense_lr: float,
          device_prefetch: int, log_every: int, mesh=None):
    """`steps` steps of `train_dlrm` over `batches` (global batches on a
    `mesh`, which trains the sharded model on the gather exchange)."""
    from embeddingtables_tpu_torch.models.train import train_dlrm
    return train_dlrm(pcfg, iter(batches), steps, model=model,
                      sparse_opt=sparse_opt, dense_lr=dense_lr,
                      device_prefetch=device_prefetch, log_every=log_every,
                      mesh=mesh, verbose=False)
