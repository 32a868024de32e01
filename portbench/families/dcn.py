"""The DCN-v2 family in the port: the model built on the benchmark's
weights and the training loop users call (`models.train.train_dcn`)."""
from __future__ import annotations

import torch

from portbench.reference import dcn as reference
from portbench.weights import offsets


def port_config(cfg: dict):
    from embeddingtables_tpu_torch.models.dcn import DCNConfig
    return DCNConfig(vocab_sizes=tuple(cfg["vocab_sizes"]),
                     num_dense=cfg["num_dense"], dim=cfg["dim"],
                     num_cross=cfg["num_cross"], cross_rank=cfg["cross_rank"],
                     deep_mlp=tuple(cfg["deep_mlp"]),
                     structure=cfg["structure"],
                     compute_dtype=getattr(torch, cfg["compute_dtype"]))


def port_model(pcfg, cfg: dict, tables: torch.Tensor, leaves: dict,
               sparse_opt, mesh=None):
    """The port's DCN holding `tables` and `leaves` themselves (one card:
    no DCN cell places it on a mesh yet)."""
    if mesh is not None:
        raise NotImplementedError("the DCN family runs on one card here")
    from embeddingtables_tpu_torch.models.dcn import DCN
    from embeddingtables_tpu_torch.ops.ensemble import StackedTables
    st = StackedTables(tables, offsets(cfg["vocab_sizes"]), cfg["dim"])
    cross = [(leaves[f"cross.{l}.u"], leaves[f"cross.{l}.v"],
              leaves[f"cross.{l}.b"]) for l in range(cfg["num_cross"])]
    deep = [(leaves[f"deep.{i}.w"], leaves[f"deep.{i}.b"])
            for i in range(len(cfg["deep_mlp"]))]
    return DCN(pcfg, cross, deep, (leaves["head.w"], leaves["head.b"]), st,
               sparse_opt.init(tables))


def tower_leaves(model) -> dict:
    """{reference leaf name: the model's parameter}."""
    out = {}
    for l, (u, v, b) in enumerate(model.cross):
        out[f"cross.{l}.u"], out[f"cross.{l}.v"], out[f"cross.{l}.b"] = u, v, b
    for i, (w, b) in enumerate(model.deep):
        out[f"deep.{i}.w"], out[f"deep.{i}.b"] = w, b
    out["head.w"], out["head.b"] = model.head
    return out


def train(pcfg, model, batches, steps: int, *, sparse_opt, dense_lr: float,
          device_prefetch: int, log_every: int, mesh=None):
    from embeddingtables_tpu_torch.models.train import train_dcn
    return train_dcn(pcfg, iter(batches), steps, model=model,
                     sparse_opt=sparse_opt, dense_lr=dense_lr,
                     device_prefetch=device_prefetch, log_every=log_every,
                     verbose=False)
