"""The benchmark's own initial weights, made on the device from the seed.

The stacked table is uniform in [-1, 1) / sqrt(D), in one call (a shard
in one call where it is sharded); every tower matrix is normal with its
family's standard deviation (Glorot unless the family's reference says
otherwise), and biases are zero. The same seed
gives the same bits, so the check makes them again for the reference once
the program's state is freed, and the reference takes nothing the program
made.
"""
from __future__ import annotations

import math

import torch

from .generate import generator


def offsets(vocab_sizes) -> list:
    out = [0]
    for v in vocab_sizes:
        out.append(out[-1] + int(v))
    return out


def table_bytes(cfg: dict) -> int:
    return offsets(cfg["vocab_sizes"])[-1] * cfg["dim"] * 4


def make_tables(cfg: dict, seed: int, device, rank: int = 0,
                world: int = 1) -> torch.Tensor:
    """The stacked table, or with `world` > 1 rank `rank`'s mod-row shard
    of it (global row r on rank r % world at slot r // world, padded to
    ceil(V / world) rows), each shard from a stream of its own, so the full
    table is never made."""
    rows, d = offsets(cfg["vocab_sizes"])[-1], cfg["dim"]
    if world > 1:
        rows, g = -(-rows // world), generator(device, seed, 100 + rank)
    else:
        g = generator(device, seed, 10)
    data = torch.empty((rows, d), dtype=torch.float32, device=device)
    return data.uniform_(-1.0, 1.0, generator=g).div_(math.sqrt(d))


def initial_rows(cfg: dict, seed: int, world: int, ids: torch.Tensor,
                 device) -> torch.Tensor:
    """The initial rows of the global stacked `ids`, made again from the
    seed: one shard at a time where the table is sharded."""
    if world == 1:
        return make_tables(cfg, seed, device)[ids].clone()
    out = torch.empty((ids.numel(), cfg["dim"]), device=device)
    for rank in range(world):
        mine = ids % world == rank
        out[mine] = make_tables(cfg, seed, device, rank, world)[
            ids[mine] // world]
    return out


def make_leaves(ref, cfg: dict, seed: int, device) -> dict:
    """{name: f32 tensor} of the tower leaves of the family reference
    `ref` (its `leaf_shapes`, and `leaf_std` where it has one)."""
    g = generator(device, seed, 11)
    std_of = getattr(ref, "leaf_std", None)
    out = {}
    for name, shape in ref.leaf_shapes(cfg):
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        std = (std_of(cfg, name, shape) if std_of is not None else None)
        if std is None:
            std = math.sqrt(2.0 / (shape[0] + shape[1]))
        out[name] = torch.randn(shape, generator=g, device=device).mul_(std)
    return out
