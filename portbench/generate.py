"""The one traffic generator: every mix in `traffic/` is parameters of it.

Ids follow the rule of the port's `data.SyntheticCriteo`: per table, rank r
is drawn with probability proportional to r^-a, then mapped to a row by one
seeded random permutation of the table's rows, so the hot rows are spread
over the table. The draw is an inverse CDF on the device (the alias tables
of `SyntheticCriteo` take a Python loop over the vocabulary, minutes at
10M rows). Labels come from a hidden model: a linear term of the dense
features plus a per-row logit that an integer hash of (table, row, seed)
gives, so no table-sized array is made for it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_HASH_MUL = 2654435761
_HASH_TABLE = 97531


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on `device` for one named stream of `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def zipf_ids(gen: torch.Generator, vocab: int, n: int, a: float,
             device) -> torch.Tensor:
    """(n,) int32 ids over `vocab` rows, Zipf(a) by rank through a random
    rank -> row permutation."""
    if vocab == 1:
        return torch.zeros(n, dtype=torch.int32, device=device)
    cdf = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(cdf.pow_(-a), 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(vocab, generator=gen, device=device)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp_max_(vocab - 1)
    return perm[rank].to(torch.int32)


def row_logits(t: int, ids: torch.Tensor, seed: int) -> torch.Tensor:
    """The hidden per-row logit of table `t`'s rows `ids`: a hash of (t,
    row, seed) spread to a zero-mean, unit-variance uniform."""
    salt = (int(seed) * 7919 + (t + 1) * _HASH_TABLE) % (1 << 32)
    h = (ids.to(torch.int64) * _HASH_MUL + salt) % (1 << 32)
    u = h.to(torch.float64) / float(1 << 32)
    return ((u - 0.5) * math.sqrt(12.0)).to(torch.float32)


def examples(gen: torch.Generator, vocab_sizes, n: int, num_dense: int,
             a: float, seed: int, device) -> dict:
    """n examples on `device`: dense (n, num_dense) f32 (log1p of a
    lognormal), cat (T, n) int32 Zipf ids per table, label (n,) f32."""
    dense = torch.randn((n, num_dense), generator=gen, device=device)
    dense = torch.log1p(torch.exp(dense))
    cat = torch.stack([zipf_ids(gen, v, n, a, device) for v in vocab_sizes])
    w = torch.randn((num_dense,), generator=gen, device=device)
    logit = dense @ w / math.sqrt(num_dense) - 1.5
    for t in range(len(vocab_sizes)):
        logit += row_logits(t, cat[t], seed) / math.sqrt(len(vocab_sizes))
    u = torch.rand((n,), generator=gen, device=device)
    label = (u < torch.sigmoid(logit)).to(torch.float32)
    return {"dense": dense, "cat": cat, "label": label}


def train_batches(vocab_sizes, num_dense: int, traffic: dict, seed: int,
                  device) -> list:
    """`traffic["batches"]` distinct batches of `traffic["batch"]` examples
    as dicts of host numpy arrays (the port's batch format), drawn on
    `device` in one call per table."""
    nb, b = int(traffic["batches"]), int(traffic["batch"])
    ex = examples(generator(device, seed, 1), vocab_sizes, nb * b, num_dense,
                  float(traffic["zipf_a"]), seed, device)
    dense = ex["dense"].cpu().numpy()
    cat = ex["cat"].cpu().numpy()
    label = ex["label"].cpu().numpy()
    return [{"dense": np.ascontiguousarray(dense[i * b:(i + 1) * b]),
             "cat": np.ascontiguousarray(cat[:, i * b:(i + 1) * b]),
             "label": np.ascontiguousarray(label[i * b:(i + 1) * b])}
            for i in range(nb)]
