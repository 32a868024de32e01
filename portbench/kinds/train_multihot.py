"""Multi-hot training traffic: `kinds/train.py`'s loop, set-up, window and
check on batches whose bags have one fixed width a table (the
configuration's `bag_sizes`), as MLPerf DLRM-DCNv2 reads them.

A batch's `cat` is one `(S, B)` int32 array, S = sum(bag_sizes): table t's
bag of example b is column b of its `bag_sizes[t]` consecutive slot rows.
Each bag is fixed by its first id, the anchor: anchors are drawn as
`generate.examples` draws one-hot ids (Zipf by rank through the seeded
rank -> row permutation, over the card's slice of the table), and the other
`bag_sizes[t] - 1` ids of the bag are rows that an integer hash of (seed,
table, anchor, slot) gives, modulo the table's rows. So a hot id brings the
same bag every time, as MLPerf's `multi_hot.py` materialises each Criteo
id (its exact offsets are not reproduced). Labels are `generate.examples`'
hidden model over the anchors.

The flat ids shift each slot row by its table's stacked offset; the
reference gets each batch's `(S, B)` positions, which `reference/train.py`
indexes and sums back as it does one-hot ids. The facts count `n_ids` =
S * B ids a step and `n_bags` = T * B sums, and the port's telemetry
counters (`lookup.ids`, `lookup.bags`) a step of the window.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import generate, port, weights
from portbench.kinds import train

# Odd 32-bit multipliers of the bag hash (a murmur-style finaliser).
_ANCHOR_MUL, _SLOT_MUL, _MIX = 0x9E3779B1, 0x85EBCA77, 0x45D9F3B
_M32 = (1 << 32) - 1


def bag_ids(seed: int, t: int, anchor: torch.Tensor, width: int,
            vocab: int) -> torch.Tensor:
    """(width - 1, n) int32: slots 1 .. width-1 of the bags of table `t`
    whose anchors are `anchor` (n,)."""
    slot = torch.arange(1, width, device=anchor.device, dtype=torch.int64)
    salt = (int(seed) * 7919 + (t + 1) * 104729) & _M32
    h = (anchor.to(torch.int64)[None] * _ANCHOR_MUL + slot[:, None] * _SLOT_MUL
         + salt) & _M32
    for _ in range(2):
        h = ((h ^ (h >> 16)) * _MIX) & _M32
    h = h ^ (h >> 16)
    return (h % vocab).to(torch.int32)


def multihot_batches(cfg: dict, traffic: dict, seed: int, device) -> list:
    """`traffic["batches"]` batches of `traffic["batch"]` examples as dicts
    of host numpy arrays, `cat` (S, B) int32."""
    nb, b = int(traffic["batches"]), int(traffic["batch"])
    ex = generate.examples(generate.generator(device, seed, 1),
                           cfg["vocab_sizes"], nb * b, cfg["num_dense"],
                           float(traffic["zipf_a"]), seed, device)
    slots = []
    for t, (v, w) in enumerate(zip(cfg["vocab_sizes"], cfg["bag_sizes"])):
        slots.append(ex["cat"][t][None])
        if w > 1:
            slots.append(bag_ids(seed, t, ex["cat"][t], w, v))
    cat = torch.cat(slots).cpu().numpy()
    dense = ex["dense"].cpu().numpy()
    label = ex["label"].cpu().numpy()
    return [{"dense": np.ascontiguousarray(dense[i * b:(i + 1) * b]),
             "cat": np.ascontiguousarray(cat[:, i * b:(i + 1) * b]),
             "label": np.ascontiguousarray(label[i * b:(i + 1) * b])}
            for i in range(nb)]


def lookup_counters() -> dict:
    from embeddingtables_tpu_torch.utils.telemetry import get_telemetry
    c = get_telemetry().counters
    return {k: c.get(k, 0.0) for k in ("lookup.ids", "lookup.bags")}


class Runner(train.Runner):
    """`train.Runner` on multi-hot batches (one card)."""

    def setup(self):
        cfg, dev = self.cfg, self.device
        if self.world != 1:
            raise ValueError(f"{self.cell.name}: multi-hot cells run on one "
                             "card")
        nbytes = weights.table_bytes(cfg)
        self.log(f"tables: {nbytes} bytes ({nbytes / 1e9:.2f} GB), "
                 f"{weights.offsets(cfg['vocab_sizes'])[-1]} rows of "
                 f"{cfg['dim']}; {sum(cfg['bag_sizes'])} ids an example")
        self.opt = port.sparse_optimizer(self.sparse)
        self.model = self.fam.port_model(
            self.pcfg, cfg, weights.make_tables(cfg, self.seed, dev),
            weights.make_leaves(self.ref, cfg, self.seed, dev), self.opt)
        self.batches = multihot_batches(cfg, self.traffic, self.seed, dev)
        # one offset a slot row: `train.Runner._flat` shifts by row
        self.offsets = torch.repeat_interleave(
            torch.tensor(weights.offsets(cfg["vocab_sizes"])[:-1],
                         dtype=torch.int64, device=dev),
            torch.tensor(cfg["bag_sizes"], device=dev))
        self.unique = [int(torch.unique(self._flat(b)).numel())
                       for b in self.batches]
        self.program = self._first_steps()

    def window(self, seconds: float, tracer=None) -> dict:
        before = lookup_counters()
        out = super().window(seconds, tracer)
        facts, batch = out["facts"], int(self.traffic["batch"])
        after = lookup_counters()
        facts.update(
            n_ids=sum(self.cfg["bag_sizes"]) * batch,
            n_bags=len(self.cfg["vocab_sizes"]) * batch,
            counters={k: (after[k] - before[k]) / facts["steps"]
                      for k in after if after[k] > before[k]})
        return out
