"""The plain reference against the port's plain PyTorch path at a tiny size
on the CPU: the same weights and inputs give the same logits, and one
training step the same loss, gradient and change, with the towers in f32 so
that only the summation order differs."""
import dataclasses

import pytest
import torch

from portbench import generate, port, spec, weights
from portbench.reference import train as reftrain
from portbench.reference.numerics import Precision
from portbench.tests import tiny


def _setup(name):
    c = tiny.cell(name)
    cfg = c.config
    fam = spec.load_module("families", cfg["family"])
    pcfg = dataclasses.replace(fam.port_config(cfg),
                               compute_dtype=torch.float32)
    dev = torch.device("cpu")
    leaves = weights.make_leaves(fam.reference, cfg, 3, dev)
    tables = weights.make_tables(cfg, 3, dev)
    batch = generate.train_batches(cfg["vocab_sizes"], cfg["num_dense"],
                                   c.traffic, 3, dev)[0]
    return c, cfg, fam, pcfg, leaves, tables, batch


@pytest.mark.parametrize("name", ["dlrm.train.zipf", "dcn.train.zipf"])
def test_reference_logits_match_the_port(name):
    c, cfg, fam, pcfg, leaves, tables, batch = _setup(name)
    model = fam.port_model(pcfg, cfg, tables.clone(),
                           {k: v.clone() for k, v in leaves.items()},
                           port.sparse_optimizer(cfg["sparse_optimizer"]))
    got = model(torch.from_numpy(batch["dense"]),
                torch.from_numpy(batch["cat"]))
    offs = torch.tensor(weights.offsets(cfg["vocab_sizes"])[:-1])
    flat = torch.from_numpy(batch["cat"]).long() + offs[:, None]
    want = fam.reference.logits(cfg, leaves, torch.from_numpy(batch["dense"]),
                                tables[flat], Precision("f32"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["dlrm.train.zipf", "dcn.train.zipf"])
def test_reference_step_matches_the_port(name):
    c, cfg, fam, pcfg, leaves, tables, batch = _setup(name)
    opt = port.sparse_optimizer(cfg["sparse_optimizer"])
    model = fam.port_model(pcfg, cfg, tables.clone(),
                           {k: v.clone() for k, v in leaves.items()}, opt)
    res = fam.train(pcfg, model, [batch], 1, sparse_opt=opt,
                    dense_lr=cfg["dense_optimizer"]["lr"],
                    device_prefetch=0, log_every=1)
    offs = torch.tensor(weights.offsets(cfg["vocab_sizes"])[:-1])
    flat = (torch.from_numpy(batch["cat"]).long() + offs[:, None])
    u = torch.unique(flat)
    bounds = torch.tensor(weights.offsets(cfg["vocab_sizes"]))
    tor = torch.searchsorted(bounds, u, right=True) - 1
    ref = reftrain.steps(
        fam.reference, cfg, leaves, tables[u], tor,
        [{"dense": torch.from_numpy(batch["dense"]),
          "label": torch.from_numpy(batch["label"]),
          "pos": torch.searchsorted(u, flat)}],
        cfg["sparse_optimizer"], cfg["dense_optimizer"]["lr"],
        Precision("f32"))
    assert res.losses[0] == pytest.approx(ref["loss"][0], rel=1e-5)
    got_change = reftrain.table_norms(model.tables.data[u] - tables[u], tor,
                                      len(cfg["vocab_sizes"]))
    towers = fam.tower_leaves(model)
    got_change.update(reftrain.leaf_norms(
        {n: p.detach() - leaves[n] for n, p in towers.items()}))
    for k, v in ref["change"].items():
        assert got_change[k] == pytest.approx(v, rel=1e-4, abs=1e-9), k
