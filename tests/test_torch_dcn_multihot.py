"""The port's DCN-v2 with multi-hot bags of one width a table
(`DCNConfig.bag_sizes`) and a dense arch (`DCNConfig.dense_mlp`), on the
CPU, against the benchmark's plain reference
(`portbench/reference/dcn_multihot.py`) on seeded random weights.

Checked: the logits, the loss and every tower leaf's gradient, and the
towers and table rows after two `make_train_step` steps with SGD and with
row-wise AdaGrad's indexer method; planted faults (one id of the 100-wide
bag dropped from the forward, a bag's gradient sent to the next example's
bag) must fail that comparison. Also `microbatch=2`, the lookup's
counters, the one-hot and one-width paths, and merged bag-indexed
updates.

Tolerances, with the towers in f32 on both sides: the two differ only in
the order of f32 sums (the bag sums, the GEMMs, the run-scatter's sums of
duplicate rows), a few ulps: rtol 1e-5 on the logits, the loss and the
gradients. After two steps rtol 1e-4: row-wise AdaGrad divides each row's
step by the root of its accumulated mean square, which carries a row's
relative error into its step, and the second step runs on the first's
rounding. atol 1e-6 on elements that cancel to near zero (f32 sums of
terms of 1e-2 to 1e-1). A planted fault moves them by 1e-2 or more.
"""
import pytest
import torch

from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.models import dcn as PD
from embeddingtables_tpu_torch.models import dlrm as PL
from embeddingtables_tpu_torch.ops.cuda.gather import BagLayout
from embeddingtables_tpu_torch.ops.ensemble import StackedTables
from embeddingtables_tpu_torch.ops.sparse_update import (
    SparseEmbeddingUpdate, accumulate_updates, uncompress)
from embeddingtables_tpu_torch.utils.telemetry import Telemetry, set_telemetry
from portbench import weights
from portbench.reference import dcn as ref_dcn
from portbench.reference import dcn_multihot as ref
from portbench.reference.numerics import Precision
from portbench.reference.train import bce
from _torch_threads import _one_torch_thread  # noqa: F401

CFG = {"vocab_sizes": [11, 7, 13, 150, 5], "bag_sizes": [1, 3, 7, 100, 2],
       "num_dense": 4, "dim": 8, "dense_mlp": [16, 8], "num_cross": 2,
       "cross_rank": 4, "deep_mlp": [16, 8]}
B, LR_DENSE, SEED = 32, 0.1, 2**31 + 11
OPTS = {"sgd": P.SparseSGD(0.1),
        "adagrad_indexer": P.SparseRowWiseAdaGrad(0.05, method="indexer")}


def _pcfg(**kw):
    base = dict(vocab_sizes=tuple(CFG["vocab_sizes"]),
                num_dense=CFG["num_dense"], dim=CFG["dim"],
                num_cross=CFG["num_cross"], cross_rank=CFG["cross_rank"],
                deep_mlp=tuple(CFG["deep_mlp"]), compute_dtype=torch.float32,
                bag_sizes=tuple(CFG["bag_sizes"]),
                dense_mlp=tuple(CFG["dense_mlp"]))
    base.update(kw)
    return PD.DCNConfig(**base)


def _leaves(dense_arch=True):
    """The reference's leaves; without the dense arch, the one-hot DCN
    reference's (x0 holds the raw dense features)."""
    return weights.make_leaves(ref if dense_arch else ref_dcn, CFG, SEED,
                               torch.device("cpu"))


def _model(pcfg, leaves, tables, opt):
    n = len(pcfg.dense_mlp or ())
    return PD.DCN(
        pcfg, [tuple(leaves[f"cross.{l}.{p}"].clone() for p in "uvb")
               for l in range(pcfg.num_cross)],
        [(leaves[f"deep.{i}.w"].clone(), leaves[f"deep.{i}.b"].clone())
         for i in range(len(pcfg.deep_mlp))],
        (leaves["head.w"].clone(), leaves["head.b"].clone()),
        StackedTables(tables.clone(), weights.offsets(pcfg.vocab_sizes),
                      pcfg.dim), opt.init(tables),
        dense_arch=[(leaves[f"dense.{i}.w"].clone(),
                     leaves[f"dense.{i}.b"].clone()) for i in range(n)])


def _batches(n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        cat = torch.cat([torch.randint(0, v, (w, B), generator=g) for v, w
                         in zip(CFG["vocab_sizes"], CFG["bag_sizes"])])
        out.append((torch.randn((B, CFG["num_dense"]), generator=g),
                    cat.to(torch.int32),
                    (torch.rand(B, generator=g) < 0.4).float()))
    return out


def _flat(cat):
    starts = torch.tensor(weights.offsets(CFG["vocab_sizes"])[:-1])
    return cat.long() + torch.repeat_interleave(
        starts, torch.tensor(CFG["bag_sizes"]))[:, None]


def _reference(leaves, tables, batches, opt_name):
    """The reference's step-1 logits, loss and tower gradients, and its
    towers and rows after `len(batches)` steps."""
    leaves = {k: v.clone() for k, v in leaves.items()}
    rows, accum = tables.clone(), torch.zeros(tables.shape[0])
    opt, out = OPTS[opt_name], {}
    for k, (dense, cat, label) in enumerate(batches):
        names = list(leaves)
        params = [leaves[n].requires_grad_(True) for n in names]
        pos = _flat(cat)
        emb = rows[pos].requires_grad_(True)
        z = ref.logits(CFG, leaves, dense, emb, Precision("f32"))
        loss = bce(z, label)
        *gw, gemb = torch.autograd.grad(loss, params + [emb])
        if k == 0:
            out.update(logits=z.detach(), loss=loss.detach(),
                       grads=dict(zip(names, gw)))
        g = torch.zeros_like(rows).index_add_(0, pos.reshape(-1),
                                              gemb.reshape(-1, CFG["dim"]))
        with torch.no_grad():
            if opt_name == "sgd":
                rows = rows - opt.lr * g
            else:
                accum += (g * g).mean(dim=1)
                rows = rows - opt.lr * g * torch.rsqrt(
                    torch.clamp_min(accum + opt.eps, 1e-30))[:, None]
            leaves = {n: (leaves[n] - LR_DENSE * gn).detach()
                      for n, gn in zip(names, gw)}
    out.update(leaves=leaves, rows=rows)
    return out


def _tower_leaves(model):
    out = {f"dense.{i}.{p}": t for i, layer in enumerate(model.dense_arch)
           for p, t in zip("wb", layer)}
    out.update({f"cross.{l}.{p}": t for l, layer in enumerate(model.cross)
                for p, t in zip("uvb", layer)})
    out.update({f"deep.{i}.{p}": t for i, layer in enumerate(model.deep)
                for p, t in zip("wb", layer)})
    out.update({"head.w": model.head[0], "head.b": model.head[1]})
    return out


def _close(got, want, rtol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6)


def _drop_last_id_of_widest_bag(monkeypatch):
    orig = PL.lookup_ragged
    widest = max(range(len(CFG["bag_sizes"])),
                 key=lambda t: CFG["bag_sizes"][t])
    last = sum(CFG["bag_sizes"][:widest + 1]) - 1

    def faulty(data, idx, layout):
        out = orig(data, idx, layout)
        out[widest] -= data[idx[last].long()]
        return out
    monkeypatch.setattr(PL, "lookup_ragged", faulty)


def _send_gradient_to_next_bag(monkeypatch):
    orig = BagLayout.bags

    def faulty(self, batch):
        bags = orig(self, batch)
        return bags - bags % batch + (bags + 1) % batch
    monkeypatch.setattr(BagLayout, "bags", faulty)


FAULTS = {None: None, "drop_slot": _drop_last_id_of_widest_bag,
          "neighbour_bag": _send_gradient_to_next_bag}


@pytest.mark.parametrize("fault", list(FAULTS), ids=str)
@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_multihot_dcn_matches_the_reference(monkeypatch, opt_name, fault):
    leaves, pcfg = _leaves(), _pcfg()
    tables = weights.make_tables(CFG, SEED, torch.device("cpu"))
    batches = _batches()
    want = _reference(leaves, tables, batches, opt_name)
    if fault is not None:
        FAULTS[fault](monkeypatch)
    model = _model(pcfg, leaves, tables, OPTS[opt_name])

    def compare():
        dense, cat, label = batches[0]
        z = model(dense, cat)
        loss = PL.bce_loss(z, label)
        named = _tower_leaves(model)
        grads = torch.autograd.grad(loss, list(named.values()))
        _close(z.detach(), want["logits"], 1e-5)
        _close(loss.detach(), want["loss"], 1e-5)
        for (name, _), g in zip(named.items(), grads):
            _close(g, want["grads"][name], 1e-5)
        step = PD.make_train_step(pcfg, OPTS[opt_name], dense_lr=LR_DENSE)
        for dense, cat, label in batches:
            step(model, dense, cat, label)
        for name, p in _tower_leaves(model).items():
            _close(p.detach(), want["leaves"][name], 1e-4)
        _close(model.tables.data, want["rows"], 1e-4)

    if fault is None:
        compare()
    else:
        with pytest.raises(AssertionError):
            compare()


def _trained(pcfg, cat_of, opt_name="sgd", microbatch=None, steps=2):
    leaves = _leaves(pcfg.dense_mlp is not None)
    tables = weights.make_tables(CFG, SEED, torch.device("cpu"))
    model = _model(pcfg, leaves, tables, OPTS[opt_name])
    step = PD.make_train_step(pcfg, OPTS[opt_name], dense_lr=LR_DENSE,
                              microbatch=microbatch)
    batches = _batches(steps)
    logits = model(batches[0][0], cat_of(batches[0][1])).detach()
    for dense, cat, label in batches:
        step(model, dense, cat_of(cat), label)
    return logits, model


def _one_hot(cat):
    """The first id of each table's bag, (T, B)."""
    starts = weights.offsets(CFG["bag_sizes"])[:-1]
    return cat[starts]


def _one_width(cat, w=3):
    """The first min(width, w) ids of each bag, repeated to width w,
    (T, B, w); in `bag_sizes` form, (T * w, B)."""
    starts, out = weights.offsets(CFG["bag_sizes"])[:-1], []
    for t, o in enumerate(starts):
        k = [min(j, CFG["bag_sizes"][t] - 1) for j in range(w)]
        out.append(cat[[o + j for j in k]].T)
    return torch.stack(out)


@pytest.mark.parametrize("case", ["microbatch_2", "counters", "one_hot",
                                  "one_width", "accumulate"])
def test_multihot_dcn_paths(case):
    if case == "accumulate":
        # Bag-indexed updates merge with each other only, each one's bags
        # shifted past the delta rows before it.
        g = torch.Generator().manual_seed(3)
        ups = [SparseEmbeddingUpdate(
            delta=torch.randn((4, 8), generator=g),
            indices=torch.randint(0, 20, (10,), generator=g,
                                  dtype=torch.int32),
            bags=torch.randint(0, 4, (10,), generator=g, dtype=torch.int32))
            for _ in range(2)]
        _close(uncompress(accumulate_updates(ups), 20),
               uncompress(ups[0], 20) + uncompress(ups[1], 20), 1e-6)
        one_hot = SparseEmbeddingUpdate(delta=torch.ones((10, 8)),
                                        indices=ups[0].indices)
        with pytest.raises(ValueError, match="bags"):
            accumulate_updates([ups[0], one_hot])
    elif case == "microbatch_2":
        for opt_name in OPTS:
            _, whole = _trained(_pcfg(), lambda c: c, opt_name)
            _, sliced = _trained(_pcfg(), lambda c: c, opt_name, microbatch=2)
            # the slices' sums re-associate the batch's: f32 rounding only
            _close(sliced.tables.data, whole.tables.data, 1e-5)
            for name, p in _tower_leaves(sliced).items():
                _close(p.detach(), _tower_leaves(whole)[name].detach(), 1e-5)
    elif case == "counters":
        old = set_telemetry(Telemetry())
        try:
            _, model = _trained(_pcfg(), lambda c: c, steps=1)
            from embeddingtables_tpu_torch.utils.telemetry import \
                get_telemetry
            # one forward and one step, S ids and T sums an example each
            s, t = sum(CFG["bag_sizes"]), len(CFG["vocab_sizes"])
            assert dict(get_telemetry().counters) == {
                "lookup.ids": 2 * s * B, "lookup.bags": 2 * t * B}
        finally:
            set_telemetry(old)
    elif case == "one_hot":
        # The one-hot path and bags of width 1 take the same f32 values in
        # the same order: the same bits.
        t = len(CFG["vocab_sizes"])
        for opt_name in OPTS:
            z0, m0 = _trained(_pcfg(bag_sizes=None, dense_mlp=None),
                              _one_hot, opt_name)
            z1, m1 = _trained(_pcfg(bag_sizes=(1,) * t, dense_mlp=None),
                              _one_hot, opt_name)
            assert torch.equal(z0, z1)
            assert torch.equal(m0.tables.data, m1.tables.data)
            for name, p in _tower_leaves(m0).items():
                assert torch.equal(p, _tower_leaves(m1)[name])
    else:
        # `bag=3` and widths of 3 sum each bag in the same order: the same
        # logits bit for bit; the update sums a row's duplicates in
        # another order (example-major against slot-major): f32 rounding.
        t = len(CFG["vocab_sizes"])
        z0, m0 = _trained(_pcfg(bag_sizes=None, dense_mlp=None, bag=3),
                          _one_width)
        z1, m1 = _trained(_pcfg(bag_sizes=(3,) * t, dense_mlp=None),
                          lambda c: _one_width(c).permute(0, 2, 1)
                          .reshape(3 * t, B))
        assert torch.equal(z0, z1)
        _close(m1.tables.data, m0.tables.data, 1e-5)


@pytest.mark.parametrize("bad", ["widths", "dense_mlp", "pad_idx"])
def test_multihot_config_refuses_what_it_cannot_run(bad):
    kw = {"widths": dict(bag_sizes=(1, 2)),
          "dense_mlp": dict(dense_mlp=(16, 4)),
          "pad_idx": dict(pad_idx=0)}[bad]
    with pytest.raises(ValueError):
        _pcfg(**kw)
    assert _pcfg().input_features == \
        (len(CFG["vocab_sizes"]) + 1) * CFG["dim"]
