"""The port's `compat`, `nn` and torch bridge (`interop.from_torch` and
friends) against the JAX package's on the same numpy inputs: the same
tables and ids through JAX's optax-shaped transform, its flax modules and
its interop, and through the port's torch meaning of each name."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import embeddingtables_tpu as et
from embeddingtables_tpu import compat as JC
from embeddingtables_tpu import interop as JI
from embeddingtables_tpu import nn as JN
from embeddingtables_tpu import optim as J
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import compat as PC
from embeddingtables_tpu_torch import nn as PN
from embeddingtables_tpu_torch import optim as PO
from _torch_threads import _one_torch_thread  # noqa: F401

OPTS = {"sgd": (J.SparseSGD(0.5), PO.SparseSGD(0.5)),
        "adagrad": (J.SparseRowWiseAdaGrad(lr=0.5),
                    PO.SparseRowWiseAdaGrad(lr=0.5))}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_sparse_gradient_transform_matches_jax(opt):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((20, 8)).astype(np.float32)
    w = rng.standard_normal(4).astype(np.float32)
    delta = rng.standard_normal((5, 8)).astype(np.float32)
    idx = np.array([2, 2, 5, 19, 2], np.int32)
    gw = rng.standard_normal(4).astype(np.float32)
    jopt, popt = OPTS[opt]

    jtx = JC.sparse_gradient_transform(jopt)
    jparams = {"table": jnp.asarray(table), "tower": [jnp.asarray(w)]}
    jgrads = {"table": et.SparseEmbeddingUpdate(jnp.asarray(delta),
                                                jnp.asarray(idx)),
              "tower": [jnp.asarray(gw)]}
    jup, jstate = jtx.update(jgrads, jtx.init(jparams), jparams)
    jnew = JC.apply_updates(jparams, jup)

    ptx = PC.sparse_gradient_transform(popt)
    params = {"table": _t(table), "tower": [_t(w)]}
    grads = {"table": ett.SparseEmbeddingUpdate(_t(delta), _t(idx)),
             "tower": [_t(gw)]}
    up, state = ptx.update(grads, ptx.init(params), params)
    assert up["table"] is None          # applied in place by update
    new = PC.apply_updates(params, up)
    assert new["table"] is params["table"]
    np.testing.assert_allclose(new["table"].numpy(), np.asarray(jnew["table"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(new["tower"][0].numpy(),
                               np.asarray(jnew["tower"][0]), rtol=1e-6)
    np.testing.assert_allclose(state["table"].accum.numpy(),
                               np.asarray(jstate["table"].accum), rtol=1e-6)
    with pytest.raises(ValueError, match="params"):
        ptx.update(grads, ptx.init(params))


def test_split_and_merge_sparse():
    upd = ett.SparseEmbeddingUpdate(torch.ones((1, 2)), torch.tensor([0]))
    grads = {"t": upd, "w": torch.ones(3), "more": [upd, torch.zeros(2)]}
    dense, sparse = PC.split_sparse(grads)
    jd, js = JC.split_sparse({"t": et.SparseEmbeddingUpdate(
        jnp.ones((1, 2)), jnp.array([0])), "w": jnp.ones(3)})
    assert (dense["t"] is None) == (jd["t"] is None) and sparse["w"] is None
    assert (sparse["t"] is upd) and js["w"] is None
    assert dense["more"][0] is None and sparse["more"][1] is None
    merged = PC.merge_sparse(dense, sparse)
    assert merged["t"] is upd and merged["more"][0] is upd
    assert torch.equal(merged["w"], grads["w"])


def _bag_case(rng, v=50, b=12, bag=4, pad=-1):
    idx = rng.integers(0, v, (b, bag)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.3] = pad
    idx[1] = pad                                   # an empty bag
    return idx


@pytest.mark.parametrize("combiner,pad", [("sum", None), ("mean", -1)])
def test_embed_gives_jax_dense_gradient(combiner, pad):
    rng = np.random.default_rng(1)
    idx = _bag_case(rng) if pad is not None else rng.integers(
        0, 50, 20).astype(np.int32)
    m = JN.Embed(vocab=50, dim=8, combiner=combiner, pad_idx=pad)
    params = m.init(jax.random.key(0), jnp.asarray(idx))
    out_j = m.apply(params, jnp.asarray(idx))
    delta = rng.standard_normal(out_j.shape).astype(np.float32)
    g_j = jax.grad(lambda p: (m.apply(p, jnp.asarray(idx)) * delta).sum())(
        params)["params"]["table"]

    pm = PN.Embed(50, 8, combiner=combiner, pad_idx=pad, device="cpu",
                  table=np.asarray(params["params"]["table"]))
    out = pm(idx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-7)
    (out * _t(delta)).sum().backward()
    np.testing.assert_allclose(pm.table.grad.numpy(), np.asarray(g_j),
                               rtol=1e-5, atol=1e-6)


class TwoTables(torch.nn.Module):
    """The port's copy of tests/test_nn.py's TwoTableModel."""

    def __init__(self, table_a, table_b):
        super().__init__()
        self.emb_a = PN.SparseEmbed(40, 8, table=table_a, device="cpu")
        self.emb_b = PN.SparseEmbed(60, 8, combiner="mean", table=table_b,
                                    device="cpu")
        self.head = torch.nn.Parameter(torch.ones(16))

    def forward(self, idx_a, idx_b):
        h = torch.cat([self.emb_a(idx_a), self.emb_b(idx_b)], dim=-1)
        return (h * self.head).sum(dim=-1)


def _flax_two_tables():
    import flax.linen as fnn

    class TwoTableModel(fnn.Module):
        @fnn.compact
        def __call__(self, idx_a, idx_b):
            a = JN.SparseEmbed(vocab=40, dim=8, name="emb_a")(idx_a)
            b = JN.SparseEmbed(vocab=60, dim=8, combiner="mean",
                               name="emb_b")(idx_b)
            h = jnp.concatenate([a, b], axis=-1)
            w = self.param("head", fnn.initializers.ones, (16,), jnp.float32)
            return (h * w).sum(axis=-1)
    return TwoTableModel()


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_sparse_embed_stock_step_matches_flax(opt):
    """Two lazy tables and a head through one stock step in each package:
    the same deltas, ids and weights, the same tables after the fused
    update, and no table-sized gradient in the port."""
    rng = np.random.default_rng(2)
    b, bag = 12, 3
    idx_a = rng.integers(0, 40, b).astype(np.int32)
    idx_b = rng.integers(0, 60, (b, bag)).astype(np.int32)
    target = rng.standard_normal(b).astype(np.float32)
    jopt, popt = OPTS[opt]

    fm = _flax_two_tables()
    vars_ = fm.init(jax.random.key(0), jnp.asarray(idx_a), jnp.asarray(idx_b))
    params, perts = vars_["params"], vars_["perturbations"]

    def loss_fn(params, perts):
        out, mut = fm.apply({"params": params, "perturbations": perts},
                            jnp.asarray(idx_a), jnp.asarray(idx_b),
                            mutable=["intermediates"])
        return ((out - target) ** 2).mean(), mut["intermediates"]

    (lj, inter), grads = jax.value_and_grad(loss_fn, argnums=1,
                                            has_aux=True)(params, perts)
    jupds = JN.sparse_updates_from_grads(grads, inter)
    jnew, _ = JN.apply_sparse_updates(params, jupds, jopt)

    model = TwoTables(np.asarray(params["emb_a"]["table"]),
                      np.asarray(params["emb_b"]["table"]))
    loss = ((model(idx_a, idx_b) - _t(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-6)
    assert [n for n, _ in model.named_parameters()] == ["head"]
    upds = PN.sparse_updates_from_grads(model)
    assert sorted(upds) == ["emb_a", "emb_b"]
    for name in upds:
        np.testing.assert_allclose(upds[name].delta.numpy(),
                                   np.asarray(jupds[name]["delta"].delta),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(upds["emb_b"].weights.numpy(),
                               np.full((b, bag), 1 / bag, np.float32))
    _, states = PN.apply_sparse_updates(model, upds, popt)
    for name in ("emb_a", "emb_b"):
        np.testing.assert_allclose(getattr(model, name).table.numpy(),
                                   np.asarray(jnew[name]["table"]),
                                   rtol=1e-5, atol=1e-6)
    assert sorted(states) == ["emb_a", "emb_b"]
    assert PN.sparse_updates_from_grads(model) == {}     # consumed


def test_sparse_embed_pads_follow_the_lookup_contract():
    """tests/test_padding.py:350-378 on the port: a padded SparseEmbed's
    lazy update is the dense gradient of the padded lookup, and one SGD
    step moves the table as JAX's does."""
    rng = np.random.default_rng(41)
    idx = _bag_case(rng, v=200, b=32, bag=6)
    m = JN.SparseEmbed(vocab=200, dim=16, pad_idx=-1)
    vars_ = m.init(jax.random.PRNGKey(0), jnp.asarray(idx))
    params, perts = vars_["params"], vars_["perturbations"]

    def loss_fn(params, perts):
        out, inter = m.apply({"params": params, "perturbations": perts},
                             jnp.asarray(idx), mutable=["intermediates"])
        return (out ** 2).sum(), inter

    (_, inter), grads = jax.value_and_grad(loss_fn, argnums=1,
                                           has_aux=True)(params, perts)
    jupds = JN.sparse_updates_from_grads(grads, inter["intermediates"])
    jnew, _ = JN.apply_sparse_updates(params, jupds, J.SparseSGD(lr=0.1))

    pm = PN.SparseEmbed(200, 16, pad_idx=-1, device="cpu",
                        table=np.asarray(params["table"]))
    (pm(idx) ** 2).sum().backward()
    upd = PN.sparse_updates_from_grads(pm)[""]
    np.testing.assert_allclose(ett.uncompress(upd, 200).numpy(),
                               np.asarray(et.uncompress(jupds["delta"], 200)),
                               rtol=1e-5, atol=1e-5)
    assert float(upd.weights[1].abs().max()) == 0.0     # the empty bag
    PN.apply_sparse_updates(pm, {"": upd}, PO.SparseSGD(lr=0.1))
    np.testing.assert_allclose(pm.table.numpy(), np.asarray(jnew["table"]),
                               rtol=1e-5, atol=1e-5)


def test_sparse_embed_without_autograd_records_nothing():
    pm = PN.SparseEmbed(10, 4, device="cpu")
    with torch.no_grad():
        out = pm(np.array([1, 2], np.int32))
    assert not out.requires_grad and pm.calls == []
    pm(np.array([3], np.int32))
    with pytest.raises(ValueError, match="backward"):
        PN.sparse_updates_from_grads(pm)


def test_from_torch_copies_as_jax_does():
    torch.manual_seed(0)
    emb = torch.nn.Embedding(40, 16)
    t = ett.from_torch(emb)
    jt = JI.from_torch(emb)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(jt.data))
    assert t.data.device == emb.weight.device
    t.data.add_(1.0)                               # the source stays
    np.testing.assert_array_equal(emb.weight.detach().numpy(),
                                  np.asarray(jt.data))
    back = ett.to_torch_embedding(ett.from_torch(emb))
    np.testing.assert_array_equal(back.weight.detach().numpy(),
                                  JI.to_torch_embedding(jt).weight.detach()
                                  .numpy())
    with pytest.raises(ValueError, match="vocab, dim"):
        ett.from_torch(torch.zeros(3))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bags_through_the_bridge_match_jax(mode):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((30, 8)).astype(np.float32)
    bags = rng.integers(0, 30, (12, 4)).astype(np.int32)
    mod = ett.to_torch_embedding(ett.SimpleEmbedding(_t(data)), bag=True,
                                 mode=mode)
    jmod = JI.to_torch_embedding(et.SimpleEmbedding(jnp.asarray(data)),
                                 bag=True, mode=mode)
    assert isinstance(mod, torch.nn.EmbeddingBag) and mod.mode == mode
    want = jmod(torch.from_numpy(bags.astype(np.int64))).detach().numpy()
    got = mod(torch.from_numpy(bags.astype(np.int64))).detach().numpy()
    np.testing.assert_array_equal(got, want)
    lk = ett.lookup(ett.from_torch(mod), bags, combiner=mode).numpy()
    np.testing.assert_allclose(lk, np.asarray(et.lookup(
        JI.from_torch(jmod), jnp.asarray(bags), combiner=mode)), rtol=1e-6)
    np.testing.assert_allclose(lk, got, rtol=1e-5, atol=1e-6)


def test_stacked_bridge_and_materializing_tables_match_jax():
    torch.manual_seed(1)
    embs = [torch.nn.Embedding(v, 8) for v in (20, 35, 15)]
    st, jst = ett.stacked_from_torch(embs), JI.stacked_from_torch(embs)
    assert st.offsets == jst.offsets
    np.testing.assert_array_equal(st.data.numpy(), np.asarray(jst.data))
    for b, jb in zip(ett.stacked_to_torch(st), JI.stacked_to_torch(jst)):
        np.testing.assert_array_equal(b.weight.detach().numpy(),
                                      jb.weight.detach().numpy())
    with pytest.raises(ValueError, match="one dim"):
        ett.stacked_from_torch([torch.nn.Embedding(4, 8),
                                torch.nn.Embedding(4, 16)])
    qr = ett.QREmbedding.create(torch.Generator().manual_seed(1), 40, 8,
                                num_remainder=7, device="cpu")
    np.testing.assert_array_equal(
        ett.to_torch_embedding(qr).weight.detach().numpy(),
        qr.materialize().numpy())
