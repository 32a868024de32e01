"""The port's two-tower retriever against the JAX package's, on the CPU.

A JAX `init_two_tower` model is carried into the port with
`two_tower_from_arrays` (weights and both tables' optimizer states), and
both packages run the same numpy inputs: scores, the in-batch softmax loss
and accuracy, three train steps with SGD, indexer AdaGrad and lazy Adam,
`SyntheticRetrieval`, the item index, retrieval, `train_two_tower` and
`make_retrieval_service`.

Tolerances: f32 (the model's compute dtype) agrees up to the order of f32
sums: rtol/atol 1e-5 on one forward, one step or the index, 1e-4 after
three steps or four loop steps. Retrieved ids are compared on inputs whose
scores are distinct; on ties the port's order is `torch.topk`'s.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu import optim as J
from embeddingtables_tpu.data import SyntheticRetrieval as JaxRetrieval
from embeddingtables_tpu.metrics import recall_at_k as jax_recall
from embeddingtables_tpu.models import two_tower as JT
from embeddingtables_tpu.models.train import \
    train_two_tower as jax_train_two_tower
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.data import SyntheticRetrieval
from embeddingtables_tpu_torch.metrics import recall_at_k
from embeddingtables_tpu_torch.models import two_tower as PT
from _torch_threads import _one_torch_thread  # noqa: F401

SMALL = dict(query_vocab_sizes=(11, 23, 300), item_vocab=300, num_dense=3,
             dim=8, embed_dim=8, query_mlp=(16, 8), item_mlp=(16, 8))
B = 32
TOL1 = dict(rtol=1e-5, atol=1e-5)
TOL3 = dict(rtol=1e-4, atol=1e-4)


def _opts(name):
    return {"sgd": (J.SparseSGD(0.05), P.SparseSGD(0.05)),
            "adagrad_indexer": (J.SparseRowWiseAdaGrad(0.1, method="indexer"),
                                P.SparseRowWiseAdaGrad(0.1, method="indexer")),
            "lazy_adam": (J.SparseLazyAdam(0.05), P.SparseLazyAdam(0.05))
            }[name]


def _arrays(layers):
    return [tuple(np.asarray(a) for a in layer) for layer in layers]


def _carry(jm, pcfg):
    return ett.two_tower_from_arrays(
        pcfg, _arrays(jm.query_mlp), _arrays(jm.item_mlp),
        np.asarray(jm.query_tables.data), jm.query_tables.offsets,
        np.asarray(jm.item_table.data), device="cpu", q_state=jm.q_state,
        i_state=jm.i_state)


def _pair(opt_name="sgd", **kw):
    jopt, popt = _opts(opt_name)
    jcfg = JT.TwoTowerConfig(**SMALL, **kw)
    pcfg = ett.TwoTowerConfig(**SMALL, **kw)
    jm = JT.init_two_tower(jax.random.key(0), jcfg, sparse_opt=jopt)
    return (jcfg, jopt, jm), (pcfg, popt, _carry(jm, pcfg))


def _batches(n, seed=3, b=B):
    return list(SyntheticRetrieval(SMALL["query_vocab_sizes"],
                                   SMALL["item_vocab"], num_dense=3,
                                   batch_size=b, seed=seed).batches(n))


def _jargs(b):
    return tuple(jnp.asarray(b[k]) for k in ("dense", "q_cat", "item_ids"))


@pytest.fixture(scope="module")
def jax_steps():
    """One jitted JAX train step per optimizer, shared by this module."""
    cache = {}

    def get(jcfg, opt_name, jopt):
        if (jcfg, opt_name) not in cache:
            cache[jcfg, opt_name] = JT.make_train_step(jcfg, sparse_opt=jopt)
        return cache[jcfg, opt_name]
    return get


def _assert_models_close(pm, jm, tol):
    np.testing.assert_allclose(pm.query_tables.data.numpy(),
                               np.asarray(jm.query_tables.data), **tol)
    np.testing.assert_allclose(pm.item_data.numpy(),
                               np.asarray(jm.item_table.data), **tol)
    for ps, js in ((pm.q_state, jm.q_state), (pm.i_state, jm.i_state)):
        assert type(ps).__name__ == type(js).__name__
        for p, j in zip(ps, js):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), **tol)
    jparams = jax.tree_util.tree_leaves((jm.query_mlp, jm.item_mlp))
    pparams = list(pm.parameters())
    assert len(pparams) == len(jparams)
    for p, j in zip(pparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# Forward, loss, data
# ---------------------------------------------------------------------------

def test_scores_match_jax():
    (_, _, jm), (_, _, pm) = _pair()
    b = _batches(1)[0]
    want = np.asarray(JT.two_tower_scores(jm, *_jargs(b)))
    got = PT.two_tower_scores(pm, b["dense"], b["q_cat"], b["item_ids"])
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL1)
    q_rows = PT._query_rows(pm, b["q_cat"])
    assert q_rows.shape == (B, 3, 8)                 # (B, T, dim)


def test_query_input_puts_the_dense_features_first():
    # With an identity first layer the query tower's first input feature is
    # dense[:, 0], not a table column.
    cfg = ett.TwoTowerConfig(query_vocab_sizes=(4,), item_vocab=5,
                             num_dense=1, dim=2, embed_dim=3,
                             query_mlp=(3,), item_mlp=(3,))
    m = ett.init_two_tower(cfg, device="cpu")
    with torch.no_grad():
        w, _ = m.query_mlp[0]
        w.copy_(torch.eye(3))
    dense = torch.tensor([[5.0]])
    q = PT.query_embed_from_rows(m.query_mlp, cfg, dense,
                                 PT._query_rows(m, np.array([[1]])))
    rows = m.query_tables.data[1]
    x = torch.cat([dense[0], rows])
    np.testing.assert_allclose(q[0].detach().numpy(),
                               (x / torch.sqrt((x * x).sum() + 1e-6)).numpy(),
                               rtol=1e-6)


def test_in_batch_softmax_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, 8)).astype(np.float32)
    i = q + 0.8 * rng.standard_normal((B, 8)).astype(np.float32)
    jl, ja = JT.in_batch_softmax_loss(jnp.asarray(q), jnp.asarray(i), 0.05)
    pl, pa = PT.in_batch_softmax_loss(torch.from_numpy(q),
                                      torch.from_numpy(i), 0.05)
    np.testing.assert_allclose(float(pl), float(jl), **TOL1)
    assert float(pa) == float(ja) and 0.0 < float(pa) < 1.0


def test_synthetic_retrieval_batches_are_bitwise_jax_batches():
    args = dict(query_vocab_sizes=(11, 23, 300), item_vocab=300,
                num_dense=3, batch_size=64, seed=5)
    for unique in (True, False):
        for jb, pb in zip(JaxRetrieval(**args, unique_items=unique).batches(3),
                          SyntheticRetrieval(**args,
                                             unique_items=unique).batches(3)):
            for key in ("dense", "q_cat", "item_ids"):
                assert jb[key].dtype == pb[key].dtype
                np.testing.assert_array_equal(pb[key], jb[key])


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name", ["sgd", "adagrad_indexer", "lazy_adam"])
def test_three_train_steps_match_jax(opt_name, jax_steps):
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name)
    jstep = jax_steps(jcfg, opt_name, jopt)
    pstep = PT.make_train_step(pcfg, sparse_opt=popt)
    for i, b in enumerate(_batches(3)):
        jm, (jl, ja) = jstep(jm, *_jargs(b))
        pl, pa = pstep(pm, b["dense"], b["q_cat"], b["item_ids"])
        assert abs(float(pl) - float(jl)) <= 1e-4
        assert float(pa) == float(ja)
        if i in (0, 2):
            _assert_models_close(pm, jm, TOL1 if i == 0 else TOL3)


def test_train_step_defaults_and_generator():
    step = PT.make_train_step(ett.TwoTowerConfig(**SMALL))
    (_, _, _), (pcfg, _, pm) = _pair()
    before = pm.item_data.clone()
    b = _batches(1)[0]
    step(pm, b["dense"], b["q_cat"], b["item_ids"])      # SparseSGD(0.05)
    touched = np.unique(b["item_ids"])
    moved = (pm.item_data != before).any(1).nonzero().squeeze(1).numpy()
    assert set(moved) <= set(touched) and moved.size > 0
    sr = PT.make_train_step(pcfg, sparse_opt=P.SparseSGD(
        stochastic_rounding=True))
    with pytest.raises(ValueError, match="generator="):
        sr(pm, b["dense"], b["q_cat"], b["item_ids"])


# ---------------------------------------------------------------------------
# Index and retrieval
# ---------------------------------------------------------------------------

def test_item_index_and_retrieval_match_jax():
    (_, _, jm), (pcfg, _, pm) = _pair()
    want_index = np.asarray(JT.build_item_index(jm, batch=128))
    index = PT.build_item_index(pm, batch=128)        # 3 batches, ragged
    assert index.shape == (300, 8)
    np.testing.assert_allclose(index.numpy(), want_index, **TOL1)
    b = _batches(1, seed=9)[0]
    js, ji = JT.retrieve(jm, jnp.asarray(want_index), jnp.asarray(b["dense"]),
                         jnp.asarray(b["q_cat"]), k=10)
    # Distinct scores: the ids are the same whatever the tie rule.
    assert all(np.unique(np.asarray(js)[r]).size == 10 for r in range(B))
    run = PT.make_retriever(pm, k=10)
    for ps, pi in (run(index, b["dense"], b["q_cat"]),
                   PT.retrieve(pm, index, b["dense"], b["q_cat"], k=10)):
        assert pi.dtype == torch.int32 and pi.shape == (B, 10)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL1)
    # Updated parameters served without rebuilding the retriever.
    zero = [(torch.zeros_like(w), torch.zeros_like(bb))
            for w, bb in pm.query_mlp]
    scores, _ = run(index, b["dense"], b["q_cat"], query_mlp=zero)
    assert float(scores.abs().max()) == 0.0
    assert recall_at_k(b["item_ids"], ji) == jax_recall(b["item_ids"], ji)


def test_topk_ties_give_the_tied_scores_in_descending_order():
    # The divergence on ties (ROADMAP queue 3): JAX's top_k puts the lower
    # id first among equal scores; torch.topk promises no order. Pinned: the
    # port returns the k largest scores in descending order, and each id
    # carries its own score.
    (_, _, _), (pcfg, _, pm) = _pair()
    index = torch.zeros((300, 8))
    index[:, 0] = torch.tensor([float(j % 3) for j in range(300)])
    b = _batches(1, seed=2)[0]
    scores, ids = PT.make_retriever(pm, k=10)(index, b["dense"], b["q_cat"])
    q = PT.query_embed_from_rows(pm.query_mlp, pcfg,
                                 torch.from_numpy(b["dense"]),
                                 PT._query_rows(pm, b["q_cat"])).detach()
    full = q @ index.T
    want = torch.sort(full, dim=-1, descending=True).values[:, :10]
    torch.testing.assert_close(scores, want)
    torch.testing.assert_close(torch.gather(full, 1, ids.long()), scores)
    assert (scores[:, :-1] >= scores[:, 1:]).all()


# ---------------------------------------------------------------------------
# The loop and the service
# ---------------------------------------------------------------------------

def test_train_two_tower_matches_jax():
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair()
    evals = _batches(2, seed=99)
    jres = jax_train_two_tower(jcfg, iter(_batches(4)), 4, sparse_opt=jopt,
                               model=jm, eval_batches=evals, eval_every=2,
                               k=10, log_every=1, verbose=False)
    pres = ett.train_two_tower(pcfg, iter(_batches(4)), 4, sparse_opt=popt,
                               model=pm, eval_batches=evals, eval_every=2,
                               k=10, log_every=1, verbose=False)
    assert pres.model is pm and len(pres.losses) == 4
    np.testing.assert_allclose(pres.losses, jres.losses, **TOL3)
    np.testing.assert_allclose(pres.accs, jres.accs, **TOL3)
    assert [s for s, _ in pres.recalls] == [s for s, _ in jres.recalls] \
        == [2, 4]
    np.testing.assert_allclose([r for _, r in pres.recalls],
                               [r for _, r in jres.recalls], **TOL3)
    assert pres.examples_per_sec > 0


def test_retrieval_service_gives_the_retrievers_results():
    (_, _, _), (pcfg, _, pm) = _pair()
    svc = ett.make_retrieval_service(pm, k=5, max_batch=32,
                                     max_latency_ms=1.0)
    try:
        b = _batches(1, seed=4)[0]
        reqs = [(b["dense"][:n], b["q_cat"][:, :n]) for n in (1, 7, 32)]
        futs = [svc.submit(d, c) for d, c in reqs]
        index = PT.build_item_index(pm)
        run = PT.make_retriever(pm, k=5)
        for (d, c), fut in zip(reqs, futs):
            scores, ids = fut.result(timeout=30)
            want_s, want_i = run(index, d, c)
            assert ids.dtype == np.int32 and ids.shape == (d.shape[0], 5)
            np.testing.assert_array_equal(ids, want_i.numpy())
            np.testing.assert_allclose(scores, want_s.numpy(), rtol=1e-6,
                                       atol=1e-6)
    finally:
        svc.stop()
    # A mesh is ported: the service reaches the (here fake) mesh.
    with pytest.raises(AttributeError):
        ett.make_retrieval_service(pm, mesh=object())


@pytest.mark.parametrize("name", ["mesh", "plan", "delta_ckpt",
                                  "ckpt_manager", "device_prefetch"])
def test_train_two_tower_options_not_ported_raise(name):
    # Every option is ported, beside a mesh and a plan too (the planned
    # two-tower model, item I-3b): each comes with a (here fake) mesh and a
    # plan pair, and the planned loop reaches the fake mesh with it; with
    # delta_ckpt JAX's own error on a plan beside delta checkpoints comes
    # first (JAX's train_two_tower raises it before anything too).
    import types
    from embeddingtables_tpu_torch.parallel import plan_sharding
    cfg = ett.TwoTowerConfig(**SMALL)
    shape = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    plans = (plan_sharding(cfg.query_vocab_sizes, cfg.dim, shape),
             plan_sharding([cfg.item_vocab], cfg.dim, shape))
    value = {"device_prefetch": 2, "plan": plans}.get(name, object())
    kw = {"mesh": object(), "plan": plans, name: value}
    if name == "delta_ckpt":
        kw["delta_every"] = 2
        with pytest.raises(NotImplementedError, match="delta checkpointing"):
            ett.train_two_tower(cfg, iter(()), 1, device="cpu", **kw)
    else:
        with pytest.raises(AttributeError):      # reaches the fake mesh
            ett.train_two_tower(cfg, iter(()), 1, device="cpu", **kw)
    kw.pop("plan")
    with pytest.raises(AttributeError):          # reaches the fake mesh
        ett.train_two_tower(cfg, iter(()), 1, device="cpu", **kw)
    with pytest.raises(TypeError, match="guard"):
        ett.train_two_tower(cfg, iter(()), 1, device="cpu", guard=object())


def test_init_two_tower_shapes_and_states():
    cfg = ett.TwoTowerConfig(**SMALL)
    m = ett.init_two_tower(cfg, torch.Generator().manual_seed(0),
                           device="cpu",
                           sparse_opt=P.SparseRowWiseAdaGrad(initial_accum=0.5))
    assert m.query_tables.data.shape == (334, 8)
    assert m.item_data.shape == (300, 8)
    assert [tuple(w.shape) for w, _ in m.query_mlp] == [(27, 16), (16, 8)]
    assert [tuple(w.shape) for w, _ in m.item_mlp] == [(8, 16), (16, 8)]
    assert torch.equal(m.q_state.accum, torch.full((334,), 0.5))
    assert torch.equal(m.i_state.accum, torch.full((300,), 0.5))
    assert m.item_table.rows(torch.tensor([3])).shape == (1, 8)
