"""The port's sharded DCN, DeepFM (both layouts, the ablations) and two-tower
retriever (`parallel/{dcn,deepfm,two_tower}.py`), their loops with `mesh=`
and their mesh services, on a 4-rank gloo group, against JAX's sharded
functions on its `local_mesh(4)` and `(2, 2)` ("data", "model") mesh: the
same weights (`*_from_arrays`), the same global batches, each rank stepping
on its data block. Tolerances are JAX's own sharded tests': CTR losses rtol
1e-5 and tables rtol 2e-4 / atol 1e-6 (`tests/test_sharded_dcn.py`,
`test_sharded_deepfm.py`); the two-tower model's losses rtol 1e-4 and its
tables and towers rtol 5e-4 / atol 1e-5 (`test_sharded_two_tower.py`).
Evals and served scores rtol 1e-5 / atol 1e-6; retrieval scores rtol 1e-5,
ids equal wherever the scores are distinct (ROADMAP.md queue 3, "Top-k
ties"). On a one-rank group each sharded step is bitwise the port's
single-device step (SGD and indexer AdaGrad).
"""
import numpy as np
import pytest

import jax

from embeddingtables_tpu.models import train as JT
from embeddingtables_tpu.models import two_tower as JTT
from embeddingtables_tpu.parallel import dcn as JPC
from embeddingtables_tpu.parallel import deepfm as JPF
from embeddingtables_tpu.parallel import dlrm as JP
from embeddingtables_tpu.parallel import two_tower as JPT
from embeddingtables_tpu.parallel.mesh import default_mesh, local_mesh
from embeddingtables_tpu import serving as JS
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.data import SyntheticCriteo
from _torch_mesh import MeshPool
from _torch_persist import TT, VOCABS, arrays, batches, pair
from _torch_threads import _one_torch_thread  # noqa: F401

AXES = {"1d": "data", "2d": ("data", "model")}
CTR = ("dcn", "deepfm_folded", "deepfm_unfolded")
STEP = dict(rtol=1e-5)
TABLE = dict(rtol=2e-4, atol=1e-6)
TT_STEP = dict(rtol=1e-4)
TT_TABLE = dict(rtol=5e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("mesh")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool1(tmp_path_factory):
    p = MeshPool(1, str(tmp_path_factory.mktemp("mesh1")))
    yield p
    p.close()


def jax_mesh(kind):
    if kind == "1d":
        return local_mesh(4)
    return default_mesh(("data", "model"), shape=(2, 2),
                        devices=jax.devices()[:4])


def base(family):
    return family.split("_")[0] if family.startswith("deepfm") else family


def state_arrays(st):
    return None if st is None else {k: np.asarray(v)
                                    for k, v in st._asdict().items()}


def family_arrays(family, jm):
    """The JAX model's weights as the port's `*_from_arrays` keywords."""
    if family == "two_tower":
        return dict(query_mlp=arrays(jm.query_mlp),
                    item_mlp=arrays(jm.item_mlp),
                    query_table_data=np.asarray(jm.query_tables.data),
                    offsets=jm.query_tables.offsets,
                    item_data=np.asarray(jm.item_table.data),
                    q_state=state_arrays(jm.q_state),
                    i_state=state_arrays(jm.i_state))
    common = dict(table_data=np.asarray(jm.tables.data),
                  offsets=jm.tables.offsets,
                  emb_state=state_arrays(jm.emb_state))
    if family == "dlrm":
        return dict(common, bottom=arrays(jm.bottom), top=arrays(jm.top))
    if family == "dcn":
        return dict(common, cross=arrays(jm.cross), deep=arrays(jm.deep),
                    head=arrays([jm.head])[0])
    return dict(common, deep=arrays(jm.deep), head=arrays([jm.head])[0],
                dense_w=np.asarray(jm.dense_w), bias=np.asarray(jm.bias),
                fm_w_data=None if jm.fm_w is None
                else np.asarray(jm.fm_w.data),
                fm_state=state_arrays(jm.fm_state))


def jax_out(m):
    """A JAX single-device model as `_torch_mesh.model_out` lays it out."""
    flat = lambda t: [np.asarray(x, np.float32)  # noqa: E731
                      for x in jax.tree_util.tree_leaves(t)]
    if hasattr(m, "query_tables"):
        return {"tables": np.asarray(m.query_tables.data),
                "items": np.asarray(m.item_table.data),
                "state": flat(m.q_state) + flat(m.i_state),
                "towers": flat((m.query_mlp, m.item_mlp))}
    if hasattr(m, "bottom"):
        towers = flat((m.bottom, m.top))
    elif hasattr(m, "cross"):
        towers = flat((m.cross, m.deep, m.head))
    else:
        towers = flat((m.deep, m.head, m.dense_w, m.bias))
    out = {"tables": np.asarray(m.tables.data), "state": flat(m.emb_state),
           "towers": towers}
    if getattr(m, "fm_w", None) is not None:
        out["fm"] = np.asarray(m.fm_w.data)
        out["state"] += flat(m.fm_state)
    return out


def assert_model_close(got, want, tol):
    assert set(got) >= set(want)
    for k in want:
        g = got[k] if isinstance(got[k], list) else [got[k]]
        w = want[k] if isinstance(want[k], list) else [want[k]]
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, err_msg=k, **tol)


JAPI = {"dcn": (JPC.shard_dcn, JPC.make_sharded_dcn_train_step,
                JPC.make_sharded_dcn_eval_step, JPC.unshard_dcn),
        "deepfm": (JPF.shard_deepfm, JPF.make_sharded_deepfm_train_step,
                   JPF.make_sharded_deepfm_eval_step, JPF.unshard_deepfm),
        "two_tower": (JPT.shard_two_tower, JPT.make_sharded_tt_train_step,
                      None, JPT.unshard_two_tower)}


def global_batches(family, n=2, seed=6, b=16, **kw):
    """n global batches as tuples in the step's argument order."""
    if kw:
        data = SyntheticCriteo(vocab_sizes=VOCABS, num_dense=3, batch_size=b,
                               seed=seed, **kw).batches(n)
    else:
        it = batches(family, seed=seed, b=b)
        data = [next(it) for _ in range(n)]
    keys = (("dense", "q_cat", "item_ids") if family == "two_tower"
            else ("dense", "cat", "label"))
    return [tuple(np.asarray(d[k]) for k in keys) for d in data]


def jax_steps(family, kind, jcfg, jopt, jm, data, **step_kw):
    mesh, axis = jax_mesh(kind), AXES[kind]
    shard, make, _, unshard = JAPI[base(family)]
    sm = shard(jm, mesh, axis, sparse_opt=jopt)
    step = make(jcfg, mesh, axis, sparse_opt=jopt, dense_lr=0.1, **step_kw)
    put = (JPT.tt_batch_shardings if family == "two_tower"
           else JP.batch_shardings)(mesh, axis)
    losses = []
    for batch in data:
        sm, out = step(sm, *(jax.device_put(x, s)
                             for x, s in zip(batch, put)))
        losses.append(float(out[0] if isinstance(out, tuple) else out))
    return losses, jax_out(unshard(sm))


def run_case(pool, family, opt, kind="1d", cfg_kw=None, data_kw=None,
             step_kw=None):
    (jcfg, jopt, jm), (pcfg, popt, _) = pair(family, opt, **(cfg_kw or {}))
    data = global_batches(family, **(data_kw or {}))
    got = pool.submit("family_steps", AXES[kind], base(family), pcfg,
                      family_arrays(family, jm), popt, data, step_kw)
    losses, want = jax_steps(family, kind, jcfg, jopt, jm, data,
                             **(step_kw or {}))
    got = got()
    step_tol, table_tol = ((TT_STEP, TT_TABLE) if family == "two_tower"
                           else (STEP, TABLE))
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, **step_tol)
    assert_model_close(got[0], want, table_tol)
    return got


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("family", CTR + ("two_tower",))
def test_sharded_step_matches_jax(pool, family, opt):
    run_case(pool, family, opt)


@pytest.mark.parametrize("family", CTR + ("two_tower",))
def test_sharded_step_on_the_2d_mesh_matches_jax(pool, family):
    run_case(pool, family, "adagrad", kind="2d")


@pytest.mark.parametrize("family", CTR)
def test_sharded_step_with_padded_mean_bags_matches_jax(pool, family):
    run_case(pool, family, "adagrad",
             cfg_kw=dict(bag=3, combiner="mean", pad_idx=-1),
             data_kw=dict(bag=3, pad_idx=-1))


@pytest.mark.parametrize("ablation", [dict(use_fm=False),
                                      dict(use_deep=False)])
def test_sharded_deepfm_ablations_match_jax(pool, ablation):
    """`use_fm=False` takes no first-order exchange; `use_deep=False`
    trains the FM alone (its placeholder head stays zero)."""
    run_case(pool, "deepfm_unfolded", "sgd", cfg_kw=ablation)


def test_sharded_microbatch_matches_jax(pool):
    run_case(pool, "dcn", "sgd", step_kw=dict(microbatch=2))


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("family", CTR + ("two_tower",))
def test_one_rank_is_bitwise_the_single_device_step(pool1, family, opt):
    (_, _, jm), (pcfg, popt, _) = pair(family, opt)
    bad, = pool1.run("family_bitwise", base(family), pcfg,
                     family_arrays(family, jm), popt,
                     global_batches(family, n=2))
    assert bad == []


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("family", CTR)
def test_sharded_eval_matches_jax(pool, family, kind):
    (jcfg, jopt, jm), (pcfg, _, _) = pair(family, "sgd")
    dense, cat, _ = global_batches(family, n=1, seed=5)[0]
    mesh, axis = jax_mesh(kind), AXES[kind]
    shard, _, make_eval, _ = JAPI[base(family)]
    sd, sc, _ = JP.batch_shardings(mesh, axis)
    want = make_eval(jcfg, mesh, axis)(shard(jm, mesh, axis), jax.device_put(
        dense, sd), jax.device_put(cat, sc))
    for got in pool.run("family_eval", axis, base(family), pcfg,
                        family_arrays(family, jm), dense, cat):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("family", CTR + ("two_tower",))
def test_unshard_gives_back_the_model(pool, family):
    (_, _, jm), (pcfg, popt, _) = pair(family, "adagrad")
    for g in pool.run("family_steps", "data", base(family), pcfg,
                      family_arrays(family, jm), popt, []):
        assert_model_close(g, jax_out(jm), dict(rtol=0, atol=0))


def tt_model(item_vocab, seed=3):
    cfg = dict(TT, item_vocab=item_vocab)
    jcfg, pcfg = JTT.TwoTowerConfig(**cfg), ett.TwoTowerConfig(**cfg)
    jm = JTT.init_two_tower(jax.random.key(seed), jcfg)
    return jcfg, pcfg, jm


def assert_ids_match_where_scores_differ(got_s, got_i, want_s, want_i):
    """Scores within rtol 1e-5; ids equal at every position whose score
    ties no other score of its row (ROADMAP.md queue 3, "Top-k ties")."""
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
    for s, gi, wi in zip(want_s, got_i, want_i):
        for j in range(len(s)):
            if np.sum(np.isclose(s, s[j], rtol=1e-5, atol=1e-6)) == 1:
                assert gi[j] == wi[j]


@pytest.mark.parametrize("k", [1, 5])
def test_sharded_retriever_matches_jax(pool, k):
    """61 items over 4 ranks: 16 rows a block, the last block's 3 padded
    rows repeat item 60 and are masked; each rank embeds its block."""
    jcfg, pcfg, jm = tt_model(61)
    rng = np.random.default_rng(4)
    dense = rng.standard_normal((7, 3)).astype(np.float32)
    q_cat = np.stack([rng.integers(0, v, 7) for v in TT["query_vocab_sizes"]]
                     ).astype(np.int32)
    mesh = jax_mesh("1d")
    index = JPT.build_sharded_item_index(jm, mesh, "data")
    ws, wi = JPT.sharded_retrieve(jm, index, mesh, dense, q_cat, k=k)
    got = pool.run("tt_retrieve", "data", pcfg,
                   family_arrays("two_tower", jm), dense, q_cat, k)
    full = np.asarray(index)
    for r, (gs, gi, block) in enumerate(got):
        np.testing.assert_allclose(block, full[r * 16:(r + 1) * 16],
                                   rtol=1e-5, atol=1e-6)
        assert gi.max() < 61
        assert_ids_match_where_scores_differ(gs, gi, np.asarray(ws),
                                             np.asarray(wi))


def jax_loop(family, jcfg, jopt, jm, data, **kw):
    keys = (("dense", "q_cat", "item_ids") if family == "two_tower"
            else ("dense", "cat", "label"))
    fn = getattr(JT, "train_" + base(family))
    return fn(jcfg, iter([dict(zip(keys, b)) for b in data]), len(data),
              sparse_opt=jopt, model=jm, mesh=jax_mesh("1d"), axis="data",
              verbose=False, **kw)


@pytest.mark.parametrize("family", CTR + ("two_tower",))
def test_train_loop_on_a_mesh_matches_jax(pool, family):
    """Both loops on the same global batches with an eval every 2 steps:
    AUC for the CTR families, recall@k from the sharded retriever for the
    two-tower model (JAX's from the unsharded index: the same items)."""
    (jcfg, jopt, jm), (pcfg, popt, _) = pair(family, "adagrad")
    data = global_batches(family, n=4, seed=7)
    ev = global_batches(family, n=1, seed=8)
    keys = (("dense", "q_cat", "item_ids") if family == "two_tower"
            else ("dense", "cat", "label"))
    evals = [dict(zip(keys, b)) for b in ev]
    kw = dict(dense_lr=0.1, log_every=1, eval_every=2, eval_batches=evals)
    if family == "two_tower":
        kw["k"] = 5
    got = pool.submit("family_loop", "data", base(family), pcfg,
                      family_arrays(family, jm), popt, data, kw)
    res = jax_loop(family, jcfg, jopt, jm, data, **kw)
    got = got()
    want = res.model if family == "two_tower" else \
        JAPI[base(family)][3](res.model)
    step_tol, table_tol = ((TT_STEP, TT_TABLE) if family == "two_tower"
                           else (STEP, TABLE))
    jevals = res.recalls if family == "two_tower" else res.aucs
    for g in got:
        np.testing.assert_allclose(g["losses"], res.losses, **step_tol)
        assert [s for s, _ in g["evals"]] == [s for s, _ in jevals]
        np.testing.assert_allclose([a for _, a in g["evals"]],
                                   [a for _, a in jevals], atol=1e-6)
    assert_model_close(got[0], jax_out(want), table_tol)


def requests_for(family, sizes=(1, 3, 6, 2), seed=9):
    rng = np.random.default_rng(seed)
    vocabs = TT["query_vocab_sizes"] if family == "two_tower" else VOCABS
    return [(rng.standard_normal((b, 3)).astype(np.float32),
             np.stack([rng.integers(0, v, b) for v in vocabs])
             .astype(np.int32)) for b in sizes]


@pytest.mark.parametrize("family", CTR + ("two_tower",))
def test_mesh_service_matches_jax_and_stops_the_followers(pool, family):
    """Rank 0 serves, the other ranks follow each broadcast batch until
    rank 0's stop() releases them (ROADMAP.md queue 3, "Multi-controller
    serving")."""
    (jcfg, _, jm), (pcfg, _, _) = pair(family, "sgd")
    requests = requests_for(family)
    got = pool.run("family_serve", "data", base(family), pcfg,
                   family_arrays(family, jm), requests)
    mesh = jax_mesh("1d")
    kw = dict(mesh=mesh, max_batch=16, max_latency_ms=2.0)
    if family == "two_tower":
        svc = JS.make_retrieval_service(jm, k=5, **kw)
    else:
        svc = getattr(JS, f"make_{base(family)}_service")(
            JAPI[base(family)][0](jm, mesh, "data"), **kw)
    try:
        want = [svc.predict(d, c, timeout=60) for d, c in requests]
    finally:
        svc.stop()
    for g, w in zip(got[0], want):
        if family == "two_tower":
            assert_ids_match_where_scores_differ(g[0], g[1], *w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert all(isinstance(b, int) and b >= 1 for b in got[1:])
    assert len(set(got[1:])) == 1


@pytest.mark.parametrize("family", ["dcn", "deepfm_folded"])
def test_quantized_mesh_service_raises_as_jax_does(family):
    _, (_, _, pm) = pair(family, "sgd")
    make = getattr(ett, f"make_{base(family)}_service")
    with pytest.raises(NotImplementedError, match="single-chip"):
        make(pm, mesh=object(), quantized=True)


@pytest.mark.parametrize("family", ["dcn", "deepfm_folded"])
def test_a_mesh_service_of_a_single_device_model_names_the_planner(family):
    _, (_, _, pm) = pair(family, "sgd")
    make = getattr(ett, f"make_{base(family)}_service")
    with pytest.raises(NotImplementedError, match="I-3"):
        make(pm, mesh=object())
