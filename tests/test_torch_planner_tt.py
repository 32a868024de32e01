"""The rest of the port's planner (`parallel/planner.py`): tables of mixed
dims (`plan_sharding_mixed`, `MixedDimPlannedTables`, `mixed_planned_lookup`,
`mixed_planned_apply`) and the planned two-tower retriever
(`PlannedTwoTower`, its step, index, retrieval and `train_two_tower(mesh=,
plan=)`), on a 4-rank gloo group against JAX's functions on its
`local_mesh(4)`, the same tables and global batches, each rank on its block;
on a one-rank group the planned two-tower step is bitwise the single-device
step. The same pool runs the DLRM command line with `--mesh --auto-shard`.

Tolerances are JAX's own tests' (`tests/test_planner.py`,
`test_planner_opt.py`, `test_planner_tt.py`): mixed-dim lookups rtol 1e-6,
tables after an update rtol 2e-5 / atol 1e-6 (lazy Adam over two steps rtol
2e-4 / atol 1e-6); the two-tower losses rtol 1e-4, tables and towers rtol
5e-4 / atol 1e-5, the index rtol 1e-5 / atol 1e-6, retrieved scores rtol
1e-5 / atol 1e-6 with the ids equal as sets per row (ties may reorder
them). The replicated group is bitwise equal on every rank after every
step.

The two-tower plans: the query tables `TT["query_vocab_sizes"] = (11, 23,
40)` at D = 8 with `replicate_max_bytes=353` and `col_shard=[2]` (table 0
replicates, table 1 row-shards, table 2 column-shards: 2 columns a rank);
the 60-item corpus row-shards (`replicate_max_bytes=1`).
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from embeddingtables_tpu import optim as JO
from embeddingtables_tpu.models import train as JT
from embeddingtables_tpu.models import two_tower as JTT
from embeddingtables_tpu.parallel import planner as JPL
from embeddingtables_tpu.parallel.mesh import local_mesh
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as PO
from embeddingtables_tpu_torch.parallel import planner as PPL
from _torch_mesh import MeshPool
from _torch_persist import TT, pair
from _torch_threads import _one_torch_thread  # noqa: F401
from test_torch_planner import jax_dense
from test_torch_sharded_families import family_arrays, global_batches

MIXED_LOOKUP = dict(rtol=1e-6)
MIXED_TABLE = dict(rtol=2e-5, atol=1e-6)
ADAM_TABLE = dict(rtol=2e-4, atol=1e-6)
TT_STEP = dict(rtol=1e-4)
TT_TABLE = dict(rtol=5e-4, atol=1e-5)
INDEX = dict(rtol=1e-5, atol=1e-6)
Q_KW = dict(replicate_max_bytes=11 * 8 * 4 + 1, col_shard=[2])
I_KW = dict(replicate_max_bytes=1)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("planner_tt")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool1(tmp_path_factory):
    p = MeshPool(1, str(tmp_path_factory.mktemp("planner_tt1")))
    yield p
    p.close()


def jmesh():
    return local_mesh(4)


# ---------------------------------------------------------------------------
# Mixed dims
# ---------------------------------------------------------------------------

MIXED_OPTS = {"sgd": (JO.SparseSGD(0.2), PO.SparseSGD(0.2)),
              "adagrad": (JO.SparseRowWiseAdaGrad(lr=0.1, eps=1e-6),
                          PO.SparseRowWiseAdaGrad(lr=0.1, eps=1e-6)),
              "adam": (JO.SparseLazyAdam(0.05), PO.SparseLazyAdam(0.05))}


def mixed_steps(vocabs, dims, n, b, seed):
    rng = np.random.default_rng(seed)
    return [([rng.integers(0, v, b).astype(np.int32) for v in vocabs],
             [rng.standard_normal((b, d)).astype(np.float32) for d in dims])
            for _ in range(n)]


def jax_mixed(vocabs, dims, plan_kw, tables, jopt, steps):
    """JAX's mixed-dim plan and placement of `tables`, and after each step
    its lookups (of the step's ids, before the update) and dense groups."""
    mesh = jmesh()
    plans, groups = JPL.plan_sharding_mixed(list(vocabs), list(dims), mesh,
                                            **plan_kw)
    mt = JPL.MixedDimPlannedTables.from_tables(
        plans, groups, mesh, [jnp.asarray(t) for t in tables],
        sparse_opt=jopt)
    look = jax.jit(lambda m, i: JPL.mixed_planned_lookup(mesh, m, i))
    apply = jax.jit(lambda m, i, d: JPL.mixed_planned_apply(mesh, m, i, d,
                                                            jopt))
    out = []
    for idx, deltas in steps:
        idx = [jnp.asarray(i) for i in idx]
        got = [np.asarray(x) for x in look(mt, idx)]
        mt = apply(mt, idx, [jnp.asarray(d) for d in deltas])
        out.append({"lookup": got,
                    "groups": [jax_dense(pt) for pt in mt.groups]})
    return plans, groups, out


def assert_groups_close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["tables"], w["tables"], **tol)
        assert len(g["state"]) == len(w["state"])
        for a, b in zip(g["state"], w["state"]):
            np.testing.assert_allclose(a, b, **tol)
        assert sorted(g["counts"]) == sorted(w["counts"])


@pytest.mark.parametrize("case", ["sgd", "adam"])
def test_mixed_dim_plan_lookup_and_apply_match_jax(pool, case):
    """JAX's `test_mixed_dim_plan_and_lookup_apply` (SGD) and
    `test_mixed_dim_planner_adam` (lazy Adam, two steps): the groups and
    placements, the lookups, the groups' tables and state after each
    step, and the replicated groups' bits on every rank."""
    if case == "sgd":
        vocabs, dims, kw = (64, 4096, 96, 2048), (8, 16, 8, 16), dict(
            replicate_max_bytes=16 * 4 * 128)
        n, seed, tol = 1, 7, MIXED_TABLE
    else:
        vocabs, dims, kw = (64, 2048, 96, 80), (8, 16, 8, 16), dict(
            replicate_max_bytes=16 * 4 * 80)
        n, seed, tol = 2, 29, ADAM_TABLE
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((v, d)).astype(np.float32)
              for v, d in zip(vocabs, dims)]
    steps = mixed_steps(vocabs, dims, n, 16, seed + 1)
    jopt, popt = MIXED_OPTS[case]
    got = pool.submit("mixed_ops", vocabs, dims, kw, tables, popt, steps)
    plans, groups, want = jax_mixed(vocabs, dims, kw, tables, jopt, steps)
    got = got()
    assert got[0]["groups"] == [list(g) for g in groups]
    assert got[0]["placements"] == [[d.placement for d in p.decisions]
                                    for p in plans]
    if case == "sgd":
        assert groups == ((0, 2), (1, 3))
        assert got[0]["placements"] == [["replicate"] * 2, ["row_shard"] * 2]
    for s, w in enumerate(want):
        for t in range(len(vocabs)):
            np.testing.assert_allclose(got[0]["steps"][s]["lookup"][t],
                                       w["lookup"][t], **MIXED_LOOKUP)
        assert_groups_close(got[0]["steps"][s]["groups"], w["groups"], tol)
        for r in got[1:]:
            assert r["steps"][s]["bits"] == got[0]["steps"][s]["bits"]


def test_mixed_dim_init_and_adagrad_match_jax(pool):
    """JAX's `test_mixed_dim_init_and_adagrad`: `MixedDimPlannedTables.init`
    with AdaGrad state (the port's generator, not JAX's key: JAX's step
    runs on the port's initial tables), then one AdaGrad step; and the
    dims/vocabs mismatch."""
    vocabs, dims = (64, 2048), (8, 16)
    kw = dict(replicate_max_bytes=8 * 4 * 128, opt_state_scalars=1)
    jopt, popt = MIXED_OPTS["adagrad"]
    steps = mixed_steps(vocabs, dims, 1, 16, 3)
    got = pool.run("mixed_ops", vocabs, dims, kw, None, popt, steps,
                   init_seed=0)
    init = got[0]["init"]
    assert [t.shape for t in init] == [(64, 8), (2048, 16)]
    for r in got[1:]:
        for a, b in zip(r["init"], init):
            np.testing.assert_array_equal(a, b)
    _, _, want = jax_mixed(vocabs, dims, kw, init, jopt, steps)
    assert_groups_close(got[0]["steps"][0]["groups"], want[0]["groups"],
                        MIXED_TABLE)
    mesh = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    with pytest.raises(ValueError, match="dims"):
        PPL.plan_sharding_mixed((10, 20), (8,), mesh)


def test_mixed_plan_budgets_are_global_as_in_jax():
    """JAX's `test_mixed_plan_budgets_are_global`: the HBM budget on the
    combined total, the replicate budget consumed across the groups; the
    plans field by field with JAX's."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    with pytest.raises(ValueError, match="mixed plan"):
        PPL.plan_sharding_mixed((80_000, 80_000), (8, 16), mesh,
                                replicate_max_bytes=0,
                                hbm_budget_bytes=int(0.7 * 2**20))
    kw = dict(replicate_max_bytes=1 << 20, replicate_budget_bytes=20_000)
    args = ((100, 200, 100, 200), (8, 8, 16, 16))
    plans, groups = PPL.plan_sharding_mixed(*args, mesh, **kw)
    jplans, jgroups = JPL.plan_sharding_mixed(*args, jmesh(), **kw)
    assert groups == jgroups
    assert [[d.placement for d in p.decisions] for p in plans] == [
        ["replicate", "replicate"], ["replicate", "row_shard"]]
    for p, j in zip(plans, jplans):
        assert p.summary() == j.summary()
        assert p.bytes_per_device == j.bytes_per_device


def test_mixed_groups_draw_their_noise_from_one_generator_in_order(pool):
    """Divergence pin (ROADMAP.md queue 3, "Mixed-dim stochastic rounding"):
    JAX folds each group's index into its key; the port's groups draw from
    the one generator, one after the other, so `mixed_planned_apply` is
    each group's `planned_apply` in group order on one generator."""
    vocabs, dims = (40, 900, 30, 700), (8, 16, 8, 16)
    rng = np.random.default_rng(11)
    tables = [rng.standard_normal((v, d)).astype(np.float32)
              for v, d in zip(vocabs, dims)]
    for same, moved in pool.run("mixed_sr_order", vocabs, dims, tables, 5):
        assert same and moved


# ---------------------------------------------------------------------------
# The planned two-tower model
# ---------------------------------------------------------------------------

def jax_tt_plans(mesh=None):
    mesh = mesh or jmesh()
    return (JPL.plan_sharding(TT["query_vocab_sizes"], TT["dim"], mesh,
                              **Q_KW),
            JPL.plan_sharding([TT["item_vocab"]], TT["dim"], mesh, **I_KW))


def jax_tt_out(pm):
    flat = [np.asarray(x, np.float32) for x in
            jax.tree_util.tree_leaves((pm.query_mlp, pm.item_mlp))]
    return {"query": jax_dense(pm.query_tables),
            "items": jax_dense(pm.item_tables), "towers": flat}


def assert_tt_close(got, want):
    for k in ("query", "items"):
        assert_groups_close([got[k]], [want[k]], TT_TABLE)
    assert len(got["towers"]) == len(want["towers"])
    for a, b in zip(got["towers"], want["towers"]):
        np.testing.assert_allclose(a, b, **TT_TABLE)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_planned_tt_step_matches_jax(pool, opt):
    """JAX's `test_planned_tt_step_matches_single_chip`: three planned
    contrastive steps from the same weights and batches, the query stack
    on the three-way plan and the corpus row-sharded; the replicated group
    bitwise on every rank."""
    (jcfg, jopt, jm), (pcfg, popt, _) = pair("two_tower", opt)
    arrays = family_arrays("two_tower", jm)
    data = global_batches("two_tower", n=3, seed=60)
    got = pool.submit("planned_tt_steps", pcfg, arrays, popt, Q_KW, I_KW,
                      data)
    qp, ip = jax_tt_plans()
    mesh = jmesh()
    jpm = JPL.place_two_tower_on_plan(qp, ip, mesh, jm, jopt)
    step = JPL.make_planned_tt_train_step(jcfg, mesh, sparse_opt=jopt,
                                          dense_lr=0.1)
    losses = []
    for b in data:
        jpm, (loss, _) = step(jpm, *(jnp.asarray(x) for x in b))
        losses.append(float(loss))
    got = got()
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, **TT_STEP)
        assert g["bits"] == got[0]["bits"]
    assert_tt_close(got[0], jax_tt_out(jpm))


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_one_rank_planned_tt_step_is_bitwise_the_single_device_step(
        pool1, opt):
    """On one rank, under a hand-made plan of every placement (query tables
    replicated, row- and column-sharded; the corpus row-sharded), two
    planned steps are bitwise the single-device `make_train_step`."""
    (_, _, jm), (pcfg, popt, _) = pair("two_tower", opt)
    places = (("replicate", "row_shard", "col_shard"), ("row_shard",))
    bad, = pool1.run("planned_tt_bitwise", pcfg, family_arrays(
        "two_tower", jm), popt, global_batches("two_tower", n=2, seed=61),
                     places)
    assert bad == []


def test_planned_retrieval_matches_jax(pool):
    """JAX's `test_planned_retrieval_matches_single_chip`: the index over
    all 60 items in chunks of 26 (the ragged tail padded to the mesh and
    trimmed), whole on every rank, against JAX's planned index and the
    single-device one; the top 7 of 16 queries against JAX's planned
    retrieval."""
    (_, _, jm), (pcfg, _, _) = pair("two_tower", "sgd")
    arrays = family_arrays("two_tower", jm)
    rng = np.random.default_rng(7)
    dense = rng.standard_normal((16, 3)).astype(np.float32)
    q_cat = np.stack([rng.integers(0, v, 16) for v in
                      TT["query_vocab_sizes"]]).astype(np.int32)
    got = pool.submit("planned_tt_serve", pcfg, arrays, Q_KW, I_KW, 26,
                      dense, q_cat, 7)
    mesh = jmesh()
    qp, ip = jax_tt_plans(mesh)
    jpm = JPL.place_two_tower_on_plan(qp, ip, mesh, jm, JO.SparseSGD(0.1))
    jindex = JPL.planned_build_item_index(mesh, jpm, batch=26)
    np.testing.assert_allclose(np.asarray(jindex), np.asarray(
        JTT.build_item_index(jm, batch=26)), **INDEX)
    ws, wi = JPL.planned_retrieve(mesh, jpm, jindex, dense, q_cat, k=7)
    for index, scores, ids in got():
        np.testing.assert_allclose(index, np.asarray(jindex), **INDEX)
        np.testing.assert_allclose(scores, np.asarray(ws), **INDEX)
        for r in range(16):
            assert set(ids[r].tolist()) == set(np.asarray(wi[r]).tolist())


def test_train_two_tower_with_plan_matches_jax(pool, tmp_path):
    """JAX's `test_train_two_tower_with_plan_learns`, held step by step:
    `train_two_tower(mesh=, plan=)` from the same weights over 4 batches,
    recall@5 every 2 steps; the port's loop also with `device_prefetch=1`
    and a `CheckpointManager` every 2 steps, whose last checkpoint restores
    bitwise into a fresh planned model of the same placement."""
    (jcfg, jopt, jm), (pcfg, popt, _) = pair("two_tower", "adagrad")
    arrays = family_arrays("two_tower", jm)
    data = global_batches("two_tower", n=4, seed=62)
    evals = global_batches("two_tower", n=1, seed=63)
    keys = ("dense", "q_cat", "item_ids")
    got = pool.submit("planned_tt_loop", pcfg, arrays, popt, Q_KW, I_KW,
                      data, evals, str(tmp_path / "ckpt"))
    res = JT.train_two_tower(
        jcfg, iter([dict(zip(keys, b)) for b in data]), len(data),
        model=jm, mesh=jmesh(), plan=jax_tt_plans(), sparse_opt=jopt,
        dense_lr=0.1, log_every=1, eval_every=2, k=5,
        eval_batches=[dict(zip(keys, b)) for b in evals], verbose=False)
    assert isinstance(res.model, JPL.PlannedTwoTower)
    got = got()
    for g in got:
        assert g["type"] == "PlannedTwoTower" and g["step"] == 4
        assert g["restored_bitwise"]
        np.testing.assert_allclose(g["losses"], res.losses, **TT_STEP)
        assert [s for s, _ in g["recalls"]] == [s for s, _ in res.recalls]
        np.testing.assert_allclose([r for _, r in g["recalls"]],
                                   [r for _, r in res.recalls], atol=1e-6)
    assert_tt_close(got[0], jax_tt_out(res.model))


def test_train_two_tower_plan_validations():
    """JAX's `test_train_two_tower_plan_validations`, in JAX's order: a
    plan without a mesh, delta checkpoints with a plan, a model that is no
    two-tower model, and an item plan that is not a single-table plan over
    `(item_vocab,)`."""
    from embeddingtables_tpu_torch.models.train import train_two_tower
    cfg = ett.TwoTowerConfig(**TT)
    mesh = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    qp = PPL.plan_sharding(TT["query_vocab_sizes"], TT["dim"], mesh, **Q_KW)
    ip = PPL.plan_sharding([TT["item_vocab"]], TT["dim"], mesh, **I_KW)
    with pytest.raises(ValueError, match="plan= requires mesh"):
        train_two_tower(cfg, iter([]), 1, plan=(qp, ip), device="cpu")
    with pytest.raises(NotImplementedError, match="delta"):
        train_two_tower(cfg, iter([]), 1, mesh=mesh, plan=(qp, ip),
                        delta_ckpt=(object(), object()), delta_every=5,
                        device="cpu")
    with pytest.raises(TypeError, match="PlannedTwoTower"):
        train_two_tower(cfg, iter([]), 1, mesh=mesh, plan=(qp, ip),
                        model=object(), device="cpu")
    bad = PPL.plan_sharding([TT["item_vocab"] + 1], TT["dim"], mesh)
    with pytest.raises(ValueError, match="single-table plan"):
        PPL.init_planned_two_tower(cfg, qp, bad, mesh)
    with pytest.raises(ValueError, match="single-table plan"):
        PPL.place_two_tower_on_plan(qp, qp, mesh, types.SimpleNamespace(
            config=cfg), None)


# ---------------------------------------------------------------------------
# The DLRM command line on the mesh
# ---------------------------------------------------------------------------

def test_dlrm_cli_with_mesh_and_auto_shard_trains_on_the_plan(pool):
    """`train_dlrm.main([... --mesh --auto-shard --device cpu])` on every
    rank of the formed group: `plan_sharding` as JAX's command calls it
    (each 40,000 x 32 table is over the 4 MiB replicate limit, so it
    row-shards), the planned DLRM trained for 3 steps with finite losses,
    the same on every rank."""
    argv = ["--mesh", "--auto-shard", "--device", "cpu", "--steps", "3",
            "--batch", "64", "--tables", "3", "--vocab", "40000", "--dim",
            "32", "--log-every", "1", "--opt", "sgd", "--lr", "0.1"]
    got = pool.run("cli_mesh", argv)
    for g in got:
        assert g["type"] == "PlannedDLRM"
        assert g["placements"] == ["row_shard"] * 3
        assert len(g["losses"]) == 3 and np.all(np.isfinite(g["losses"]))
        assert g["losses"] == got[0]["losses"]
