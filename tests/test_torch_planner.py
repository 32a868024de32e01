"""The port's sharding planner (`parallel/planner.py`) on a 4-rank gloo group
against JAX's on its `local_mesh(4)` (and the (2, 2) mesh): the same plans
field by field, the same tables and global batches, each rank on its block.

Tolerances are JAX's own planner tests': lookups rtol 2e-5 / atol 1e-5;
tables, states and towers after a step rtol 2e-4 / atol 1e-6; losses rtol
1e-5; planned evals and served scores rtol 1e-5 / atol 1e-6. Evictions and
the placement of a carried state are exact. The replicated group must be
bitwise equal on every rank after every step (its gradient is the
run-scatter's, `optim.run_scatter_dense_grad`; JAX's XLA scatter adds in
another order, within these tolerances: ROADMAP.md queue 3).

The three-way plan of the model tests: `VOCABS = (13, 29, 7)` at D = 8 (9
for the folded DeepFM's fused stack) with `col_shard=[1]` and
`replicate_max_bytes=320`: table 2 replicates, table 0 row-shards, table 1
column-shards (2 columns a rank, 3 of a padded 12 for the DeepFM)."""
import dataclasses
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from embeddingtables_tpu import optim as JO
from embeddingtables_tpu import serving as JS
from embeddingtables_tpu.models import train as JT
from embeddingtables_tpu.parallel import dlrm as JP
from embeddingtables_tpu.parallel import planner as JPL
from embeddingtables_tpu.parallel.mesh import default_mesh, local_mesh
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as PO
from embeddingtables_tpu_torch.parallel import planner as PPL
from _torch_mesh import MeshPool
from _torch_persist import VOCABS, pair
from _torch_threads import _one_torch_thread  # noqa: F401
from test_torch_sharded_families import (base, family_arrays,
                                         global_batches)

LOOKUP = dict(rtol=2e-5, atol=1e-5)
TABLE = dict(rtol=2e-4, atol=1e-6)
STEP = dict(rtol=1e-5)
EVAL = dict(rtol=1e-5, atol=1e-6)
DIM = 8
PLAN_KW = dict(col_shard=[1], replicate_max_bytes=320)
THREE_WAY = (100, 400, 60)
THREE_WAY_KW = dict(col_shard=[2], replicate_max_bytes=DIM * 4 * 128)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("planner")))
    yield p
    p.close()


def jmesh(kind="1d"):
    if kind == "1d":
        return local_mesh(4)
    return default_mesh(("data", "model"), shape=(2, 2),
                        devices=jax.devices()[:4])


AXES = {"1d": "data", "2d": ("data", "model")}


def jplan(vocabs, dim, kind="1d", **kw):
    return JPL.plan_sharding(list(vocabs), dim, jmesh(kind), AXES[kind],
                             **kw)


def fields(plan):
    return ([dataclasses.asdict(d) for d in plan.decisions]
            + [plan.n_devices, plan.opt_state_bytes_per_device,
               plan.summary()])


def jax_dense(pt):
    """A JAX `PlannedTables` as `_torch_mesh.planned_dense` lays it out."""
    t = pt.ntables
    per, counts = [[] for _ in range(t)], []

    def leaves(state, v, relayout=lambda x: x):
        out = []
        for x in jax.tree_util.tree_leaves(state):
            x = np.asarray(x)
            if x.ndim == 0:
                counts.append(int(x))
                continue
            x = relayout(x)
            if x.shape[0] == v and v:
                out.append(x)
        return out

    def split(ls, table_ids, offs):
        for j, i in enumerate(table_ids):
            per[i] = [x[offs[j]:offs[j + 1]] for x in ls]

    if pt.repl_tables:
        split(leaves(pt.repl_accum, pt.repl.shape[0]), pt.repl_tables,
              pt.repl_offsets)
    if pt.shard_tables:
        n = pt.shard.data.shape[0]
        vs = pt.shard.offsets[-1]
        split(leaves(pt.shard_accum, vs, lambda x: np.moveaxis(x, 0, 1)
                     .reshape((-1,) + x.shape[2:])[:vs]
                     if x.ndim >= 2 and x.shape[0] == n else x),
              pt.shard_tables, pt.shard.offsets)
    if pt.col_tables:
        vc = pt.col.vocab
        split(leaves(pt.col_accum, vc, lambda x: x.transpose(1, 0, 2)
                     .reshape(vc, -1)[:, :pt.dim] if x.ndim == 3 else x),
              pt.col_tables, pt.col.offsets)
    state = [np.concatenate([per[i][k] for i in range(t)])
             for k in range(len(per[0]))]
    return {"tables": np.concatenate([np.asarray(pt.table(i))
                                      for i in range(t)]),
            "state": state, "counts": counts}


def assert_dense_close(got, want, tol=TABLE):
    np.testing.assert_allclose(got["tables"], want["tables"], **tol)
    assert len(got["state"]) == len(want["state"])
    for a, b in zip(got["state"], want["state"]):
        np.testing.assert_allclose(a, b, **tol)
    assert sorted(got["counts"]) == sorted(want["counts"])


def assert_bits_equal_on_every_rank(got, key="bits"):
    for g in got[1:]:
        assert g[key] == got[0][key]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def fuzz_case(trial):
    """JAX's `test_planner_fuzz_mixed_placements` draw of vocabs, dim and
    threshold."""
    rng = np.random.default_rng(4000 + trial)
    ntab = int(rng.integers(2, 6))
    vocabs = tuple(int(rng.integers(8, 3000)) for _ in range(ntab))
    dim = int(rng.choice([4, 8, 16]))
    thresh = int(rng.choice([0, dim * 4 * 64, dim * 4 * 1024, 1 << 30]))
    return vocabs, dim, dict(replicate_max_bytes=thresh)


PLAN_CASES = {
    **{f"fuzz{t}": fuzz_case(t) for t in range(8)},
    "small_and_large": ((100, 1_000_000, 500), DIM, {}),
    "budget_smallest_first": ((300, 100, 200, 400), DIM, dict(
        replicate_max_bytes=1 << 20, replicate_budget_bytes=DIM * 4 * 320)),
    "hotness": ((300, 100, 200, 400), DIM, dict(
        hotness=[20.0, 1.0, 1.0, 1.0], replicate_max_bytes=1 << 20,
        replicate_budget_bytes=DIM * 4 * 320)),
    "opt_state": ((100, 1_000_000), DIM, dict(opt_state_scalars=1)),
    "col_shard": ((100, 1_000_000, 500), DIM, dict(col_shard=[2],
                                                   opt_state_scalars=1)),
    "skew": ((100, 1_000_000, 1_000_000), DIM, dict(skew=[0.0, 0.4, 0.001])),
    "names_bf16": ((100, 9000), DIM, dict(names=["a", "b"],
                                          replicate_max_bytes=9000 * 16)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_sharding_gives_jax_decisions(pool, case):
    """Field by field, summary included, on the rank's real mesh."""
    vocabs, dim, kw = PLAN_CASES[case]
    pkw = dict(kw)
    jkw = dict(kw)
    if case == "names_bf16":
        import torch
        pkw["dtype"], jkw["dtype"] = torch.bfloat16, jnp.bfloat16
    got = pool.run("planner_plans", "data", [(vocabs, dim, pkw)])
    want = fields(jplan(vocabs, dim, **jkw))
    for g in got:
        assert g[0] == want


def test_plan_errors_match_jax(pool):
    """The budget error, the length checks, col_shard out of range, and
    col_shard and skew on a multi-axis placement (JAX's exceptions)."""
    mesh2 = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(2, 2))
    mesh1 = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    calls = [
        ((100, 1_000_000), DIM, "data", dict(hbm_budget_bytes=1 << 20)),
        ((100, 200), DIM, "data", dict(hotness=[1.0])),
        ((100, 200), DIM, "data", dict(names=["a"])),
        ((100,), DIM, "data", dict(col_shard=[5])),
        ((100, 200), DIM, "data", dict(skew=[0.1])),
        ((100, 200), DIM, ("data", "model"), dict(col_shard=[0])),
        ((100, 200), DIM, ("data", "model"), dict(skew=[0.0, 0.5])),
    ]
    for vocabs, dim, axis, kw in calls:
        kind = "1d" if isinstance(axis, str) else "2d"
        with pytest.raises(Exception) as jerr:
            jplan(vocabs, dim, kind, **kw)
        with pytest.raises(jerr.type) as perr:
            PPL.plan_sharding(vocabs, dim, mesh1 if kind == "1d" else mesh2,
                              axis, **kw)
        assert str(perr.value).split("\n")[0] == \
            str(jerr.value).split("\n")[0]


def test_one_device_replicates_every_table_even_an_explicit_col_shard():
    """On one device every table replicates (the plan reads the mesh's
    shape only: a one-rank `DeviceMesh` reports `(1,)`)."""
    one = types.SimpleNamespace(mesh_dim_names=("data",), shape=(1,))
    got = PPL.plan_sharding([100, 1_000_000], DIM, one, col_shard=[1])
    want = JPL.plan_sharding([100, 1_000_000], DIM, local_mesh(1),
                             col_shard=[1])
    assert fields(got) == fields(want)
    assert got.replicated == (0, 1)


def test_trackers_give_jax_hotness_and_skew():
    from embeddingtables_tpu.utils.rowstats import FrequencyTracker as JF
    from embeddingtables_tpu_torch.utils import FrequencyTracker as PF
    rng = np.random.default_rng(0)
    feeds = [[rng.integers(0, 100, 64) for _ in range(5)],
             [rng.integers(0, 100, (64, 4)) for _ in range(5)], [],
             [np.array([3, 3, 3, 3, 7, 1, 2, 4, 5, 6])]]
    jt = [JF(100, decay=0.9) for _ in feeds]
    pt = [PF(100, decay=0.9) for _ in feeds]
    for j, p, feed in zip(jt, pt, feeds):
        for ids in feed:
            j.observe(ids)
            p.observe(ids)
    assert PPL.hotness_from_trackers(pt) == JPL.hotness_from_trackers(jt)
    assert PPL.skew_from_trackers(pt) == JPL.skew_from_trackers(jt)


# ---------------------------------------------------------------------------
# Executing a plan
# ---------------------------------------------------------------------------

_JAX_OPS = {}


def jax_ops(opt_key, opt, kw, kind="1d"):
    """One jitted JAX `(lookup, apply)` pair per configuration."""
    key = (opt_key, tuple(sorted(kw.items())), kind)
    if key not in _JAX_OPS:
        mesh = jmesh(kind)
        _JAX_OPS[key] = (
            jax.jit(lambda pt, cat: JPL.planned_lookup(mesh, pt, cat, **kw)),
            jax.jit(lambda pt, cat, d: JPL.planned_apply(mesh, pt, cat, d,
                                                         opt, **kw)))
    return _JAX_OPS[key]


OPS = {
    "sgd": lambda m: m.SparseSGD(0.3),
    "adagrad": lambda m: m.SparseRowWiseAdaGrad(lr=0.3, eps=1e-6),
    "adam": lambda m: m.SparseLazyAdam(lr=0.05, b1=0.9, b2=0.99),
    "adam_reg": lambda m: m.SparseLazyAdam(lr=0.05, weight_decay=0.01,
                                           clipnorm=1.0),
    "ftrl": lambda m: m.SparseFTRL(lr=0.2, l1=0.002, l2=0.01),
}


def ops_steps(vocabs, bag, pad, steps=2, seed=0):
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((v, DIM)).astype(np.float32)
              for v in vocabs]
    out = []
    for _ in range(steps):
        shape = (16,) if bag is None else (16, bag)
        cat = np.stack([rng.integers(0, v, shape) for v in vocabs]).astype(
            np.int32)
        if pad is not None:
            cat[rng.random(cat.shape) < 0.3] = pad
        out.append((cat, rng.standard_normal(
            (len(vocabs), 16, DIM)).astype(np.float32)))
    return tables, out


def jax_ops_run(opt_key, vocabs, plan_kw, tables, steps, kw, kind="1d"):
    mesh = jmesh(kind)
    plan = jplan(vocabs, DIM, kind, **plan_kw)
    opt = OPS[opt_key](JO)
    pt = JPL.PlannedTables.from_tables(plan, mesh,
                                       [jnp.asarray(t) for t in tables])
    ra, sa, ca = JPL.planned_row_state(mesh, pt, opt)
    pt = dataclasses.replace(pt, repl_accum=ra, shard_accum=sa,
                             col_accum=ca)
    lookup, apply = jax_ops(opt_key, opt, kw, kind)
    sc = NamedSharding(mesh, P(None, "data"))
    out = []
    for cat, delta in steps:
        c, d = jax.device_put(cat, sc), jax.device_put(delta, sc)
        look = np.asarray(lookup(pt, c))
        pt = apply(pt, c, d)
        out.append({"lookup": look, **jax_dense(pt)})
    return out


@pytest.mark.parametrize("opt_key,bag,pad", [
    ("sgd", None, None), ("adagrad", 3, None), ("adagrad", 3, -1),
    ("sgd", 3, -1), ("adam", None, None), ("adam_reg", 2, None),
    ("ftrl", None, None), ("ftrl", 2, -1)])
def test_three_way_placement_matches_jax(pool, opt_key, bag, pad):
    """Replicate + row-shard + col-shard in ONE plan (JAX's three-way
    matrix with its Adam and FTRL cases): the lookups before each step and
    every group's tables and state after each of two steps, with bags and
    pads; the replicated group bitwise equal on every rank."""
    tables, steps = ops_steps(THREE_WAY, bag, pad, seed=len(opt_key) + 7 * (
        bag or 0))
    kw = {}
    if pad is not None:
        kw = dict(pad_idx=pad, combiner="mean" if bag else "sum")
    got = pool.submit("planner_ops", "data", THREE_WAY, DIM, THREE_WAY_KW,
                      tables, None, OPS[opt_key](PO), steps, kw)
    want = jax_ops_run(opt_key, THREE_WAY, THREE_WAY_KW, tables, steps, kw)
    got = got()
    for g, w in zip(got[0], want):
        np.testing.assert_allclose(g["lookup"], w["lookup"], **LOOKUP)
        assert_dense_close(g, w)
    for step in range(len(steps)):
        assert_bits_equal_on_every_rank([r[step] for r in got])


def test_planner_on_the_2d_mesh_matches_jax(pool):
    """Rows over the data x model product, the batch over data (JAX's
    `test_planner_on_2d_mesh`): replicated and row-sharded groups."""
    vocabs = (64, 400, 96)
    kw = dict(replicate_max_bytes=DIM * 4 * 128)
    tables, steps = ops_steps(vocabs, None, None, steps=1, seed=23)
    want = jax_ops_run("sgd", vocabs, kw, tables, steps, {}, kind="2d")
    got = pool.run("planner_ops", AXES["2d"], vocabs, DIM, kw, tables, None,
                   OPS["sgd"](PO), steps, {})
    np.testing.assert_allclose(got[0][0]["lookup"], want[0]["lookup"],
                               **LOOKUP)
    assert_dense_close(got[0][0], want[0])
    assert_bits_equal_on_every_rank([r[0] for r in got])


@pytest.mark.parametrize("bf16", [False, True])
def test_replicated_group_is_bitwise_equal_on_every_rank(pool, bf16):
    """Three steps on ids that repeat across the ranks' blocks: AdaGrad on
    f32 tables, and SGD with stochastic rounding on bf16 tables (the
    replicated group's noise comes from a generator seeded alike on every
    rank, the other groups' from each rank's own): every rank's replicated
    table and state carry the same bits after each step."""
    tables, steps = ops_steps((30, 400, 60), 2, None, steps=3, seed=5)
    opt = (PO.SparseSGD(0.3, stochastic_rounding=True) if bf16
           else PO.SparseRowWiseAdaGrad(lr=0.3))
    got = pool.run("planner_ops", "data", (30, 400, 60), DIM, THREE_WAY_KW,
                   tables, None, opt, steps, {}, sr_seed=11, bf16=bf16)
    for step in range(3):
        assert_bits_equal_on_every_rank([r[step] for r in got])
    if bf16:
        assert got[0][-1]["tables"].dtype == np.float32   # read back in f32
        assert not np.array_equal(got[0][-1]["tables"][:30], tables[0])


@pytest.mark.parametrize("opt_key", ["adagrad", "adam", "ftrl"])
def test_a_single_device_state_resumes_onto_the_plan_as_in_jax(pool,
                                                               opt_key):
    """`place_stacked_on_plan` with a trained single-device state: each
    group gets its tables' slices (exactly), and evicting rows of all three
    groups zeroes them and their state cells (`evict_rows_planned`)."""
    from embeddingtables_tpu.ops.ensemble import StackedTables as JSt
    rng = np.random.default_rng(9)
    tables = [rng.standard_normal((v, DIM)).astype(np.float32)
              for v in THREE_WAY]
    total = sum(THREE_WAY)
    opt_j, opt_p = OPS[opt_key](JO), OPS[opt_key](PO)
    if opt_key == "adagrad":
        state = [rng.uniform(1, 2, total).astype(np.float32)]
        jstate = JO.SparseOptState(accum=jnp.asarray(state[0]))
    elif opt_key == "adam":
        state = [rng.uniform(0, 1, (total, DIM)).astype(np.float32)
                 for _ in range(2)] + [np.asarray(4, np.int32)]
        jstate = JO.SparseAdamState(*[jnp.asarray(x) for x in state])
    else:
        state = [rng.uniform(0, 1, (total, DIM)).astype(np.float32)
                 for _ in range(2)]
        jstate = JO.SparseFTRLState(*[jnp.asarray(x) for x in state])
    cold = [np.array([3, 10]), np.array([100, 399]), np.array([0, 59])]
    mesh = jmesh()
    plan = jplan(THREE_WAY, DIM, **THREE_WAY_KW)
    st = JSt.stack([jnp.asarray(t) for t in tables])
    jpt = JPL.place_stacked_on_plan(plan, mesh, st, jstate, opt_j)
    placed = jax_dense(jpt)
    want = jax_dense(JPL.evict_rows_planned(jpt, cold))
    got = pool.run("planned_evict", THREE_WAY, DIM, THREE_WAY_KW, tables,
                   opt_p, cold, state)
    assert_dense_close(got[0], want, dict(rtol=0, atol=0))
    np.testing.assert_array_equal(placed["tables"], np.concatenate(tables))
    offs = np.cumsum((0,) + THREE_WAY)
    for t, c in enumerate(cold):
        assert (got[0]["tables"][offs[t] + c] == 0).all()
        for s in got[0]["state"]:
            assert (s[offs[t] + c] == 0).all()


# ---------------------------------------------------------------------------
# The planned families
# ---------------------------------------------------------------------------

JTOWERS = {"dlrm": ("bottom", "top"), "dcn": ("cross", "deep", "head"),
           "deepfm": ("deep", "head", "dense_w", "bias")}
JCLS = {"dlrm": JPL.PlannedDLRM, "dcn": JPL.PlannedDCN,
        "deepfm": JPL.PlannedDeepFM}
JSTEP = {"dlrm": JPL.make_planned_train_step,
         "dcn": JPL.make_planned_dcn_train_step,
         "deepfm": JPL.make_planned_deepfm_train_step}
JEVAL = {"dlrm": JPL.make_planned_eval_step,
         "dcn": JPL.make_planned_dcn_eval_step,
         "deepfm": JPL.make_planned_deepfm_eval_step}
_JAX_STEPS = {}


def plan_dim(family, jcfg):
    return jcfg.stack_dim if base(family) == "deepfm" else jcfg.dim


def jax_planned(family, jcfg, jopt, jm):
    mesh = jmesh()
    plan = jplan(jcfg.vocab_sizes, plan_dim(family, jcfg), **PLAN_KW)
    pt = JPL.place_stacked_on_plan(plan, mesh, jm.tables, jm.emb_state, jopt)
    repl = NamedSharding(mesh, P())
    towers = {a: jax.device_put(getattr(jm, a), repl)
              for a in JTOWERS[base(family)]}
    return JCLS[base(family)](tables=pt, config=jcfg, **towers)


def jax_towers(family, m):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(
        tuple(getattr(m, a) for a in JTOWERS[base(family)]))]


def jax_family_steps(family, opt_key, jcfg, jopt, jm, data, cfg_key=""):
    key = (family, opt_key, cfg_key)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = JSTEP[base(family)](jcfg, jmesh(), sparse_opt=jopt,
                                              dense_lr=0.1)
    step = _JAX_STEPS[key]
    pm = jax_planned(family, jcfg, jopt, jm)
    sd, sc, sl = JP.batch_shardings(jmesh(), "data")
    losses = []
    for dense, cat, label in data:
        pm, loss = step(pm, jax.device_put(dense, sd),
                        jax.device_put(cat, sc), jax.device_put(label, sl))
        losses.append(float(loss))
    return losses, pm


def run_family(pool, family, opt_key, cfg_kw=None, data_kw=None,
               step_kw=None, n=2):
    (jcfg, jopt, jm), (pcfg, popt, _) = pair(family, opt_key,
                                             **(cfg_kw or {}))
    data = global_batches(family, n=n, **(data_kw or {}))
    got = pool.submit("planned_family_steps", "data", base(family), pcfg,
                      family_arrays(family, jm), popt, PLAN_KW, data,
                      step_kw)
    losses, jpm = jax_family_steps(family, opt_key, jcfg, jopt, jm, data,
                                   repr(sorted((cfg_kw or {}).items())))
    got = got()
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, **STEP)
    assert_dense_close(got[0], jax_dense(jpm.tables))
    for a, b in zip(got[0]["towers"], jax_towers(family, jpm)):
        np.testing.assert_allclose(a, b, **TABLE)
    for step in range(n):
        assert_bits_equal_on_every_rank([
            {"bits": g["bits"][step]} for g in got])
    return got, jpm


@pytest.mark.parametrize("opt_key", ["sgd", "adagrad"])
@pytest.mark.parametrize("family", ["dlrm", "dcn", "deepfm_folded"])
def test_planned_step_matches_jax(pool, family, opt_key):
    """Two planned steps of each CTR family on the three-way plan: losses,
    every group's tables and state, the towers; the planned eval of the
    last batch against JAX's."""
    got, jpm = run_family(pool, family, opt_key)
    dense, cat, _ = global_batches(family, n=2)[-1]
    sd, sc, _ = JP.batch_shardings(jmesh(), "data")
    if ("eval", family) not in _JAX_STEPS:
        _JAX_STEPS["eval", family] = JEVAL[base(family)](jpm.config, jmesh())
    want = _JAX_STEPS["eval", family](
        jpm, jax.device_put(dense, sd), jax.device_put(cat, sc))
    for g in got:
        np.testing.assert_allclose(g["logits"], np.asarray(want), **EVAL)


def test_planned_step_with_padded_mean_bags_matches_jax(pool):
    run_family(pool, "dlrm", "adagrad",
               cfg_kw=dict(bag=3, combiner="mean", pad_idx=-1),
               data_kw=dict(bag=3, pad_idx=-1))


def test_planned_microbatch_matches_the_monolithic_jax_step(pool):
    """`microbatch=2` takes the gradients over two slices of each block
    before ONE planned apply: JAX's monolithic planned step's results."""
    run_family(pool, "dlrm", "sgd", step_kw=dict(microbatch=2))


def test_planned_loop_with_eviction_matches_jax(pool):
    """`train_dlrm(mesh=, plan=)` from a single-device model's weights
    with `evict_every=2` on Zipf traffic: losses, evicted rows and every
    group against JAX's loop."""
    (jcfg, jopt, jm), (pcfg, popt, _) = pair("dlrm", "adagrad")
    data = global_batches("dlrm", n=4, seed=7, zipf_a=1.5)
    kw = dict(dense_lr=0.1, log_every=1, evict_every=2, evict_threshold=0.3,
              freq_decay=0.5)
    got = pool.submit("planned_loop", "dlrm", pcfg,
                      family_arrays("dlrm", jm), popt, PLAN_KW, data, kw)
    plan = jplan(jcfg.vocab_sizes, jcfg.dim, **PLAN_KW)
    res = JT.train_dlrm(jcfg, iter([dict(zip(("dense", "cat", "label"), b))
                                    for b in data]), len(data),
                        sparse_opt=jopt, model=jm, mesh=jmesh(), plan=plan,
                        verbose=False, **kw)
    got = got()
    assert res.evicted_rows > 0
    for g in got:
        assert g["type"] == "PlannedDLRM"
        np.testing.assert_allclose(g["losses"], res.losses, **STEP)
        assert g["evicted"] == res.evicted_rows
    assert_dense_close(got[0], jax_dense(res.model.tables))


@pytest.mark.parametrize("family", ["dlrm", "dcn", "deepfm_folded"])
def test_planned_loop_rolls_back_and_evicts(pool, family, tmp_path):
    """Every rank rolls back together on a NaN batch and ends bitwise where
    the run without it ends; the evicting loop zeroes the rows it
    reports, in every group."""
    (_, _, jm), (pcfg, popt, _) = pair(family, "adagrad")
    arrays = family_arrays(family, jm)
    data = global_batches(family, n=3, seed=7)
    nan = (np.full_like(data[0][0], np.nan),) + data[0][1:]
    kw = dict(dense_lr=0.1, log_every=1, ckpt_every=1, guard=True)
    rolled = pool.run("planned_loop", base(family), pcfg, arrays, popt,
                      PLAN_KW, data[:2] + [nan] + data[2:],
                      dict(kw, ckpt_dir=str(tmp_path / "a")))
    clean = pool.run("planned_loop", base(family), pcfg, arrays, popt,
                     PLAN_KW, data, dict(dense_lr=0.1, log_every=1))
    for r, c in zip(rolled, clean):
        assert r["rollbacks"] == 1
        np.testing.assert_array_equal(r["tables"], c["tables"])
        for a, b in zip(r["state"] + r["towers"], c["state"] + c["towers"]):
            np.testing.assert_array_equal(a, b)
    ev = pool.run("planned_loop", base(family), pcfg, arrays, popt, PLAN_KW,
                  global_batches(family, n=4, seed=8, zipf_a=1.5),
                  dict(dense_lr=0.1, evict_every=2, evict_threshold=0.3,
                       freq_decay=0.5))
    assert ev[0]["evicted"] > 0
    assert all(np.isfinite(e["losses"]).all() for e in ev)
    zero_rows = (ev[0]["tables"] == 0).all(axis=1).sum()
    assert zero_rows >= 1


@pytest.mark.parametrize("family", ["dlrm", "dcn"])
def test_planned_mesh_service_matches_jax(pool, family):
    """Rank 0 serves the planned model; the other ranks follow until its
    stop() (the DLRM and DCN services take a planned model, as JAX's)."""
    (jcfg, jopt, jm), (pcfg, _, _) = pair(family, "sgd")
    rng = np.random.default_rng(9)
    requests = [(rng.standard_normal((b, 3)).astype(np.float32),
                 np.stack([rng.integers(0, v, b) for v in VOCABS])
                 .astype(np.int32)) for b in (1, 3, 6)]
    got = pool.run("planned_serve", family, pcfg, family_arrays(family, jm),
                   PLAN_KW, requests)
    svc = getattr(JS, f"make_{family}_service")(
        jax_planned(family, jcfg, jopt, jm), mesh=jmesh(), max_batch=16,
        max_latency_ms=2.0)
    try:
        want = [svc.predict(d, c, timeout=60) for d, c in requests]
    finally:
        svc.stop()
    for g, w in zip(got[0], want):
        np.testing.assert_allclose(g, w, **EVAL)
    assert all(isinstance(b, int) and b >= 1 for b in got[1:])


def test_what_a_plan_refuses(pool):
    """A foreign model under `plan=` (JAX's TypeError), an unfolded
    DeepFM carried onto a plan and a plan narrower than the fused stack
    (JAX's ValueErrors), and a planned DeepFM's mesh service (JAX has
    none; ROADMAP.md queue 3)."""
    import torch
    common = dict(vocab_sizes=VOCABS, num_dense=3, dim=DIM,
                  compute_dtype=torch.float32)
    cfgs = (ett.DLRMConfig(**common, bottom_mlp=(16, 8), top_mlp=(16, 1)),
            ett.DeepFMConfig(**common, deep_mlp=(16, 8)),
            ett.DeepFMConfig(**common, deep_mlp=(16, 8), fold_fm_w=False))
    got = pool.run("planned_misc", cfgs, None)[0]
    assert got[0].startswith("TypeError") and "PlannedDLRM" in got[0]
    assert got[1].startswith("ValueError") and "folded" in got[1]
    assert got[2].startswith("ValueError") and "stack_dim" in got[2]
    assert got[3].startswith("NotImplementedError") and \
        "PlannedDeepFM" in got[3]


def test_delta_checkpoints_under_a_plan_raise_as_jax_does(tmp_path):
    from embeddingtables_tpu_torch.utils import DeltaCheckpointManager
    cfg = ett.DLRMConfig(vocab_sizes=VOCABS, num_dense=3, dim=DIM,
                         bottom_mlp=(16, 8), top_mlp=(16, 1))
    with pytest.raises(NotImplementedError, match="delta checkpointing"):
        ett.train_dlrm(cfg, iter(()), 1, mesh=object(), plan=object(),
                       delta_ckpt=DeltaCheckpointManager(str(tmp_path)),
                       delta_every=1, device="cpu")
    with pytest.raises(NotImplementedError, match="delta checkpointing"):
        ett.train_two_tower(ett.TwoTowerConfig(
            query_vocab_sizes=VOCABS, item_vocab=20, num_dense=3, dim=DIM,
            embed_dim=DIM, query_mlp=(8,), item_mlp=(8,)), iter(()), 1,
            mesh=object(), plan=object(), delta_every=1, device="cpu",
            delta_ckpt=(DeltaCheckpointManager(str(tmp_path)),
                        DeltaCheckpointManager(str(tmp_path))))
    assert os.listdir(tmp_path) == []
