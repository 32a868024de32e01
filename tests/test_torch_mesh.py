"""The port's mod-row-sharded tables (`parallel/sharded.py`) and butterfly
(`parallel/alltoall.py`) on a 4-rank gloo group, against JAX's on its
`local_mesh(4)` and its `(2, 2)` ("data", "model") mesh, on the same numpy
inputs.

The ranks are spawned once for the module (`tests/_torch_mesh.py`); rank r
holds the rows of JAX's device r. Tolerances: one-hot lookups bitwise (one
real row summed with zeros), bag sums rtol 1e-6, updates rtol 1e-5 (the
run-scatter sums in its own order), a2a overflow counts equal, the bf16
wire one bf16 rounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import embeddingtables_tpu as et
from embeddingtables_tpu import optim as J
from embeddingtables_tpu.parallel import alltoall as JA
from embeddingtables_tpu.parallel import sharded as JS
from embeddingtables_tpu.parallel.mesh import default_mesh, local_mesh
from embeddingtables_tpu_torch import optim as PO
from embeddingtables_tpu_torch.parallel import alltoall as PA
from _torch_mesh import MeshPool
from _torch_threads import _one_torch_thread  # noqa: F401

AXES = {"1d": "data", "2d": ("data", "model")}
V, D, B = 97, 8, 32


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("mesh")))
    yield p
    p.close()


def jax_mesh(kind):
    if kind == "1d":
        return local_mesh(4)
    return default_mesh(("data", "model"), shape=(2, 2),
                        devices=jax.devices()[:4])


def put(mesh, x, spec=P("data")):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def jit(fn, *args):
    """`fn(*args)` jitted: eager shard_map programs take seconds a call."""
    return jax.jit(fn)(*args)


def _table(seed=0, v=V):
    return np.random.default_rng(seed).standard_normal((v, D)).astype(
        np.float32)


def _ids(seed, shape, v=V, skew=False):
    rng = np.random.default_rng(seed)
    if skew:   # most ids on one owner, so capacity overflows
        ids = np.where(rng.random(shape) < 0.7,
                       4 * rng.integers(0, v // 4, shape),
                       rng.integers(0, v, shape))
        return ids.astype(np.int32)
    return rng.integers(0, v, shape).astype(np.int32)


def _blocks(outs, kind):
    """The global batch from the ranks' blocks (one per data index)."""
    return np.concatenate(outs if kind == "1d" else outs[::2])


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_each_rank_holds_jax_devices_rows(pool, kind):
    table = _table(1)
    st = JS.ShardedStackedTables.shard(jax_mesh(kind), AXES[kind],
                                       jnp.asarray(table))
    want = np.asarray(st.data)
    outs = pool.run("layout", AXES[kind], table)
    for r, o in enumerate(outs):
        assert o["me"] == r and o["order"] is None
        np.testing.assert_array_equal(o["shard"], want[r])
        np.testing.assert_array_equal(o["full"], table)


@pytest.mark.parametrize("kind,bag", [("1d", None), ("1d", 3), ("2d", None),
                                      ("2d", 3)])
def test_sharded_lookup_matches_jax(pool, kind, bag):
    table = _table(2)
    idx = _ids(3, (B,) if bag is None else (B, bag))
    got = pool.submit("lookup", AXES[kind], table, idx, {})
    mesh = jax_mesh(kind)
    st = JS.ShardedStackedTables.shard(mesh, AXES[kind], jnp.asarray(table))
    want = np.asarray(jit(lambda s, i: JS.sharded_lookup(mesh, s, i),
                           st, put(mesh, idx)))
    got = _blocks(got(), kind)
    if bag is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["mean_weighted_pad", "fused"])
def test_sharded_ensemble_lookup_matches_jax(pool, mode):
    vocabs = (40, 31, 26)
    table = _table(4, sum(vocabs))
    offs = tuple(np.cumsum((0,) + vocabs).tolist())
    rng = np.random.default_rng(5)
    if mode == "fused":
        idx = np.stack([rng.integers(0, v, B) for v in vocabs]).astype(
            np.int32)
        kw = dict(fused=True, prependrows=3)
    else:
        idx = np.stack([rng.integers(0, v, (B, 4)) for v in vocabs]).astype(
            np.int32)
        idx[rng.random(idx.shape) < 0.3] = -1
        kw = dict(combiner="mean", pad_idx=-1,
                  weights=rng.random(idx.shape).astype(np.float32))
    mesh = jax_mesh("1d")
    st = JS.ShardedStackedTables.shard(
        mesh, "data", et.StackedTables(jnp.asarray(table), offs, D))
    spec = P(None, "data")
    w = put(mesh, kw["weights"], spec) if "weights" in kw else None
    jkw = {k: v for k, v in kw.items() if k != "weights"}
    outs = pool.submit("lookup", "data", (table, offs), idx, kw,
                       ensemble=True)
    want = jit(lambda s, i, w: JS.sharded_ensemble_lookup(
        mesh, s, i, weights=w, **jkw), st, put(mesh, idx, spec), w)
    outs = outs()
    if mode == "fused":
        np.testing.assert_array_equal(np.concatenate(outs), np.asarray(want))
    else:
        for t in range(len(vocabs)):
            np.testing.assert_allclose(np.concatenate([o[t] for o in outs]),
                                       np.asarray(want[t]), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("kind,bag", [("1d", None), ("1d", 2), ("2d", None)])
def test_sharded_sgd_update_matches_jax(pool, kind, bag):
    table = _table(6)
    rng = np.random.default_rng(7)
    idx = _ids(8, (B,) if bag is None else (B, bag))
    upd = dict(delta=rng.standard_normal((B, D)).astype(np.float32),
               indices=idx,
               weights=None if bag is None
               else rng.random((B, bag)).astype(np.float32))
    mesh = jax_mesh(kind)
    st = JS.ShardedStackedTables.shard(mesh, AXES[kind], jnp.asarray(table))
    jupd = et.SparseEmbeddingUpdate(
        delta=put(mesh, upd["delta"]), indices=put(mesh, idx),
        weights=None if bag is None else put(mesh, upd["weights"]))
    got = pool.submit("sgd_update", AXES[kind], table, upd, 0.5)
    want = np.asarray(jit(lambda s, u: JS.sharded_sgd_update(
        mesh, s, u, 0.5), st, jupd).unshard())
    got = got()
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)


def test_sharded_ensemble_update_matches_jax(pool):
    vocabs = (40, 31, 26)
    table = _table(9, sum(vocabs))
    offs = tuple(np.cumsum((0,) + vocabs).tolist())
    rng = np.random.default_rng(10)
    upds = [dict(delta=rng.standard_normal((B, D)).astype(np.float32),
                 indices=rng.integers(0, v, (B, 2)).astype(np.int32),
                 weights=rng.random((B, 2)).astype(np.float32))
            for v in vocabs]
    mesh = jax_mesh("1d")
    st = JS.ShardedStackedTables.shard(
        mesh, "data", et.StackedTables(jnp.asarray(table), offs, D))
    jupds = [et.SparseEmbeddingUpdate(
        delta=put(mesh, u["delta"]), indices=put(mesh, u["indices"]),
        weights=put(mesh, u["weights"])) for u in upds]
    got = pool.submit("sgd_update", "data", (table, offs), upds, 0.3,
                      ensemble=True)
    want = np.asarray(jit(lambda s, u: JS.sharded_ensemble_update(
        mesh, s, u, 0.3), st, jupds).unshard())
    got = got()
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,cf", [("1d", 1.0), ("1d", 8.0), ("2d", 1.0)])
def test_a2a_lookup_matches_jax_and_its_overflow(pool, kind, cf):
    table = _table(11)
    idx = _ids(12, (B,), skew=True)
    mesh = jax_mesh(kind)
    st = JS.ShardedStackedTables.shard(mesh, AXES[kind], jnp.asarray(table))
    outs = pool.submit("lookup_a2a", AXES[kind], table, idx,
                       {"capacity_factor": cf})
    want, ovf = jit(lambda s, i: JA.sharded_lookup_a2a(
        mesh, s, i, capacity_factor=cf), st, put(mesh, idx))
    outs = outs()
    np.testing.assert_array_equal(_blocks([o[0] for o in outs], kind),
                                  np.asarray(want))
    assert [o[1] for o in outs] == [int(ovf)] * 4
    assert (int(ovf) > 0) == (cf == 1.0)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_a2a_lookup_pads_and_weights_match_jax(pool, combiner):
    table = _table(13)
    rng = np.random.default_rng(14)
    idx = _ids(15, (B, 3), skew=True)
    idx[rng.random(idx.shape) < 0.3] = -1
    w = rng.random(idx.shape).astype(np.float32)
    mesh = jax_mesh("1d")
    st = JS.ShardedStackedTables.shard(mesh, "data", jnp.asarray(table))
    want, ovf = jit(lambda s, i, w: JA.sharded_lookup_a2a(
        mesh, s, i, capacity_factor=1.5, pad_idx=-1, combiner=combiner,
        weights=w), st, put(mesh, idx), put(mesh, w))
    outs = pool.run("lookup_a2a", "data", table, idx,
                    dict(capacity_factor=1.5, pad_idx=-1, combiner=combiner,
                         weights=w))
    np.testing.assert_allclose(np.concatenate([o[0] for o in outs]),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    assert outs[0][1] == int(ovf)


def _jax_a2a_update(mesh, axis, table, upd, name, cf, pad_idx=None):
    st = JS.ShardedStackedTables.shard(mesh, axis, jnp.asarray(table))
    opt = {"sgd": J.SparseSGD(0.5),
           "adagrad": J.SparseRowWiseAdaGrad(0.5, eps=1e-6),
           "adam": J.SparseLazyAdam(0.05),
           "ftrl": J.SparseFTRL(0.1, l1=0.01)}[name]
    jupd = et.SparseEmbeddingUpdate(delta=put(mesh, upd["delta"]),
                                    indices=put(mesh, upd["indices"]))
    kw = dict(capacity_factor=cf, pad_idx=pad_idx)
    if name == "sgd":
        st, ovf = jit(lambda s, u: JA.sharded_sgd_update_a2a(
            mesh, s, u, 0.5, **kw), st, jupd)
        state = J.SparseOptState(accum=jnp.zeros((0,)))
    else:
        acc = JS.init_sharded_row_state(mesh, st, opt)
        if name == "adagrad":
            st, acc, ovf = jit(lambda s, a, u: JA.sharded_adagrad_update_a2a(
                mesh, s, a, u, opt, **kw), st, acc, jupd)
        elif name == "adam":
            st, m, v, c, ovf = jit(lambda s, a, u: JA.sharded_adam_update_a2a(
                mesh, s, *a, u, opt, **kw), st, acc, jupd)
            acc = (m, v, c)
        else:
            st, z, n, ovf = jit(lambda s, a, u: JA.sharded_ftrl_update_a2a(
                mesh, s, *a, u, opt, **kw), st, acc, jupd)
            acc = (z, n)
        state = JS.unshard_row_state(st, acc)
    return np.asarray(st.unshard()), [np.asarray(s) for s in state], int(ovf)


PORT_OPTS = {"sgd": PO.SparseSGD(0.5),
             "adagrad": PO.SparseRowWiseAdaGrad(0.5, eps=1e-6),
             "adam": PO.SparseLazyAdam(0.05),
             "ftrl": PO.SparseFTRL(0.1, l1=0.01)}


@pytest.mark.parametrize("name,kind", [("sgd", "1d"), ("adagrad", "1d"),
                                       ("adam", "1d"), ("ftrl", "1d"),
                                       ("sgd", "2d"), ("adagrad", "2d")])
def test_a2a_update_matches_jax_and_its_overflow(pool, name, kind):
    table = _table(16)
    rng = np.random.default_rng(17)
    idx = _ids(18, (B,), skew=True)
    idx[rng.random(B) < 0.2] = -1
    upd = dict(delta=rng.standard_normal((B, D)).astype(np.float32),
               indices=idx)
    got = pool.submit("update_a2a", AXES[kind], table, upd,
                      PORT_OPTS[name], dict(capacity_factor=1.0, pad_idx=-1))
    want, want_state, ovf = _jax_a2a_update(jax_mesh(kind), AXES[kind],
                                            table, upd, name, 1.0, pad_idx=-1)
    got, state, got_ovf = got()[0]
    assert got_ovf == ovf > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for g, w in zip(state, want_state):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_a2a_bf16_wire_rounds_each_row_once(pool):
    table = _table(19)
    idx = _ids(20, (B,))
    mesh = jax_mesh("1d")
    st = JS.ShardedStackedTables.shard(mesh, "data", jnp.asarray(table))
    want, _ = jit(lambda s, i: JA.sharded_lookup_a2a(
        mesh, s, i, capacity_factor=4.0, wire_dtype=jnp.bfloat16), st,
        put(mesh, idx))
    outs = pool.run("lookup_a2a", "data", table, idx,
                    dict(capacity_factor=4.0, wire_dtype="bfloat16"))
    got = np.concatenate([o[0] for o in outs])
    np.testing.assert_array_equal(got, np.asarray(want))
    exact = table[idx]
    np.testing.assert_allclose(got, exact, rtol=2.0 ** -8, atol=0)
    assert not np.array_equal(got, exact)
    rng = np.random.default_rng(21)
    upd = dict(delta=rng.standard_normal((B, D)).astype(np.float32),
               indices=idx)
    got_t = pool.run("update_a2a", "data", table, upd, PORT_OPTS["sgd"],
                     dict(capacity_factor=4.0, wire_dtype="bfloat16"))[0][0]
    delta16 = upd["delta"].astype(jnp.bfloat16).astype(np.float32)
    want_t = table.copy()
    np.add.at(want_t, idx, -0.5 * delta16)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-6)


def test_sharded_update_sums_each_owned_run_in_run_scatter_order(pool):
    """Divergence pin (ROADMAP.md queue 3): each rank's update is the
    single-device run-scatter of its owned occurrences in stream order,
    bitwise; JAX adds them into the row one by one (here within 1e-5)."""
    table = _table(22)
    rng = np.random.default_rng(23)
    idx = _ids(24, (B,), v=9)               # long runs on few rows
    upd = dict(delta=rng.standard_normal((B, D)).astype(np.float32),
               indices=idx)
    for sharded, single in pool.run("owned_stream", "data", table, upd, 0.7):
        np.testing.assert_array_equal(sharded, single)
    mesh = jax_mesh("1d")
    st = JS.ShardedStackedTables.shard(mesh, "data", jnp.asarray(table))
    want = jit(lambda s, u: JS.sharded_sgd_update(mesh, s, u, 0.7), st,
               et.SparseEmbeddingUpdate(delta=put(mesh, upd["delta"]),
                                        indices=put(mesh, idx)))
    got = pool.run("sgd_update", "data", table, upd, 0.7)[0]
    np.testing.assert_allclose(got, np.asarray(want.unshard()), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["adagrad", "adam", "ftrl"])
def test_shard_row_accum_gives_jax_fresh_state_for_the_optimizer(pool, name):
    """Divergence pin (ROADMAP.md queue 3): SGD's empty state placed for a
    stateful optimizer becomes that optimizer's fresh shard state, which is
    what JAX's `init_sharded_row_state` gives (JAX's `shard_row_accum` does
    so for AdaGrad only)."""
    table = _table(25)
    mesh = jax_mesh("1d")
    st = JS.ShardedStackedTables.shard(mesh, "data", jnp.asarray(table))
    jopt = {"adagrad": J.SparseRowWiseAdaGrad(0.5, initial_accum=0.1),
            "adam": J.SparseLazyAdam(0.05),
            "ftrl": J.SparseFTRL(0.1, l1=0.01)}[name]
    popt = {"adagrad": PO.SparseRowWiseAdaGrad(0.5, initial_accum=0.1),
            "adam": PO.SparseLazyAdam(0.05),
            "ftrl": PO.SparseFTRL(0.1, l1=0.01)}[name]
    want = JS.init_sharded_row_state(mesh, st, jopt)
    want = [want] if name == "adagrad" else list(want)
    for r, got in enumerate(pool.run("fresh_state", "data", table, popt)):
        for g, w in zip(got, want):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(g, w if w.ndim == 0 else w[r],
                                       rtol=1e-6, atol=0)


def test_the_host_major_mesh_matches_jax(pool):
    """`multihost_mesh` with 2 ranks a host lays rank `h * 2 + i` at
    `(i, h)`, JAX's `multihost_mesh` layout, so group ranks and flattened
    indices differ and the all-to-all reorders its chunks."""
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2).T
    mesh = jax.sharding.Mesh(devices, ("data", "model"))
    axis = ("data", "model")
    table = _table(26)
    idx = _ids(27, (B,), skew=True)
    st = JS.ShardedStackedTables.shard(mesh, axis, jnp.asarray(table))
    pool.run("use_mesh", "hosts")
    try:
        orders = [o["order"] for o in pool.run("layout", axis, table)]
        assert all(o is not None for o in orders)
        # Data blocks by data index: ranks 0 and 2 are data index 0.
        want = jit(lambda s, i: JS.sharded_lookup(mesh, s, i), st,
                   put(mesh, idx))
        got = pool.run("lookup", axis, table, idx, {})
        np.testing.assert_array_equal(np.concatenate([got[0], got[1]]),
                                      np.asarray(want))
        want, ovf = jit(lambda s, i: JA.sharded_lookup_a2a(
            mesh, s, i, capacity_factor=1.0), st, put(mesh, idx))
        got = pool.run("lookup_a2a", axis, table, idx,
                       {"capacity_factor": 1.0})
        np.testing.assert_array_equal(
            np.concatenate([got[0][0], got[1][0]]), np.asarray(want))
        assert [g[1] for g in got] == [int(ovf)] * 4 and int(ovf) > 0
        upd = dict(delta=np.random.default_rng(28).standard_normal(
            (B, D)).astype(np.float32), indices=idx)
        want_t, _, want_ovf = _jax_a2a_update(mesh, axis, table, upd,
                                              "adagrad", 1.0)
        got_t, _, got_ovf = pool.run("update_a2a", axis, table, upd,
                                     PORT_OPTS["adagrad"],
                                     {"capacity_factor": 1.0})[0]
        assert got_ovf == want_ovf
        np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-6)
    finally:
        pool.run("use_mesh", "grid")


def test_capacity_policy_and_tuner_match_jax():
    for cur, frac in [(2.0, 0.0), (2.0, 0.1), (1.0, 0.5), (3.0, 0.01)]:
        assert PA.suggest_capacity_factor(cur, frac) == \
            JA.suggest_capacity_factor(cur, frac)
    jt, pt = JA.CapacityAutoTuner(1.0, 100), PA.CapacityAutoTuner(1.0, 100)
    for ovf in [0, 10, 10, 0, 5, 5, 5, 5, 5, 30, 0, 80, 80]:
        assert pt.observe(ovf) == jt.observe(ovf)
    assert (pt.factor, pt.retunes) == (jt.factor, jt.retunes)
    with pytest.raises(ValueError):
        PA.CapacityAutoTuner(1.0, 0)
    assert PA.capacity(33, 4, 1.5) == 14 and PA.capacity(1, 4, 0.1) == 1
