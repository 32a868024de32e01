"""The port's column sharding (`parallel/colshard.py`) on a 4-rank gloo
group against JAX's on its 4-device mesh: the same tables and global
batches, each rank on its block. Tolerances are JAX's own colshard tests':
lookups rtol 2e-5 / atol 1e-5, tables and states after the updates rtol
2e-4 / atol 1e-6 (AdaGrad's accumulator and Adam's moments atol 1e-7).
Widths 8 (two columns a rank) and 10 and 130 (padded slices)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from embeddingtables_tpu import optim as JO
from embeddingtables_tpu.ops.sparse_update import \
    SparseEmbeddingUpdate as JUpd
from embeddingtables_tpu.parallel import colshard as JC
from embeddingtables_tpu_torch import optim as PO
from _torch_mesh import MeshPool
from _torch_threads import _one_torch_thread  # noqa: F401

V, B, BAG = 48, 16, 3
LOOKUP = dict(rtol=2e-5, atol=1e-5)
TABLE = dict(rtol=2e-4, atol=1e-6)
STATE = dict(rtol=2e-4, atol=1e-7)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("colshard")))
    yield p
    p.close()


def jmesh():
    return Mesh(np.array(jax.devices()[:4]), ("data",))


def put(x):
    return jax.device_put(jnp.asarray(x), NamedSharding(jmesh(), P("data")))


def jax_lookup(ct, idx, weights=None, **kw):
    """JAX's `col_sharded_lookup`, jitted (an eager shard_map call costs
    several times its compile)."""
    return np.asarray(jax.jit(lambda ct, i, w: JC.col_sharded_lookup(
        jmesh(), ct, i, weights=w, **kw))(ct, idx, weights))


def table(dim, seed=0, v=V):
    return np.random.default_rng(seed).standard_normal(
        (v, dim)).astype(np.float32)


@pytest.mark.parametrize("dim", [8, 10, 130])
def test_slices_hold_the_table(pool, dim):
    """Rank r holds columns [r cl, (r+1) cl) of the zero-padded table;
    `unshard` and `table(t)` give back the members."""
    data = table(dim)
    tabs = [data[:20], data[20:]]
    cl = -(-dim // 4)
    padded = np.pad(data, ((0, 0), (0, 4 * cl - dim)))
    for r, got in enumerate(pool.run("col_layout", tabs)):
        np.testing.assert_array_equal(got["slice"],
                                      padded[:, r * cl:(r + 1) * cl])
        np.testing.assert_array_equal(got["full"], data)
        for g, w in zip(got["tables"], tabs):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bag", [None, BAG])
@pytest.mark.parametrize("dim", [8, 10, 130])
def test_lookup_matches_jax(pool, dim, bag):
    rng = np.random.default_rng(dim + (bag or 0))
    data = table(dim, dim)
    idx = rng.integers(0, V, (B,) if bag is None else (B, bag)).astype(
        np.int32)
    ct = JC.ColShardedStackedTables.shard(jmesh(), "data", jnp.asarray(data))
    want = jax_lookup(ct, put(idx))
    got = pool.run("col_lookup", data, idx, {})
    np.testing.assert_allclose(np.concatenate(got), want, **LOOKUP)


def test_replicated_batch_and_non_reducing_rows_match_jax(pool):
    """`batch_sharded=False`: every rank gets the whole batch's rows.
    `reducing=False`: a `(B, T)` stream gives `(B, T, dim)`."""
    rng = np.random.default_rng(3)
    data = table(10, 3)
    ct = JC.ColShardedStackedTables.shard(jmesh(), "data", jnp.asarray(data))
    idx = rng.integers(0, V, (B,)).astype(np.int32)
    want = jax_lookup(ct, jnp.asarray(idx), batch_sharded=False)
    for got in pool.run("col_lookup", data, idx, {}, False):
        np.testing.assert_allclose(got, want, **LOOKUP)
    ens = rng.integers(0, V, (B, 4)).astype(np.int32)
    want = jax_lookup(ct, put(ens), reducing=False)
    got = pool.run("col_lookup", data, ens, dict(reducing=False))
    assert got[0].shape == (B // 4, 4, 10)
    np.testing.assert_allclose(np.concatenate(got), want, **LOOKUP)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_lookup_combiner_weights_and_pads_match_jax(pool, combiner,
                                                    weighted):
    """The fold: combiner, weights and pads (-1 and V both) as one
    per-occurrence scale."""
    rng = np.random.default_rng(7 + weighted)
    data = table(10, 4)
    idx = rng.integers(0, V, (B, BAG)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.3] = -1
    idx[0] = -1                                  # an all-pad bag
    kw = dict(combiner=combiner, pad_idx=-1)
    if weighted:
        kw["weights"] = rng.uniform(0.5, 2, idx.shape).astype(np.float32)
    ct = JC.ColShardedStackedTables.shard(jmesh(), "data", jnp.asarray(data))
    jkw = dict(kw)
    jkw["weights"] = put(kw["weights"]) if weighted else None
    want = jax_lookup(ct, put(idx), **jkw)
    got = pool.run("col_lookup", data, idx, kw)
    np.testing.assert_allclose(np.concatenate(got), want, **LOOKUP)


OPTS = {
    "sgd": lambda m: m.SparseSGD(0.5),
    "sgd_reg": lambda m: m.SparseSGD(0.3, weight_decay=0.02, clipnorm=0.5),
    "adagrad": lambda m: m.SparseRowWiseAdaGrad(lr=0.3, eps=1e-6),
    "adagrad_reg": lambda m: m.SparseRowWiseAdaGrad(
        lr=0.3, weight_decay=0.02, clipnorm=0.5),
    "adam": lambda m: m.SparseLazyAdam(lr=0.05),
    "adam_reg": lambda m: m.SparseLazyAdam(lr=0.05, weight_decay=0.01,
                                           clipnorm=1.0),
    "ftrl": lambda m: m.SparseFTRL(lr=0.2, l1=0.002, l2=0.01),
}


def jax_col_state(ct, state):
    """JAX's col state as `_torch_mesh._col_state_out` lays it out."""
    if state is None:
        return []
    if not isinstance(state, tuple):
        return [np.asarray(state)]
    n, v, cl = ct.data.shape
    return [np.asarray(x).transpose(1, 0, 2).reshape(v, n * cl)[:, :ct.dim]
            if np.ndim(x) == 3 else np.asarray(x) for x in state]


def jax_col_steps(data, upds, opt):
    mesh = jmesh()
    ct = JC.ColShardedStackedTables.shard(mesh, "data", jnp.asarray(data))
    state = JC.init_col_row_state(mesh, ct, opt)
    sgd = isinstance(opt, JO.SparseSGD)
    step = jax.jit(lambda ct, upd, state: (
        (JC.col_sharded_update(mesh, ct, upd, opt), None) if sgd
        else JC.col_sharded_update(mesh, ct, upd, opt, state)))
    out = []
    for u in upds:
        upd = JUpd(delta=put(u["delta"]), indices=put(u["indices"]),
                   weights=None if u.get("weights") is None
                   else put(u["weights"]))
        ct, state = step(ct, upd, state)
        out.append({"table": np.asarray(ct.unshard()),
                    "state": jax_col_state(ct, state)})
    return out


def updates(dim, steps=3, seed=0, bag=BAG, weights=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.integers(0, V, (B, bag) if bag else (B,)).astype(np.int32)
        u = dict(delta=rng.standard_normal((B, dim)).astype(np.float32),
                 indices=idx)
        if weights:
            u["weights"] = rng.uniform(0, 1, idx.shape).astype(np.float32)
        out.append(u)
    return out


@pytest.mark.parametrize("name", sorted(OPTS))
def test_update_matches_jax_over_three_steps(pool, name):
    """Every optimizer over three bagged steps at D = 10 (padded slices of
    3): the tables and the whole state after each step."""
    data = table(10, 11)
    upds = updates(10, seed=len(name))
    got = pool.submit("col_update", data, upds, OPTS[name](PO))
    want = jax_col_steps(data, upds, OPTS[name](JO))
    got = got()[0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["table"], w["table"], **TABLE)
        assert len(g["state"]) == len(w["state"])
        for a, b in zip(g["state"], w["state"]):
            np.testing.assert_allclose(a, b, **STATE)


@pytest.mark.parametrize("bag", [None, BAG])
def test_weighted_sgd_update_at_an_even_width_matches_jax(pool, bag):
    data = table(8, 12)
    upds = updates(8, steps=2, seed=5, bag=bag, weights=True)
    got = pool.submit("col_update", data, upds, PO.SparseSGD(0.5))
    want = jax_col_steps(data, upds, JO.SparseSGD(0.5))
    got = got()[0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["table"], w["table"], **TABLE)


def test_a_row_touched_in_one_slice_advances_every_slice(pool):
    """JAX's cross-slice case: the gradient lands only in column 0 (rank
    0's slice), yet the row's Adam moments and step advance in every
    slice (the touched mask rides the all-reduce)."""
    data = np.ones((V, 8), np.float32)
    delta = np.zeros((B, 8), np.float32)
    delta[:, 0] = 1.0
    upds = [dict(delta=delta, indices=np.full((B,), 7, np.int32))]
    got = pool.submit("col_update", data, upds, PO.SparseLazyAdam(lr=0.1))
    want = jax_col_steps(data, upds, JO.SparseLazyAdam(lr=0.1))[0]
    got = got()[0][0]
    np.testing.assert_allclose(got["table"], want["table"], rtol=1e-5,
                               atol=1e-6)
    assert got["table"][7, 0] != 1.0
    for a, b in zip(got["state"], want["state"]):
        np.testing.assert_allclose(a, b, atol=1e-7)
    assert got["state"][0][7, 0] != 0.0           # m advanced


def test_the_guards_raise_what_jax_raises(pool):
    """Stochastic rounding without a generator, SGD given state, AdaGrad
    without it, FTRL with a per-step lr: ValueError; an unknown optimizer
    and the combiner with `reducing=False`: NotImplementedError (JAX's)."""
    got = pool.run("col_guards", table(8))[0]
    assert got == ["ValueError"] * 4 + ["NotImplementedError"] * 2


def test_stochastic_rounding_draws_each_ranks_own_noise(pool):
    """A bf16 table under SGD with stochastic rounding: every element lands
    on one of the two bf16 neighbours of the f32 update (JAX folds the
    column index into one key; each rank draws from its own generator
    here: ROADMAP.md queue 3), and some round away from nearest."""
    import torch
    data = table(10, 13)
    base = torch.from_numpy(data).to(torch.bfloat16)
    upds = updates(10, steps=1, seed=3)
    opt = PO.SparseSGD(1e-3, stochastic_rounding=True)
    got = pool.run("col_update", base.float().numpy(), upds, opt, 5, True)
    want = jax_col_steps(base.float().numpy(), upds,
                         JO.SparseSGD(1e-3))[0]["table"]
    bits = torch.from_numpy(want.copy()).view(torch.int32)
    down = bits & -(1 << 16)                # the bf16 value toward zero
    up = down + (1 << 16)                   # its neighbour away from zero
    g = torch.from_numpy(got[0][0]["table"].copy()).view(torch.int32)
    assert torch.all((g == down) | (g == up))
    nearest = torch.from_numpy(want.copy()).to(torch.bfloat16).float()
    assert not torch.equal(g, nearest.view(torch.int32))
    for r in got[1:]:
        np.testing.assert_array_equal(r[0]["table"], got[0][0]["table"])
