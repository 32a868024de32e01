"""The port's `SplitEmbedding`, indexer-driven SGD (`sgd_update` with
`idx_result=`/`view=`, `ensemble_sgd_update`, `scatter_sgd`) and the
shard-by-shard stateful update (`_split_stateful_apply`) against the JAX
package's, on the same numpy inputs on the CPU; mirrors
`tests/test_update.py` and `tests/test_constructors.py`.

Tolerances: rtol/atol 1e-5 against JAX (the run-scatter sums a row's
occurrences in f32 in one order, XLA's scatter or segment sum in another);
bitwise where the port compares with itself in the same order. The JAX side
is jitted where it runs more than a few ops: one compile per program, not
one per op and shape.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import embeddingtables_tpu as et
from embeddingtables_tpu import optim as J
from embeddingtables_tpu.ops.pallas.scatter import scatter_sgd as jax_scatter_sgd
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.ops.cuda import scatter as S
from _torch_threads import _one_torch_thread  # noqa: F401


TOL = dict(rtol=1e-5, atol=1e-5)
NROWS, LR = 50, 0.5


def _upd(rng, n, dim, v=NROWS, bag=None, weighted=False):
    shape = (n,) if bag is None else (n, bag)
    idx = rng.integers(0, v, shape).astype(np.int32)
    delta = rng.standard_normal((n, dim)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape).astype(np.float32) if weighted else None
    return (et.SparseEmbeddingUpdate(
                delta=jnp.asarray(delta), indices=jnp.asarray(idx),
                weights=None if w is None else jnp.asarray(w)),
            ett.SparseEmbeddingUpdate(
                delta=torch.from_numpy(delta), indices=torch.from_numpy(idx),
                weights=None if w is None else torch.from_numpy(w)))


# ---------------------------------------------------------------------------
# SplitEmbedding
# ---------------------------------------------------------------------------

def test_split_embedding_constructor():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((45, 8)).astype(np.float32)
    sp = ett.SplitEmbedding(torch.from_numpy(data), 20)
    assert sp.nshards == 3 and [tuple(s.shape) for s in sp.shards] == \
        [(20, 8), (20, 8), (5, 8)]                    # the last one ragged
    assert sp.spec.is_static and sp.spec.lookup == ett.Static(8)
    assert sp.shape == (45, 8) and sp.dtype == torch.float32
    assert ett.is_table(sp) and ett.example(sp) is sp.shards[0]
    np.testing.assert_array_equal(sp.materialize().numpy(), data)
    s, l = sp.chunkindex(torch.tensor(43))
    assert (int(s), int(l)) == (2, 3)
    # numpy data with devices given: each shard on its device.
    on = ett.SplitEmbedding(data.astype(np.float64), 20, devices=["cpu"])
    assert on.dtype == torch.float32
    assert all(s.device.type == "cpu" for s in on.shards)
    with pytest.raises(ValueError, match="positive"):
        ett.SplitEmbedding(torch.from_numpy(data), 0)


def test_split_rows_match_jax():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((NROWS, 8)).astype(np.float32)
    ids = rng.integers(-5, NROWS + 10, (6, 4)).astype(np.int32)
    want = jax.jit(lambda t, i: t.rows(i))(et.SplitEmbedding(data, 13),
                                            jnp.asarray(ids))
    got = ett.SplitEmbedding(torch.from_numpy(data), 13).rows(
        torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_scatter_apply_and_zeros_like_match_jax():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((NROWS, 8)).astype(np.float32)
    ids = rng.integers(-5, NROWS + 10, 30).astype(np.int32)
    delta = rng.standard_normal((30, 8)).astype(np.float32)
    want = jax.jit(lambda t, i, x: t.scatter_apply(i, x))(
        et.SplitEmbedding(data, 13), jnp.asarray(ids), jnp.asarray(delta))
    sp = ett.SplitEmbedding(torch.from_numpy(data.copy()), 13)
    assert sp.scatter_apply(torch.from_numpy(ids), torch.from_numpy(delta)) is sp
    np.testing.assert_allclose(sp.materialize().numpy(),
                               np.asarray(want.materialize()), **TOL)
    z = sp.zeros_like()
    assert z.spec == sp.spec and z.rows_per_shard == 13
    assert all(torch.equal(s, torch.zeros_like(s)) for s in z.shards)
    simple = ett.SimpleEmbedding(torch.from_numpy(data.copy()))
    jsimple = et.SimpleEmbedding(jnp.asarray(data)).scatter_apply(
        jnp.asarray(ids), jnp.asarray(delta))
    assert simple.scatter_apply(torch.from_numpy(ids),
                                torch.from_numpy(delta)) is simple
    np.testing.assert_allclose(simple.data.numpy(), np.asarray(jsimple.data),
                               **TOL)
    assert torch.equal(simple.zeros_like().data, torch.zeros((NROWS, 8)))


def test_destination_is_a_meta_tensor():
    t = ett.SimpleEmbedding(torch.zeros((10, 6), dtype=torch.bfloat16))
    for ids in (torch.zeros(4, dtype=torch.int32), np.zeros((4, 3))):
        d = ett.destination(t, ids)
        assert d.device.type == "meta" and tuple(d.shape) == (4, 6)
        assert d.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="1-D or 2-D"):
        ett.destination(t, np.zeros((2, 2, 2)))


def test_sgd_on_a_split_table_goes_through_its_scatter():
    rng = np.random.default_rng(17)
    data = rng.standard_normal((NROWS, 32)).astype(np.float32)
    jupd, pupd = _upd(rng, 30, 32)
    want = et.sgd_update(et.SplitEmbedding(data, 30), jupd, LR)
    got = ett.sgd_update(ett.SplitEmbedding(torch.from_numpy(data), 30),
                         pupd, LR)
    np.testing.assert_allclose(got.materialize().numpy(),
                               np.asarray(want.materialize()), **TOL)


# ---------------------------------------------------------------------------
# Indexer-driven SGD
# ---------------------------------------------------------------------------

def _equivalence_inputs():
    rng = np.random.default_rng(123)
    data = rng.standard_normal((NROWS, 48)).astype(np.float32)
    return data, _upd(rng, 80, 48)


@functools.lru_cache(maxsize=None)
def _jax_dedup_update(indexer):
    """JAX's dedup SGD of `_equivalence_inputs` through its indexer."""
    data, (jupd, _) = _equivalence_inputs()
    jix = {"sparse": et.SparseIndexer(), "dense": et.DenseIndexer()}[indexer]

    def update(d, u):
        ir = et.index(u.indices, vocab=NROWS, indexer=jix)
        return et.sgd_update(d, u, LR, idx_result=ir, method="dedup")
    return np.asarray(jax.jit(update)(jnp.asarray(data), jupd))


@pytest.mark.parametrize("indexer", ["sparse", "dense"])
@pytest.mark.parametrize("num_splits", [1, 2, 4])
def test_split_update_equivalence(indexer, num_splits):
    # The views' updates add up to the unsplit update bit for bit (the
    # stream is shorter than one run-scatter window, so every row sums its
    # occurrences in stream order either way), and match JAX's.
    data, (_, pupd) = _equivalence_inputs()
    pix = {"sparse": ett.SparseIndexer(), "dense": ett.DenseIndexer()}[indexer]
    pir = ett.index(pupd.indices, vocab=NROWS, indexer=pix)
    want = _jax_dedup_update(indexer)
    full = ett.sgd_update(torch.from_numpy(data.copy()), pupd, LR,
                          idx_result=pir, method="dedup")
    np.testing.assert_allclose(full.numpy(), want, **TOL)
    cur = ett.SimpleEmbedding(torch.from_numpy(data.copy()))
    for j in range(num_splits):
        ett.sgd_update(cur, pupd, LR, view=ett.indexer_view(pir, num_splits, j),
                       method="dedup")
    assert torch.equal(cur.data, full)


@functools.lru_cache(maxsize=None)
def _indexer_update_case(kind):
    """(table, port update, JAX's dedup SGD through its DenseIndexer): one
    jitted JAX program per kind, shared by the methods."""
    rng = np.random.default_rng(len(kind))
    bag = None if kind == "rows" else 3
    jupd, pupd = _upd(rng, 24, 16, bag=bag, weighted=bag is not None)
    data = rng.standard_normal((NROWS, 16)).astype(np.float32)
    want = jax.jit(lambda d, u: et.sgd_update(
        d, u, LR, method="dedup", indexer=et.DenseIndexer()))(
        jnp.asarray(data), jupd)
    return data, pupd, np.asarray(want)


@pytest.mark.parametrize("method", ["auto", "dedup", "pallas"])
@pytest.mark.parametrize("kind", ["rows", "bags_weighted"])
def test_sgd_update_with_an_indexer_matches_jax(kind, method):
    data, pupd, want = _indexer_update_case(kind)
    for kw in ({"indexer": ett.DenseIndexer()},
               {"idx_result": ett.index(pupd.indices)}):
        got = ett.sgd_update(torch.from_numpy(data.copy()), pupd, LR,
                             method=method, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sgd_update_with_an_indexer_wraps_negative_ids_as_jax_scatter_does():
    # JAX gives two answers here: its dedup path writes to the indexer's
    # `unique`, which folds every id below -1 into -1 and so into row V-1;
    # its scatter path wraps each id. The port resolves the update's own
    # ids with or without an indexer result: the scatter path's answer.
    rng = np.random.default_rng(31)
    jupd, pupd = _upd(rng, 24, 16)
    idx = rng.integers(-NROWS, NROWS, 24).astype(np.int32)
    assert (idx < -1).any()
    jupd.indices, pupd.indices = jnp.asarray(idx), torch.from_numpy(idx)
    data = rng.standard_normal((NROWS, 16)).astype(np.float32)
    want = et.sgd_update(jnp.asarray(data), jupd, LR, method="scatter")
    got = ett.sgd_update(torch.from_numpy(data.copy()), pupd, LR,
                         idx_result=ett.index(pupd.indices), method="dedup")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ensemble_sgd_update_matches_jax():
    rng = np.random.default_rng(77)
    dims = (16, 16, 32)
    arrs = [rng.standard_normal((NROWS, d)).astype(np.float32) for d in dims]
    pairs = [_upd(rng, 20, d) for d in dims]
    want = jax.jit(lambda ts, us: et.ensemble_sgd_update(
        ts, us, LR, method="dedup", indexer=et.SparseIndexer()))(
        [et.SimpleEmbedding(jnp.asarray(a)) for a in arrs],
        [j for j, _ in pairs])
    for method in ("dedup", "auto"):        # JAX's "auto" is the same math
        phases = []
        tables = [ett.SimpleEmbedding(torch.from_numpy(a.copy()))
                  for a in arrs]

        def recording_indexer(indices, vocab=None):
            phases.append("index")
            return ett.SparseIndexer()(indices, vocab)
        got = ett.ensemble_sgd_update(
            tables, [p for _, p in pairs], LR, method=method,
            indexer=recording_indexer, num_splits=2,
            telemetry_cb=lambda: phases.append("telemetry"))
        # The run-scatter dedups by itself: no indexer runs before the hook.
        assert phases == ["telemetry"]
        assert got == tables
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data),
                                       **TOL)
    with pytest.raises(ValueError, match="equal length"):
        ett.ensemble_sgd_update([arrs[0]], [], LR)


def test_scatter_sgd_matches_pallas_scatter_sgd():
    # The Pallas kernel in interpret mode unrolls its tile: n <= 16.
    rng = np.random.default_rng(5)
    v, d = 6, 128      # the shapes of test_scatter_update_matches_pallas_...
    arr = rng.standard_normal((v, d)).astype(np.float32)
    # Negative ids too: both indexers fold them into -1, which both
    # run-scatters drop as padding.
    idx = rng.integers(-3, v, (4, 3)).astype(np.int32)
    assert (idx < -1).any() and (idx >= 0).any()
    delta = rng.standard_normal((4, d)).astype(np.float32)
    jir = et.index(jnp.asarray(idx))
    _, jcols = et.flatten_indices(jnp.asarray(idx))
    want = jax.jit(functools.partial(jax_scatter_sgd, lr=0.25, interpret=True))(
        jnp.asarray(arr), jnp.asarray(delta), jir, jcols)
    pir = ett.index(torch.from_numpy(idx))
    _, cols = ett.flatten_indices(torch.from_numpy(idx))
    table = torch.from_numpy(arr.copy())
    assert S.scatter_sgd(table, torch.from_numpy(delta), pir, cols,
                         0.25) is table
    np.testing.assert_allclose(table.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Stateful optimizers on a SplitEmbedding
# ---------------------------------------------------------------------------

SPLIT_OPTS = {
    "sgd_decay": (J.SparseSGD(lr=0.3, weight_decay=0.1),
                  P.SparseSGD(lr=0.3, weight_decay=0.1)),
    "adagrad_indexer": (J.SparseRowWiseAdaGrad(lr=0.3, method="indexer"),
                        P.SparseRowWiseAdaGrad(lr=0.3, method="indexer")),
    "adagrad_dense": (J.SparseRowWiseAdaGrad(lr=0.3, method="dense"),
                      P.SparseRowWiseAdaGrad(lr=0.3, method="dense")),
    "lazy_adam": (J.SparseLazyAdam(lr=0.1), P.SparseLazyAdam(lr=0.1)),
    "ftrl": (J.SparseFTRL(lr=0.2, l1=0.05), P.SparseFTRL(lr=0.2, l1=0.05)),
}


@pytest.mark.parametrize("name", sorted(SPLIT_OPTS))
def test_split_stateful_apply_matches_jax(name):
    """Two chained steps through `ensemble_update` on a 4-shard ragged
    SplitEmbedding (13/13/13/11 rows), weighted bags: tables and every
    state leaf equal JAX's SplitEmbedding update (jitted: one program per
    optimizer) and the port's own SimpleEmbedding update, and nothing
    materializes the table."""
    jopt, popt = SPLIT_OPTS[name]
    rng = np.random.default_rng(12 + len(name))
    data = rng.standard_normal((NROWS, 8)).astype(np.float32)
    pairs = [_upd(rng, 9, 8, bag=3, weighted=True) for _ in range(2)]
    jstep = jax.jit(lambda t, u, s: et.ensemble_update(jopt, [t], [u], s))
    jsplit, js = et.SplitEmbedding(data, 13), [jopt.init(jnp.asarray(data))]
    psplit, ps = ett.SplitEmbedding(torch.from_numpy(data.copy()), 13), None
    simple, ss = ett.SimpleEmbedding(torch.from_numpy(data.copy())), None
    shards = [s.data_ptr() for s in psplit.shards]
    with mock.patch.object(ett.SplitEmbedding, "materialize",
                           side_effect=AssertionError("materialized")):
        for jupd, pupd in pairs:
            [jsplit], js = jstep(jsplit, jupd, js)
            [psplit], [ps] = ett.ensemble_update(popt, [psplit], [pupd],
                                                 ps and [ps])
            [simple], [ss] = ett.ensemble_update(popt, [simple], [pupd],
                                                 ss and [ss])
    assert [s.data_ptr() for s in psplit.shards] == shards      # in place
    got = psplit.materialize().numpy()
    np.testing.assert_allclose(got, np.asarray(jsplit.materialize()), **TOL)
    np.testing.assert_allclose(got, simple.data.numpy(), **TOL)
    for p, j, s in zip(ps, jax.tree_util.tree_leaves(js), ss):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
        np.testing.assert_allclose(p.numpy(), s.numpy(), **TOL)
    if name == "lazy_adam":
        assert ps.count.dtype == torch.int32 and int(ps.count) == 2
