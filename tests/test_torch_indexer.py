"""The port's indexer (`ops/indexer.py`) against the JAX package's, on the
same numpy ids on the CPU; mirrors `tests/test_indexer.py`. The JAX side
sees 48 ids in every case, so its ops compile once.

Every field of `IndexerResult` is integer work, so the comparisons are
exact: `unique` with its -1 padding, `num_unique`, `offsets`, `map` and
`group_of`, for `SparseIndexer` and `DenseIndexer`, on vector and bag ids.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import embeddingtables_tpu as et
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.ops import indexer as I
from _torch_threads import _one_torch_thread  # noqa: F401


FIELDS = ("unique", "num_unique", "offsets", "map", "group_of")


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_index(indexer, vocab, idx):
    """JAX's `index`, jitted: one compile per indexer and vocabulary."""
    jix = et.SparseIndexer() if indexer == "sparse" else et.DenseIndexer()
    return et.index(idx, vocab=vocab, indexer=jix)


def _assert_same(jres, pres):
    for f in FIELDS:
        got = getattr(pres, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jres, f)),
                                      err_msg=f)


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["vector", "bags"])
def test_flatten_indices_matches_jax(shape):
    idx = np.array([5, 3, 2, 5], np.int32).reshape(shape)
    jrows, jcols = et.flatten_indices(jnp.asarray(idx))
    rows, cols = ett.flatten_indices(torch.from_numpy(idx))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    assert cols.tolist() == ([0, 1, 2, 3] if len(shape) == 1 else [0, 0, 1, 1])
    with pytest.raises(ValueError, match="1-D or 2-D"):
        ett.flatten_indices(torch.zeros((2, 2, 2), dtype=torch.int32))


def test_hand_worked_stream():
    # 4 1 4 2 1 4 -> unique (first occurrence) 4 1 2; 4 <- cols 0 2 5,
    # 1 <- cols 1 4, 2 <- col 3.
    stream = torch.tensor([4, 1, 4, 2, 1, 4], dtype=torch.int32)
    for res in (ett.index(stream), ett.index(stream, 8, ett.DenseIndexer())):
        assert int(res.num_unique) == 3 and res.num_unique.dim() == 0
        assert res.unique.tolist() == [4, 1, 2, -1, -1, -1]
        assert res.offsets[:4].tolist() == [0, 3, 5, 6]
        assert res.map.tolist() == [0, 2, 5, 1, 4, 3]
        assert res.group_of.tolist() == [0, 1, 0, 2, 1, 0]
        assert res.capacity == 6


@pytest.mark.parametrize("indexer", ["sparse", "dense"])
@pytest.mark.parametrize("shape,vocab", [((48,), 10), ((48,), 1000),
                                         ((48,), 48), ((16, 3), 30),
                                         ((12, 4), 300)])
def test_indexer_matches_jax(indexer, shape, vocab):
    rng = np.random.default_rng(vocab + len(shape))
    idx = rng.integers(0, vocab, shape).astype(np.int32)
    _assert_same(_jax_index(indexer, None if indexer == "sparse" else vocab,
                            jnp.asarray(idx)),
                 ett.index(torch.from_numpy(idx), vocab=vocab,
                           indexer=ett.SparseIndexer() if indexer == "sparse"
                           else ett.DenseIndexer()))


def test_first_occurrence_order():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 30, 100).astype(np.int32)
    res = ett.index(torch.from_numpy(idx))
    nu = int(res.num_unique)
    want = list(dict.fromkeys(idx.tolist()))
    assert res.unique[:nu].tolist() == want
    for g, v in enumerate(want):
        cols = res.map[res.offsets[g]:res.offsets[g + 1]].tolist()
        assert cols == [o for o, x in enumerate(idx.tolist()) if x == v]


def test_sparse_indexer_takes_any_ids_as_jax_does():
    # Sort-based: ids outside any vocabulary are ordinary values.
    idx = np.array([5, -3, 12, 5, -3, 40, -1, 7, 2**31 - 1, -2**31] * 4
                   + [9] * 8, np.int32)
    _assert_same(_jax_index("sparse", None, jnp.asarray(idx)),
                 ett.index(torch.from_numpy(idx)))


def test_dense_indexer_gives_the_sparse_result_for_ids_outside_the_vocab():
    # A port-side choice: JAX's DenseIndexer drops ids >= V from its
    # histogram and clamps its group lookup, which merges them into the
    # group of the largest id inside; the port gives such ids their own
    # groups, so both indexers agree on every stream.
    idx = torch.tensor([5, -3, 12, 5, -3, 40, -1, 7, 9, 12], dtype=torch.int32)
    want = ett.index(idx)
    got = ett.index(idx, vocab=10, indexer=ett.DenseIndexer())
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="requires vocab"):
        ett.index(idx, indexer=ett.DenseIndexer())


@pytest.mark.parametrize("num_splits", [1, 2, 4])
def test_indexer_view_bounds_match_jax(num_splits):
    rng = np.random.default_rng(num_splits)
    idx = rng.integers(0, 40, 48).astype(np.int32)
    jres = _jax_index("sparse", None, jnp.asarray(idx))
    pres = ett.index(torch.from_numpy(idx))
    covered = []
    for j in range(num_splits):
        jv, pv = et.indexer_view(jres, num_splits, j), \
            ett.indexer_view(pres, num_splits, j)
        assert pv.parent is pres
        assert (int(pv.lo), int(pv.hi)) == (int(jv.lo), int(jv.hi))
        covered += list(range(int(pv.lo), int(pv.hi)))
    assert covered == list(range(int(pres.num_unique)))
    assert int(I.cdiv_dynamic(torch.tensor(7), 2)) == 4


def test_empty_stream():
    res = ett.index(torch.zeros(0, dtype=torch.int32))
    assert int(res.num_unique) == 0 and res.offsets.tolist() == [0]
