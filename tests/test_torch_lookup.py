"""The port's `lookup` and stacked-ensemble id handling against the JAX
package's (auto path, `jnp.take`), on the same numpy inputs.

f32 tolerances cover summation order only. bf16 tables: the port sums bags
in f32 and rounds once; XLA on the CPU also widens bf16 sums to f32, and the
two agree exactly here. The bound is one bf16 rounding (2^-8 relative, and
absolute for values below 1), for an XLA build that rounds elsewhere.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import embeddingtables_tpu as et
from embeddingtables_tpu.models.dlrm import embedding_forward as jax_emb_fwd
from embeddingtables_tpu.models.dlrm import \
    stacked_flat_indices as jax_flat_indices
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.interop import tensor_from_array
from embeddingtables_tpu_torch.models.dlrm import (embedding_forward,
                                                  stacked_flat_indices)
from _torch_threads import _one_torch_thread  # noqa: F401


V, D, B, BAG = 40, 16, 12, 4
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=2 ** -8, atol=2 ** -8)}

CASES = {
    # name: (ids ndim, combiner, weighted, pad_idx)
    "rows": (1, "sum", False, None),
    "rows_mean_is_sum": (1, "mean", False, None),
    "rows_weighted": (1, "sum", True, None),
    "bag_sum": (2, "sum", False, None),
    "bag_mean": (2, "mean", False, None),
    "bag_sum_weighted": (2, "sum", True, None),
    "bag_mean_weighted": (2, "mean", True, None),
    "rows_pad_minus1": (1, "sum", False, -1),
    "rows_pad_vocab_weighted": (1, "sum", True, V),
    "bag_sum_pad_minus1": (2, "sum", False, -1),
    "bag_mean_pad_vocab": (2, "mean", False, V),
    "bag_mean_pad_0_weighted": (2, "mean", True, 0),
}


def _inputs(seed, dtype, ndim, weighted, pad_idx):
    rng = np.random.default_rng(seed)
    arr = np.asarray(jnp.asarray(rng.standard_normal((V, D)).astype(
        np.float32), jnp.float32 if dtype == "float32" else jnp.bfloat16))
    shape = (B,) if ndim == 1 else (B, BAG)
    idx = rng.integers(0, V, shape).astype(np.int32)
    if pad_idx is not None:
        idx[rng.random(shape) < 0.3] = pad_idx
        if ndim == 2:
            idx[0] = pad_idx                       # an all-pad bag
    w = rng.uniform(0.5, 1.5, shape).astype(np.float32) if weighted else None
    return arr, idx, w


def _port(arr, idx, w, combiner, pad_idx):
    table = ett.SimpleEmbedding(tensor_from_array(arr, "cpu"))
    out = ett.lookup(table, idx, combiner=combiner, weights=w,
                     pad_idx=pad_idx)
    return out.float().numpy()


def _jax(arr, idx, w, combiner, pad_idx):
    out = et.lookup(et.SimpleEmbedding(jnp.asarray(arr)), jnp.asarray(idx),
                    combiner=combiner,
                    weights=None if w is None else jnp.asarray(w),
                    pad_idx=pad_idx)
    return np.asarray(out).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_matches_jax(case, dtype):
    ndim, combiner, weighted, pad_idx = CASES[case]
    arr, idx, w = _inputs(len(case), dtype, ndim, weighted, pad_idx)
    got = _port(arr, idx, w, combiner, pad_idx)
    want = _jax(arr, idx, w, combiner, pad_idx)
    assert got.shape == want.shape == (B, D)
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_all_pad_bag_is_a_zero_row():
    arr, idx, _ = _inputs(1, "float32", 2, False, -1)
    got = _port(arr, idx, None, "mean", -1)
    assert (got[0] == 0).all()


def test_raw_tensor_and_protocol_table_take_the_same_path():
    arr, idx, _ = _inputs(2, "float32", 2, False, None)
    t = tensor_from_array(arr, "cpu")

    class RowsOnly:                       # a user table with the protocol
        spec = ett.TableSpec(vocab=V, dim=D)

        def rows(self, i, context=None):
            return t[i.long()]

        def example(self):
            return t

    want = _jax(arr, idx, None, "sum", None)
    for table in (t, RowsOnly()):
        got = ett.lookup(table, idx).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_lookup_oracle_matches_jax_oracle():
    arr, idx, w = _inputs(3, "float32", 2, True, V)
    got = ett.lookup_oracle(tensor_from_array(arr, "cpu"), idx, "mean", w,
                            pad_idx=V).numpy()
    want = np.asarray(et.lookup_oracle(jnp.asarray(arr), jnp.asarray(idx),
                                       "mean", jnp.asarray(w), pad_idx=V))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["rows", "bag_sum", "bag_mean",
                                  "bag_sum_weighted"])
def test_out_of_range_contract_matches_jax(case):
    # JAX under jit: [-V, 0) wraps, anything else is a NaN row; a bag with
    # one NaN row sums to NaN.
    ndim, combiner, weighted, _ = CASES[case]
    arr, idx, w = _inputs(4, "float32", ndim, weighted, None)
    bad = np.array([-1, -V, -V - 1, V, 2**31 - 1, -2**31], np.int32)
    if ndim == 1:
        idx[:bad.size] = bad
    else:
        idx[:bad.size, 1] = bad
    got = _port(arr, idx, w, combiner, None)
    f = jax.jit(lambda t, i, ww: et.lookup(t, i, combiner=combiner,
                                           weights=ww))
    want = np.asarray(f(jnp.asarray(arr), jnp.asarray(idx),
                        None if w is None else jnp.asarray(w)))
    assert np.isnan(want).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Stacked ensemble ids
# ---------------------------------------------------------------------------

VOCABS = (7, 11, 5)


def _stacked(rng):
    data = rng.standard_normal((sum(VOCABS), D)).astype(np.float32)
    offs = tuple(np.concatenate([[0], np.cumsum(VOCABS)]).tolist())
    return (et.StackedTables(data=jnp.asarray(data), offsets=offs, dim=D),
            ett.StackedTables(torch.from_numpy(data), offs, D))


def test_shift_indices_matches_jax():
    rng = np.random.default_rng(5)
    jt, pt = _stacked(rng)
    ids = [rng.integers(0, v, (B,)).astype(np.int32) for v in VOCABS]
    want = np.asarray(jt.shift_indices([jnp.asarray(i) for i in ids]))
    got = pt.shift_indices([torch.from_numpy(i) for i in ids])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pt.shift_indices(torch.from_numpy(np.stack(ids))).numpy(), want)
    assert pt.vocabs == VOCABS and pt.ntables == 3
    np.testing.assert_array_equal(pt.table(1).data.numpy(),
                                  np.asarray(jt.table(1).data))


@pytest.mark.parametrize("bag", [None, 3])
@pytest.mark.parametrize("pad_idx", [None, -1, 11])
def test_stacked_flat_indices_match_jax(bag, pad_idx):
    rng = np.random.default_rng(6)
    jt, pt = _stacked(rng)
    shape = (B,) if bag is None else (B, bag)
    cat = np.stack([rng.integers(0, v, shape) for v in VOCABS]).astype(
        np.int32)
    if pad_idx is not None:
        cat[rng.random(cat.shape) < 0.3] = pad_idx
    wf, wv = jax_flat_indices(jt, jnp.asarray(cat), pad_idx)
    gf, gv = stacked_flat_indices(pt, torch.from_numpy(cat), pad_idx)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    if pad_idx is None:
        assert gv is None and wv is None
    else:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_local_out_of_range_ids_follow_the_stacked_shift(combiner):
    # The contract applies after the offset shift: a local -1 of table t>0
    # lands on table t-1's last row, a global -1 (table 0) wraps to the last
    # row of the stack, and a local id past the last table is NaN.
    rng = np.random.default_rng(8)
    jt, pt = _stacked(rng)
    cat = np.stack([rng.integers(0, v, (B, 2)) for v in VOCABS]).astype(
        np.int32)
    cat[:, 0, 0] = -1
    cat[2, 1, 1] = VOCABS[2]
    want = np.asarray(jax.jit(lambda t, c: jax_emb_fwd(t, c, combiner))(
        jt, jnp.asarray(cat)))
    got = embedding_forward(pt, torch.from_numpy(cat), combiner).numpy()
    assert np.isnan(want[2, 1]).all() and not np.isnan(want[:, 0]).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pad_idx", [None, -1])
@pytest.mark.parametrize("ndim,combiner", [(1, "sum"), (2, "sum"),
                                           (2, "mean")])
def test_lookup_oracle_indexes_out_of_range_ids_as_jax(ndim, combiner,
                                                       pad_idx):
    # JAX's `data[idx]`: an id in [-V, 0) wraps once, any other id clamps to
    # [0, V-1]; the pad sentinel is masked before either.
    arr, idx, w = _inputs(5, "float32", ndim, True, None)
    bad = np.array([-1, -V, -V - 1, V, V + 3, 2**31 - 1, -2**31, -7],
                   np.int32)
    idx.reshape(-1)[:bad.size] = bad
    if pad_idx is not None:
        idx.reshape(-1)[-3:] = pad_idx
    got = ett.lookup_oracle(tensor_from_array(arr, "cpu"), idx, combiner, w,
                            pad_idx=pad_idx).numpy()
    want = np.asarray(et.lookup_oracle(jnp.asarray(arr), jnp.asarray(idx),
                                       combiner, jnp.asarray(w),
                                       pad_idx=pad_idx))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
