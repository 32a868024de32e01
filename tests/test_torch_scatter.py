"""The port's run-scatter and lazy-update layer against the JAX package's, on
the same numpy inputs on the CPU.

  - `scatter_add_rows_sorted`'s plain version (what a CPU tensor runs, and
    what the CUDA kernel is held to on the card) against the Pallas kernel in
    interpret mode, with n <= 16 because interpret mode unrolls the tile.
  - `sgd_update`, `uncompress`, `accumulate_updates`, `effective_weights`,
    `lookup_vjp` and `ensemble_update` against their JAX counterparts.

Tolerances: both run-scatters sum each run in f32 in stream order and round
the row once, so f32 results agree to rtol 1e-6 (a fused multiply-add on one
side is the only freedom); bf16 tables to one bf16 rounding (2^-8). Against
JAX's XLA scatter, which adds each occurrence into the row separately, the
order of the f32 additions differs: rtol/atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import embeddingtables_tpu as et
from embeddingtables_tpu.ops.pallas.scatter import \
    scatter_add_rows_sorted as pallas_runscatter
from embeddingtables_tpu.ops.pallas.scatter import \
    scatter_update as pallas_scatter_update
from embeddingtables_tpu.optim import SparseRowWiseAdaGrad as JaxAdaGrad
from embeddingtables_tpu.optim import SparseSGD as JaxSGD
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.interop import tensor_from_array
from embeddingtables_tpu_torch.ops.cuda import scatter as S

D = 128
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)


def _table(rng, v, d, dtype="float32"):
    arr = rng.standard_normal((v, d)).astype(np.float32)
    return np.asarray(jnp.asarray(arr, getattr(jnp, dtype)))


def _sorted_stream(rng, n, v, pad_frac=0.2):
    rows = rng.integers(0, v, n)
    rows[rng.random(n) < pad_frac] = -1
    return np.sort(rows).astype(np.int32)


@pytest.mark.parametrize("dtype,n,v", [("float32", 8, 8), ("bfloat16", 8, 8),
                                       ("float32", 16, 5)])
def test_plain_run_scatter_matches_pallas_kernel(dtype, n, v):
    rng = np.random.default_rng(n + v)
    arr = _table(rng, v, D, dtype)
    rows = _sorted_stream(rng, n, v)
    vals = rng.standard_normal((n, D)).astype(np.float32)
    want = np.asarray(pallas_runscatter(jnp.asarray(arr), jnp.asarray(rows),
                                        jnp.asarray(vals), -0.5,
                                        interpret=True)).astype(np.float32)
    table = tensor_from_array(arr, "cpu")
    got = S.scatter_add_rows_sorted(table, torch.from_numpy(rows),
                                    torch.from_numpy(vals), -0.5)
    assert got is table
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_negative_padding_is_dropped():
    # Sorted ascending, padding comes first and carries values that an
    # unmasked accumulator would leak into the first real run.
    table = torch.zeros((8, D))
    rows = torch.tensor([-1, -1, -1, -1, -1, 2, 2, 5], dtype=torch.int32)
    vals = torch.full((8, D), 100.0)
    vals[5], vals[6], vals[7] = 1.0, 2.0, 7.0
    S.scatter_add_rows_sorted(table, rows, vals, 1.0)
    want = torch.zeros((8, D))
    want[2], want[5] = 3.0, 7.0
    assert torch.equal(table, want)


def test_rows_at_or_past_the_vocab_are_dropped():
    # The Pallas kernel would copy such a row out of bounds; the port drops
    # it, in the kernel and in its plain version.
    table = torch.ones((6, D))
    rows = torch.tensor([1, 1, 4, 6, 6, 9, 2**31 - 1], dtype=torch.int32)
    S.scatter_add_rows_sorted(table, rows, torch.ones((7, D)), 1.0)
    want = torch.ones((6, D))
    want[1], want[4] = 3.0, 2.0
    assert torch.equal(table, want)


def test_adagrad_epilogue_matches_its_formula():
    rng = np.random.default_rng(3)
    v, n = 10, 30
    table = torch.from_numpy(rng.standard_normal((v, D)).astype(np.float32))
    accum = torch.from_numpy(rng.random(v).astype(np.float32))
    rows = torch.from_numpy(_sorted_stream(rng, n, v))
    vals = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    t0, a0 = table.clone(), accum.clone()
    S.scatter_add_rows_sorted(table, rows, vals, -0.1, accum=accum, eps=1e-8)
    want_t, want_a = t0.double(), a0.double()
    for r in set(rows.tolist()) - {-1}:
        g = vals[rows == r].double().sum(0)
        want_a[r] += (g * g).mean()
        want_t[r] -= 0.1 * g / torch.sqrt(want_a[r] + 1e-8)
    np.testing.assert_allclose(accum.numpy(), want_a.numpy(), rtol=1e-6)
    np.testing.assert_allclose(table.numpy(), want_t.numpy(), rtol=1e-5,
                               atol=1e-6)


L = S.RUN_WINDOW


def _window_edge_stream(rng, v):
    """Sorted rows whose runs cross multiples of L: padding before the first
    edge, runs of L and L + 1, a run starting at L - 1 (mod L) and spanning
    five windows, a run filling one window exactly, short runs, rows >= V."""
    pad = L // 4
    lengths = [L, L + 1, L - 2 - pad, 3 * L + 5, L - 4, L, 1, 2, 3, L + 1, 7]
    assert pad + sum(lengths[:3]) == 3 * L - 1          # the long run's start
    assert (pad + sum(lengths[:5])) % L == 0            # the window-filling run
    rows = [-1] * pad
    for row, length in zip(sorted(rng.choice(v, len(lengths), replace=False)),
                           lengths):
        rows += [int(row)] * length
    rows += [v] * 9 + [v + 3] * 11
    return np.asarray(rows, np.int32)


def _zipf_stream(rng, v, n=2500):
    rows = np.minimum(rng.zipf(1.5, n) - 1, v + 2)      # hot low rows, >= V
    rows[rng.random(n) < 0.05] = -1
    return np.sort(rows).astype(np.int32)


def _numpy_run_sums(rows, vals, v):
    """{row: f32 run sum}: pieces cut at run starts and multiples of L, each
    summed from zero in stream order, then folded left to right."""
    sums, pieces, piece, cur = {}, [], None, None
    for k, r in enumerate(rows.tolist()):
        if r != cur or k % L == 0:
            if piece is not None:
                pieces.append(piece)
            piece = None
        if r != cur:
            if pieces:
                acc = pieces[0]
                for p in pieces[1:]:
                    acc = acc + p
                sums[cur] = acc
            pieces, cur = [], r
        if 0 <= r < v:
            piece = (np.zeros(vals.shape[1], np.float32) if piece is None
                     else piece) + vals[k]
    if piece is not None:
        pieces.append(piece)
    if pieces:
        acc = pieces[0]
        for p in pieces[1:]:
            acc = acc + p
        sums[cur] = acc
    return sums


@pytest.mark.parametrize("stream", ["window_edges", "zipf"])
def test_plain_run_scatter_order_across_window_edges(stream):
    rng = np.random.default_rng(len(stream))
    v, d, scale = 40, 16, np.float32(-0.02)
    rows = (_window_edge_stream(rng, v) if stream == "window_edges"
            else _zipf_stream(rng, v))
    vals = rng.standard_normal((rows.size, d)).astype(np.float32)
    arr = rng.standard_normal((v, d)).astype(np.float32)
    sums = _numpy_run_sums(rows, vals, v)
    assert max(np.bincount(rows[(rows >= 0) & (rows < v)])) > 2 * L

    # SGD: bitwise the numpy loop.
    want = arr.copy()
    for r, g in sums.items():
        want[r] = want[r] + scale * g
    table = torch.from_numpy(arr.copy())
    S.scatter_add_rows_sorted(table, torch.from_numpy(rows),
                              torch.from_numpy(vals), float(scale))
    np.testing.assert_array_equal(table.numpy().view(np.int32),
                                  want.view(np.int32))
    # ... and JAX's scatter-add up to the order of the f32 additions.
    jrows = np.where(rows < 0, v, rows)
    jax_want = jnp.asarray(arr).at[jrows].add(scale * jnp.asarray(vals),
                                              mode="drop")
    np.testing.assert_allclose(table.numpy(), np.asarray(jax_want),
                               rtol=1e-5, atol=1e-5)

    # AdaGrad: the epilogue's formula in f64 on the same f32 run sums.
    accum = torch.from_numpy(rng.random(v).astype(np.float32))
    want_t, want_a = arr.astype(np.float64), accum.numpy().astype(np.float64)
    for r, g in sums.items():
        g = g.astype(np.float64)
        want_a[r] += (g * g).mean()
        want_t[r] -= 0.1 * g / np.sqrt(want_a[r] + 1e-8)
    table = torch.from_numpy(arr.copy())
    S.scatter_add_rows_sorted(table, torch.from_numpy(rows),
                              torch.from_numpy(vals), -0.1, accum=accum,
                              eps=1e-8)
    np.testing.assert_allclose(accum.numpy(), want_a, rtol=1e-6)
    np.testing.assert_allclose(table.numpy(), want_t, rtol=1e-5, atol=1e-6)


def test_empty_stream_changes_nothing():
    table = torch.ones((4, D))
    S.scatter_add_rows_sorted(table, torch.zeros(0, dtype=torch.int32),
                              torch.zeros((0, D)))
    assert torch.equal(table, torch.ones((4, D)))


@pytest.mark.parametrize("n", [12])
def test_scatter_update_matches_pallas_scatter_update(n):
    rng = np.random.default_rng(n)
    v = 6
    arr = _table(rng, v, D)
    rows = rng.integers(0, v, n).astype(np.int32)
    vals = rng.standard_normal((n, D)).astype(np.float32)
    want = np.asarray(pallas_scatter_update(
        jnp.asarray(arr), jnp.asarray(rows), jnp.asarray(vals), 0.25,
        interpret=True))
    got = S.scatter_update(tensor_from_array(arr, "cpu"),
                           torch.from_numpy(rows), torch.from_numpy(vals),
                           0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Lazy updates and sgd_update
# ---------------------------------------------------------------------------

V, B, BAG, DIM = 50, 24, 3, 16
LR = 0.5


def _update(rng, reducing, weighted, bad_ids):
    shape = (B, BAG) if reducing else (B,)
    idx = rng.integers(0, V, shape).astype(np.int32)
    if bad_ids:
        flat = idx.reshape(-1)
        flat[:6] = [-1, -V, -V - 1, V, V + 7, -2**31]
    delta = rng.standard_normal((B, DIM)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape).astype(np.float32) if weighted else None
    jupd = et.SparseEmbeddingUpdate(
        delta=jnp.asarray(delta), indices=jnp.asarray(idx),
        weights=None if w is None else jnp.asarray(w))
    pupd = ett.SparseEmbeddingUpdate(
        delta=torch.from_numpy(delta), indices=torch.from_numpy(idx),
        weights=None if w is None else torch.from_numpy(w))
    return jupd, pupd


UPDATES = {"rows": (False, False, False), "bag": (True, False, False),
           "bag_weighted": (True, True, False),
           "rows_weighted": (False, True, False),
           "rows_bad_ids": (False, False, True),
           "bag_bad_ids": (True, True, True)}


@pytest.mark.parametrize("method", ["auto", "scatter", "dedup", "pallas"])
@pytest.mark.parametrize("case", sorted(UPDATES))
def test_sgd_update_matches_jax(method, case):
    rng = np.random.default_rng(len(case))
    jupd, pupd = _update(rng, *UPDATES[case])
    arr = _table(rng, V, DIM)
    # The JAX scatter realization is the contract: `.at[rows].add`, with
    # [-V, 0) wrapped and other out-of-range ids dropped.
    want = np.asarray(et.sgd_update(jnp.asarray(arr), jupd, LR,
                                    method="scatter"))
    table = ett.SimpleEmbedding(tensor_from_array(arr, "cpu"))
    got = ett.sgd_update(table, pupd, LR, method=method)
    assert got is table
    np.testing.assert_allclose(table.data.numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_sgd_update_on_a_raw_tensor_updates_it_in_place():
    rng = np.random.default_rng(5)
    jupd, pupd = _update(rng, False, False, False)
    arr = _table(rng, V, DIM)
    data = tensor_from_array(arr, "cpu")
    assert ett.sgd_update(data, pupd, LR) is data
    want = np.asarray(arr - LR * et.uncompress(jupd, V))
    np.testing.assert_allclose(data.numpy(), want, rtol=1e-5, atol=1e-5)


def test_sgd_update_refuses_what_it_cannot_do():
    _, pupd = _update(np.random.default_rng(0), False, False, False)
    data = torch.zeros((V, DIM))
    with pytest.raises(ValueError, match="method"):
        ett.sgd_update(data, pupd, LR, method="xla")
    for kw in ({"idx_result": object()}, {"indexer": object()},
               {"view": object()}):
        with pytest.raises(NotImplementedError, match="indexer"):
            ett.sgd_update(data, pupd, LR, **kw)


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_uncompress_matches_jax(case):
    jupd, pupd = _update(np.random.default_rng(11), *UPDATES[case])
    np.testing.assert_allclose(ett.uncompress(pupd, V).numpy(),
                               np.asarray(et.uncompress(jupd, V)),
                               rtol=1e-6, atol=1e-6)


def test_accumulate_updates_matches_jax():
    rng = np.random.default_rng(12)
    (j1, p1), (j2, p2) = (_update(rng, True, True, False),
                          _update(rng, True, False, False))
    want = et.accumulate_updates([j1, j2])
    got = ett.accumulate_updates([p1, p2])
    for f in ("delta", "indices", "weights"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    with pytest.raises(ValueError, match="reducing"):
        ett.accumulate_updates([p1, _update(rng, False, False, False)[1]])


LOOKUPS = {
    # name: (bag, combiner, weighted, pad_idx)
    "rows": (None, "sum", False, None),
    "rows_weighted_pad": (None, "sum", True, -1),
    "bag_sum": (BAG, "sum", False, None),
    "bag_mean": (BAG, "mean", False, None),
    "bag_mean_weighted": (BAG, "mean", True, None),
    "bag_mean_pad": (BAG, "mean", False, V),
    "bag_sum_weighted_pad": (BAG, "sum", True, -1),
}


@pytest.mark.parametrize("case", sorted(LOOKUPS))
def test_lookup_vjp_matches_jax(case):
    bag, combiner, weighted, pad_idx = LOOKUPS[case]
    rng = np.random.default_rng(len(case) + 7)
    arr = _table(rng, V, DIM)
    shape = (B,) if bag is None else (B, bag)
    idx = rng.integers(0, V, shape).astype(np.int32)
    if pad_idx is not None:
        idx[rng.random(shape) < 0.3] = pad_idx
    w = rng.uniform(0.5, 1.5, shape).astype(np.float32) if weighted else None
    delta = rng.standard_normal((B, DIM)).astype(np.float32)
    jout, jpb = et.lookup_vjp(et.SimpleEmbedding(jnp.asarray(arr)),
                              jnp.asarray(idx), combiner=combiner,
                              weights=None if w is None else jnp.asarray(w),
                              pad_idx=pad_idx)
    pout, ppb = ett.lookup_vjp(ett.SimpleEmbedding(tensor_from_array(arr, "cpu")),
                               idx, combiner=combiner, weights=w,
                               pad_idx=pad_idx)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    jupd, pupd = jpb(jnp.asarray(delta)), ppb(torch.from_numpy(delta))
    np.testing.assert_array_equal(pupd.indices.numpy(), np.asarray(jupd.indices))
    assert (pupd.weights is None) == (jupd.weights is None)
    if pupd.weights is not None:
        np.testing.assert_allclose(pupd.weights.numpy(),
                                   np.asarray(jupd.weights), rtol=1e-6)
    # The pullback is lazy: the same delta, no scatter.
    assert torch.equal(pupd.delta, torch.from_numpy(delta))


def _ensemble(opt_name, rng):
    # One table on each side of the 512-padded-row line (hot_accumulate
    # below it, the scatter above), D = 128 so hot_accumulate applies.
    # JAX's indexer path reads the accumulator of a negative id at row 0
    # (a clip) but writes the row it wraps to, so AdaGrad gets no negatives.
    vocabs, b = (300, 1000), 40
    lo = -5 if opt_name == "sgd" else 0
    arrs = [_table(rng, v, D) for v in vocabs]
    idx = [rng.integers(lo, v + 5, b).astype(np.int32) for v in vocabs]
    deltas = [rng.standard_normal((b, D)).astype(np.float32) for _ in vocabs]
    if opt_name == "sgd":
        jopt, popt = JaxSGD(lr=LR), ett.SparseSGD(lr=LR)
    else:
        jopt = JaxAdaGrad(lr=LR, method="indexer")
        popt = ett.SparseRowWiseAdaGrad(lr=LR, method="indexer")
    jt, js = et.ensemble_update(
        jopt, [et.SimpleEmbedding(jnp.asarray(a)) for a in arrs],
        [et.SparseEmbeddingUpdate(delta=jnp.asarray(d), indices=jnp.asarray(i))
         for d, i in zip(deltas, idx)])
    pt, ps = ett.ensemble_update(
        popt, [ett.SimpleEmbedding(tensor_from_array(a, "cpu")) for a in arrs],
        [ett.SparseEmbeddingUpdate(delta=torch.from_numpy(d),
                                   indices=torch.from_numpy(i))
         for d, i in zip(deltas, idx)])
    return jt, js, pt, ps


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad_indexer"])
def test_ensemble_update_matches_jax(opt_name):
    jt, js, pt, ps = _ensemble(opt_name, np.random.default_rng(21))
    for j, p in zip(jt, pt):
        np.testing.assert_allclose(p.data.numpy(), np.asarray(j.data),
                                   rtol=1e-5, atol=1e-5)
    for j, p in zip(js, ps):
        np.testing.assert_allclose(p.accum.numpy(), np.asarray(j.accum),
                                   rtol=1e-5, atol=1e-7)


def test_ensemble_update_refuses_state_on_a_protocol_table():
    class RowsOnly:                       # a user table with the protocol
        spec = ett.TableSpec(vocab=V, dim=DIM)

        def rows(self, i, context=None):
            return torch.zeros((*i.shape, DIM))

        def example(self):
            return torch.zeros(1)

        def scatter_apply(self, rows, vals):
            return self

    _, pupd = _update(np.random.default_rng(0), False, False, False)
    t, s = ett.ensemble_update(ett.SparseSGD(lr=LR), [RowsOnly()], [pupd])
    assert isinstance(t[0], RowsOnly)
    with pytest.raises(TypeError, match="stateful or regularized"):
        ett.ensemble_update(ett.SparseRowWiseAdaGrad(lr=LR), [RowsOnly()],
                            [pupd])
    with pytest.raises(TypeError, match="stateful or regularized"):
        ett.ensemble_update(ett.SparseSGD(lr=LR, weight_decay=0.1),
                            [RowsOnly()], [pupd])
