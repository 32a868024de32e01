"""The port's compositional tables (QR, MD, TT) against the JAX package's,
on the CPU.

Each JAX table crosses into the port through its `*_from_arrays` builder,
and both packages run the same numpy ids: `rows` (with ids past the vocab,
negative and out of range, whose NaN rows must sit in the same places), the
`*_lookup_vjp` outputs and sub-table updates, one SGD and one indexer
AdaGrad step of every sub-table, `scatter_apply` and `materialize`. Rows and
updates agree up to the order of f32 sums: rtol/atol 1e-5. The factor
searches of TT are pure Python, held to JAX's tuples exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu import md as JMD
from embeddingtables_tpu import optim as J
from embeddingtables_tpu import qr as JQR
from embeddingtables_tpu import tt as JTT
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch import tt as PTT
from _torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

# The JAX tables' methods, jitted: one compile per program instead of one
# per op.
_rows = jax.jit(lambda t, i: t.rows(i))
_materialize = jax.jit(lambda t: t.materialize())
_scatter_apply = jax.jit(lambda t, i, d: t.scatter_apply(i, d))
_sub_updates = jax.jit(lambda t, i, d: t._sub_updates(i, d))


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), **TOL)


def _ids(v, span, rng, n=24):
    """In-range ids, then ids in [v, span), negatives and far ones."""
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[:6] = [v, span - 1, -1, -v, span + 3, 2**31 - 1]
    return ids


def test_factor_searches_give_jax_tuples():
    for n in (2, 7, 97, 1000, 123457, 40_000_000):
        for k in (1, 2, 3, 4):
            assert PTT._balanced_factors(n, k) == JTT._balanced_factors(n, k)
    for n in (1, 7, 60, 128, 129, 256, 1000):
        for k in (1, 2, 3):
            assert PTT._exact_factors(n, k) == JTT._exact_factors(n, k)


def _upd_close(pu, ju):
    _close(pu.delta, ju.delta)
    np.testing.assert_array_equal(pu.indices.numpy(), np.asarray(ju.indices))


def _step_both(jdata, jupd, pdata, pupd, name):
    """One step of `name` on a sub-table in both packages."""
    jopt, popt = {"sgd": (J.SparseSGD(0.1), P.SparseSGD(0.1)),
                  "adagrad": (J.SparseRowWiseAdaGrad(0.1, method="indexer"),
                              P.SparseRowWiseAdaGrad(0.1, method="indexer"))
                  }[name]
    jnew = jax.jit(lambda d, u: jopt.apply(d, u, jopt.init(d))[0])(
        jdata, jupd)
    popt.apply(pdata, pupd, popt.init(pdata))
    _close(pdata, jnew)


@pytest.mark.parametrize("combine", ["mult", "add", "concat"])
def test_qr_matches_jax(combine):
    v, dim = 101, 8
    jt = JQR.QREmbedding.create(jax.random.key(0), v, dim, combine=combine,
                                num_remainder=10)
    pt = ett.qr_from_arrays(np.asarray(jt.q_data), np.asarray(jt.r_data), v,
                            combine=combine, device="cpu")
    assert pt.shape == jt.shape and pt.compression() == jt.compression()
    nq = jt.q_data.shape[0]
    ids = _ids(v, nq * 10, np.random.default_rng(1))
    _close(pt.rows(torch.from_numpy(ids)), _rows(jt, jnp.asarray(ids)))
    _close(pt.materialize(), _materialize(jt))
    qi, ri = pt.split_indices(torch.from_numpy(ids))
    jqi, jri = jt.split_indices(jnp.asarray(ids))
    assert qi.dtype == ri.dtype == torch.int32
    np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))

    ok = ids[6:]
    delta = np.random.default_rng(2).standard_normal(
        (ok.size, dim)).astype(np.float32)
    pout, ppull = ett.qr_lookup_vjp(pt, torch.from_numpy(ok))
    _close(pout, _rows(jt, jnp.asarray(ok)))
    pus = ppull(torch.from_numpy(delta))
    jus = _sub_updates(jt, jnp.asarray(ok), jnp.asarray(delta))
    for pu, ju in zip(pus, jus):
        _upd_close(pu, ju)
    # Indexer AdaGrad on the product's sub-tables only (its arithmetic does
    # not depend on the combine).
    for name in ("sgd", "adagrad") if combine == "mult" else ("sgd",):
        for pdata, jdata, pu, ju in zip((pt.q_data.clone(), pt.r_data.clone()),
                                        (jt.q_data, jt.r_data), pus, jus):
            _step_both(jdata, ju, pdata, pu, name)
    jt2 = _scatter_apply(jt, jnp.asarray(ids[:8]), jnp.asarray(delta[:8]))
    assert pt.scatter_apply(torch.from_numpy(ids[:8]),
                            torch.from_numpy(delta[:8])) is pt
    _close(pt.q_data, jt2.q_data)
    _close(pt.r_data, jt2.r_data)


def test_md_matches_jax():
    v, dim, ds = 60, 8, 3
    jt = JMD.MDEmbedding.create(jax.random.key(1), v, dim, ds)
    pt = ett.md_from_arrays(np.asarray(jt.data), np.asarray(jt.proj),
                            device="cpu")
    assert pt.shape == jt.shape and pt.d_small == ds
    assert pt.compression() == jt.compression()
    ids = _ids(v, v + 5, np.random.default_rng(3))
    _close(pt.rows(torch.from_numpy(ids)), _rows(jt, jnp.asarray(ids)))
    _close(pt.rows(torch.from_numpy(ids[6:].reshape(3, 6))),
           _rows(jt, jnp.asarray(ids[6:].reshape(3, 6))))
    _close(pt.materialize(), _materialize(jt))
    ok = ids[6:]
    delta = np.random.default_rng(4).standard_normal(
        (ok.size, dim)).astype(np.float32)
    pout, ppull = ett.md_lookup_vjp(pt, torch.from_numpy(ok))
    md_vjp = jax.jit(lambda t, i, d: (lambda o, pull: (o, pull(d)))(
        *JMD.md_lookup_vjp(t, i)))
    jout, (ju, jgrad) = md_vjp(jt, jnp.asarray(ok), jnp.asarray(delta))
    _close(pout, jout)
    pu, pgrad = ppull(torch.from_numpy(delta))
    _upd_close(pu, ju)
    _close(pgrad, jgrad)
    for name in ("sgd", "adagrad"):
        _step_both(jt.data, ju, pt.data.clone(), pu, name)
    jt2 = _scatter_apply(jt, jnp.asarray(ids[:8]), jnp.asarray(delta[:8]))
    pt.scatter_apply(torch.from_numpy(ids[:8]), torch.from_numpy(delta[:8]))
    _close(pt.data, jt2.data)
    for fn in (JMD.md_lookup_vjp, ett.md_lookup_vjp):
        with pytest.raises(ValueError, match=r"\(B,\)"):
            fn(jt if fn is JMD.md_lookup_vjp else pt, np.zeros((2, 2), np.int32))


@pytest.fixture(scope="module")
def tt_pair():
    v, dim = 500, 8
    jt = JTT.TTEmbedding.create(jax.random.key(2), v, dim, rank=3)
    pt = ett.tt_from_arrays([np.asarray(c) for c in jt.cores], v,
                            device="cpu")
    return jt, pt


def test_tt_rows_match_jax(tt_pair):
    jt, pt = tt_pair
    assert pt.vocab_factors == jt.vocab_factors
    assert pt.dim_factors == jt.dim_factors
    assert pt.compression() == jt.compression()
    span = int(np.prod(jt.vocab_factors))
    ids = _ids(jt.spec.vocab, span, np.random.default_rng(5))
    digits = PTT._digits(torch.from_numpy(ids), pt.vocab_factors)
    for pd, jd in zip(digits, JTT._digits(jnp.asarray(ids), jt.vocab_factors)):
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    _close(pt.rows(torch.from_numpy(ids)), _rows(jt, jnp.asarray(ids)))
    bag = ids[6:].reshape(3, 6)
    _close(ett.lookup(pt, torch.from_numpy(bag)),
           _rows(jt, jnp.asarray(bag)).sum(1))
    _close(pt.materialize(), _materialize(jt))
    for ct, jc in zip(pt.core_tables(), jt.core_tables()):
        assert ct.shape == jc.shape


def test_tt_pullback_and_steps_match_jax(tt_pair):
    jt, pt = tt_pair
    ids = np.random.default_rng(6).integers(0, jt.spec.vocab, 20).astype(
        np.int32)
    ids[:3] = [7, 7, 7]                    # duplicates accumulate
    delta = np.random.default_rng(7).standard_normal((20, 8)).astype(
        np.float32)
    pout, ppull = ett.tt_lookup_vjp(pt, torch.from_numpy(ids))
    _close(pout, _rows(jt, jnp.asarray(ids)))
    pus = ppull(torch.from_numpy(delta))
    jus = _sub_updates(jt, jnp.asarray(ids), jnp.asarray(delta))
    assert len(pus) == len(jus) == 3
    for pu, ju in zip(pus, jus):
        _upd_close(pu, ju)
    for name in ("sgd", "adagrad"):
        for pdata, jdata, pu, ju in zip(pt.core_tables(), jt.core_tables(),
                                        pus, jus):
            _step_both(jdata, ju, pdata.clone(), pu, name)
    # In place through the core-table views: one update changes its core.
    core0 = pt.cores[0].clone()
    P.SparseSGD(0.1).apply(pt.core_tables()[0], pus[0],
                           P.SparseSGD().init(pt.cores[0]))
    assert not torch.equal(core0, pt.cores[0])
    pt.cores[0].copy_(core0)
    new = pt.replace_core_tables([t.clone() for t in pt.core_tables()])
    assert all(a.shape == b.shape for a, b in zip(new.cores, pt.cores))


def test_tt_scatter_apply_matches_jax():
    v, dim = 90, 4
    jt = JTT.TTEmbedding.create(jax.random.key(3), v, dim, rank=2,
                                num_cores=2)
    pt = ett.tt_from_arrays([np.asarray(c) for c in jt.cores], v,
                            device="cpu")
    ids = np.array([1, 5, 5, 89, 30], np.int32)
    delta = np.random.default_rng(8).standard_normal((5, dim)).astype(
        np.float32)
    jt2 = _scatter_apply(jt, jnp.asarray(ids), jnp.asarray(delta))
    assert pt.scatter_apply(torch.from_numpy(ids),
                            torch.from_numpy(delta)) is pt
    for pc, jc in zip(pt.cores, jt2.cores):
        _close(pc, jc)


@pytest.mark.parametrize("kind", ["qr", "md", "tt"])
def test_create_gives_jax_shapes(kind):
    # JAX's shapes, traced rather than run.
    g = torch.Generator().manual_seed(0)
    key = jax.random.key(0)
    if kind == "qr":
        jt = jax.eval_shape(lambda: JQR.QREmbedding.create(key, 1000, 16))
        pt = ett.QREmbedding.create(g, 1000, 16, device="cpu")
        pairs = [(pt.q_data, jt.q_data), (pt.r_data, jt.r_data)]
        assert pt.num_remainder == jt.num_remainder
    elif kind == "md":
        jt = jax.eval_shape(lambda: JMD.MDEmbedding.create(key, 1000, 16, 4))
        pt = ett.MDEmbedding.create(g, 1000, 16, 4, device="cpu")
        pairs = [(pt.data, jt.data), (pt.proj, jt.proj)]
    else:
        jt = jax.eval_shape(lambda: JTT.TTEmbedding.create(key, 1000, 16))
        pt = ett.TTEmbedding.create(g, 1000, 16, device="cpu")
        pairs = list(zip(pt.cores, jt.cores))
        assert pt.vocab_factors == jt.vocab_factors
    for p, j in pairs:
        assert tuple(p.shape) == tuple(j.shape)
        assert p.dtype == torch.float32 and p.device.type == "cpu"
    # Row scale near a plain table's 1/sqrt(dim), as JAX's init aims.
    rows = pt.rows(torch.arange(1000))
    assert 0.1 < float(rows.std()) < 0.5
