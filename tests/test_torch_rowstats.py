"""The port's row lifecycle (`utils/rowstats.py`) and the CTR loops' row
eviction against the JAX package's, on the CPU.

`FrequencyTracker` is the JAX package's numpy code: counts, `seen`, cold
sets and permutations are held bitwise. `evict_rows`, `reset_rows_state` and
`relayout` are held exactly to JAX's (they copy or zero values), with
duplicate, negative and out-of-range ids. `train_dlrm`, `train_dcn` and
`train_deepfm` (unfolded: both stacks evicted) with `evict_every` are held
to JAX's loops from the same weights and batches: the same `evicted_rows`,
losses and tables within rtol/atol 1e-4 after four steps (f32 sums in
another order, as in `test_torch_train.py`), and the evicted rows zero in
the table and the optimizer state.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu import optim as J
from embeddingtables_tpu.models import dcn as JD
from embeddingtables_tpu.models import deepfm as JF
from embeddingtables_tpu.models import dlrm as JM
from embeddingtables_tpu.models import train as jax_train
from embeddingtables_tpu.utils import rowstats as JR
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.data import SyntheticCriteo
from embeddingtables_tpu_torch.utils import rowstats as PR
from _torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def test_frequency_tracker_is_bitwise_jax():
    rng = np.random.default_rng(0)
    jt, pt = JR.FrequencyTracker(50, decay=0.7), PR.FrequencyTracker(50, 0.7)
    for step in range(6):
        batch = rng.zipf(1.3, (4, 8)).clip(max=49).astype(np.int32)
        jt.observe(batch)
        pt.observe(batch)
        np.testing.assert_array_equal(pt.counts, jt.counts)
        np.testing.assert_array_equal(pt.seen, jt.seen)
        if step % 2:
            np.testing.assert_array_equal(pt.pop_cold(0.5), jt.pop_cold(0.5))
    np.testing.assert_array_equal(pt.top_rows(7), jt.top_rows(7))
    np.testing.assert_array_equal(pt.cold_rows(2.0), jt.cold_rows(2.0))
    perm = pt.frequency_permutation()
    np.testing.assert_array_equal(perm, jt.frequency_permutation())
    assert pt.coverage(5) == jt.coverage(5)
    inv = PR.inverse_permutation(perm)
    np.testing.assert_array_equal(inv, JR.inverse_permutation(perm))
    cat = rng.integers(0, 50, (2, 6, 3)).astype(np.int32)
    np.testing.assert_array_equal(PR.remap_batch(cat, [inv, perm]),
                                  JR.remap_batch(cat, [inv, perm]))
    with pytest.raises(ValueError, match="decay"):
        PR.FrequencyTracker(5, decay=0.0)


ROWS = np.array([3, 3, -1, 40, -41, 7, 2**31 - 1], np.int32)


def test_evict_rows_and_relayout_match_jax():
    data = np.random.default_rng(1).standard_normal((40, 4)).astype(
        np.float32)
    want = np.asarray(JR.evict_rows(jnp.asarray(data), ROWS, value=0.5))
    got = PR.evict_rows(torch.from_numpy(data.copy()), ROWS, value=0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    # Replacements from init_fn: each kept row takes its first
    # occurrence's draw.
    fresh = torch.arange(28, dtype=torch.float32).reshape(7, 4)
    got = PR.evict_rows(torch.from_numpy(data.copy()), ROWS,
                        init_fn=lambda g, shape, dt: fresh.to(dt),
                        generator=torch.Generator())
    np.testing.assert_array_equal(got.numpy()[[3, 39, 7]],
                                  fresh.numpy()[[0, 2, 5]])
    with pytest.raises(ValueError, match="generator"):
        PR.evict_rows(torch.zeros(4, 2), [1], init_fn=lambda *a: None)
    assert PR.evict_rows(torch.ones(4, 2), []).sum() == 8
    perm = np.random.default_rng(2).permutation(40).astype(np.int32)
    np.testing.assert_array_equal(
        PR.relayout(torch.from_numpy(data), perm).numpy(),
        np.asarray(JR.relayout(jnp.asarray(data), perm)))


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "lazy_adam", "ftrl"])
def test_reset_rows_state_matches_jax(opt):
    jopt, popt = {"sgd": (J.SparseSGD(), P.SparseSGD()),
                  "adagrad": (J.SparseRowWiseAdaGrad(initial_accum=0.3),
                              P.SparseRowWiseAdaGrad(initial_accum=0.3)),
                  "lazy_adam": (J.SparseLazyAdam(), P.SparseLazyAdam()),
                  "ftrl": (J.SparseFTRL(initial_accum=0.2),
                           P.SparseFTRL(initial_accum=0.2))}[opt]
    data = np.random.default_rng(3).standard_normal((40, 4)).astype(
        np.float32)
    jstate = jopt.init(jnp.asarray(data))
    if opt == "lazy_adam":
        jstate = jstate._replace(m=jstate.m + 1.0, v=jstate.v + 2.0,
                                 count=jnp.int32(5))
    pstate = type(popt.init(torch.from_numpy(data)))(
        *[torch.from_numpy(np.array(a)) for a in jstate])
    want = JR.reset_rows_state(jstate, ROWS)
    got = PR.reset_rows_state(pstate, ROWS)
    assert got is pstate
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _arrays(layers):
    return [tuple(np.asarray(a) for a in layer) for layer in layers]


VOCABS = (13, 29, 7)
B = 16


def _loop_pair(family, opt):
    jopt, popt = {"sgd": (J.SparseSGD(0.1), P.SparseSGD(0.1)),
                  "adagrad": (J.SparseRowWiseAdaGrad(0.1, method="indexer"),
                              P.SparseRowWiseAdaGrad(0.1, method="indexer"))
                  }[opt]
    common = dict(vocab_sizes=VOCABS, num_dense=3, dim=8)
    key = jax.random.key(2)
    if family == "dlrm":
        kw = dict(common, bottom_mlp=(16, 8), top_mlp=(16, 1))
        jcfg = JM.DLRMConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DLRMConfig(**kw, compute_dtype=torch.float32)
        jm = JM.init_dlrm(key, jcfg, sparse_opt=jopt)
        pm = ett.dlrm_from_arrays(pcfg, _arrays(jm.bottom), _arrays(jm.top),
                                  np.asarray(jm.tables.data),
                                  jm.tables.offsets, device="cpu",
                                  emb_state=jm.emb_state)
    elif family == "dcn":
        kw = dict(common, deep_mlp=(16, 8), num_cross=1)
        jcfg = JD.DCNConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DCNConfig(**kw, compute_dtype=torch.float32)
        jm = JD.init_dcn(key, jcfg, sparse_opt=jopt)
        pm = ett.dcn_from_arrays(pcfg, _arrays(jm.cross), _arrays(jm.deep),
                                 _arrays([jm.head])[0],
                                 np.asarray(jm.tables.data),
                                 jm.tables.offsets, device="cpu",
                                 emb_state=jm.emb_state)
    else:
        kw = dict(common, deep_mlp=(16, 8), fold_fm_w=False)
        jcfg = JF.DeepFMConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DeepFMConfig(**kw, compute_dtype=torch.float32)
        jm = JF.init_deepfm(key, jcfg, sparse_opt=jopt)
        jm.fm_w.data = jnp.asarray(np.random.default_rng(5).normal(
            0, 0.1, jm.fm_w.data.shape).astype(np.float32))
        pm = ett.deepfm_from_arrays(
            pcfg, _arrays(jm.deep), _arrays([jm.head])[0],
            np.asarray(jm.dense_w), np.asarray(jm.bias),
            np.asarray(jm.tables.data), jm.tables.offsets,
            fm_w_data=np.asarray(jm.fm_w.data), device="cpu",
            emb_state=jm.emb_state, fm_state=jm.fm_state)
    return (jcfg, jopt, jm), (pcfg, popt, pm)


@pytest.mark.parametrize("family,opt", [("dlrm", "sgd"), ("dlrm", "adagrad"),
                                        ("dcn", "sgd"), ("deepfm", "adagrad")])
def test_evicting_loop_matches_jax(family, opt):
    (jcfg, jopt, jm), (pcfg, popt, pm) = _loop_pair(family, opt)
    data = dict(vocab_sizes=VOCABS, num_dense=3, batch_size=B, seed=6)
    kw = dict(evict_every=2, evict_threshold=0.3, freq_decay=0.5,
              dense_lr=0.05, log_every=1, verbose=False)
    jres = getattr(jax_train, f"train_{family}")(
        jcfg, SyntheticCriteo(**data).batches(), 4, sparse_opt=jopt,
        model=jm, **kw)
    pres = getattr(ett, f"train_{family}")(
        pcfg, SyntheticCriteo(**data).batches(), 4, sparse_opt=popt,
        model=pm, **kw)
    assert pres.evicted_rows == jres.evicted_rows > 0
    np.testing.assert_allclose(pres.losses, jres.losses, **TOL)
    stacks = [("tables", "emb_state")]
    if family == "deepfm":
        stacks.append(("fm_w", "fm_state"))
    for tables, state in stacks:
        got = getattr(pres.model, tables).data.numpy()
        np.testing.assert_allclose(got, np.asarray(
            getattr(jres.model, tables).data), **TOL)
        for g, w in zip(getattr(pres.model, state),
                        getattr(jres.model, state)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # Rows the last eviction took and no later step touched stay zero.
    zero = (np.asarray(jres.model.tables.data) == 0).all(1)
    assert zero.any() and (pres.model.tables.data.numpy()[zero] == 0).all()
    if opt == "adagrad":
        assert (pres.model.emb_state.accum.numpy()[zero] == 0).all()
