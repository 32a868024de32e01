"""The towers' optimizer (`dense_tx`) against the JAX package's optax towers,
on the CPU.

  - `torch.optim.Adam` at lr 1e-2 against `optax.adam(1e-2)` over three
    train steps of DLRM, DCN-v2 and the folded DeepFM from one state (the
    optax state carried by `*_from_arrays(dense_opt_state=)`): towers,
    moments and `step` against optax's `count`.
  - A state carried from JAX after two steps, then one more step each.
  - The tower state is part of the model's `state_dict()`: a checkpoint, a
    guard rollback and a resume restore it bitwise; a layout conversion
    keeps it.
  - `train_dlrm(dense_tx=)` losses against JAX's loop.
  - A model without tower state refuses `dense_tx` with `ValueError` (JAX
    fails inside optax), before the step changes it.

Tolerance: rtol 1e-5 (atol 1e-6) with f32 towers. Both optimizers have the
same defaults (b1 0.9, b2 0.999, eps 1e-8); they associate the bias
corrections differently.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embeddingtables_tpu.models import dcn as JD
from embeddingtables_tpu.models import deepfm as JF
from embeddingtables_tpu.models import dlrm as JM
from embeddingtables_tpu.models.train import train_dlrm as jax_train_dlrm
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import utils
from embeddingtables_tpu_torch.models import dcn as PD
from embeddingtables_tpu_torch.models import deepfm as PF
from embeddingtables_tpu_torch.models import dlrm as PM
from _torch_persist import B, VOCABS, adam_arrays, adam_txs, batches, pair
from _torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
MODULES = {"dlrm": (JM, PM), "dcn": (JD, PD), "deepfm_folded": (JF, PF)}
_STEPS = {}


def _steps(family, jcfg, jopt, pcfg, popt):
    """The JAX and port Adam-tower steps of `family` (JAX's jitted program
    shared across the tests)."""
    jmod, pmod = MODULES[family]
    jtx, ptx = adam_txs()
    if family not in _STEPS:
        _STEPS[family] = jmod.make_train_step(jcfg, sparse_opt=jopt,
                                              dense_lr=0.05, dense_tx=jtx)
    return _STEPS[family], pmod.make_train_step(pcfg, sparse_opt=popt,
                                                dense_lr=0.05, dense_tx=ptx)


def _batch(rng):
    dense = rng.standard_normal((B, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, B) for v in VOCABS]).astype(np.int32)
    return dense, cat, rng.integers(0, 2, B).astype(np.float32)


def _assert_adam_matches(pm, jm):
    st = jm.dense_opt_state[0]
    mu, nu = jax_leaves(st.mu), jax_leaves(st.nu)
    named = pm.tower_params()
    assert len(named) == len(mu)
    ps = pm.dense_opt_state
    for (name, p), m, v, w in zip(named, mu, nu,
                                  jax_leaves(_jax_towers(jm))):
        s = ps.state_of(name)
        assert float(s["step"]) == float(st.count)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(s["exp_avg"].numpy(), np.asarray(m),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(), np.asarray(v),
                                   err_msg=name, **TOL)


def jax_leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in jax_leaves(sub)]
    return [tree]


def _jax_towers(jm):
    if hasattr(jm, "bottom"):
        return (jm.bottom, jm.top)
    if hasattr(jm, "cross"):
        return (jm.cross, jm.deep, jm.head)
    return (jm.deep, jm.head, jm.dense_w, jm.bias)


@pytest.mark.parametrize("family", ["dlrm", "dcn", "deepfm_folded"])
def test_adam_towers_match_optax_over_three_steps(family):
    (jcfg, jopt, jm), (pcfg, popt, pm) = pair(family, "adagrad", adam=True)
    jstep, pstep = _steps(family, jcfg, jopt, pcfg, popt)
    rng = np.random.default_rng(1)
    for _ in range(3):
        dense, cat, label = _batch(rng)
        jm, jloss = jstep(jm, jnp.asarray(dense), jnp.asarray(cat),
                          jnp.asarray(label))
        ploss = pstep(pm, dense, cat, label)
        np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    assert int(jm.dense_opt_state[0].count) == 3
    _assert_adam_matches(pm, jm)
    np.testing.assert_allclose(pm.tables.data.numpy(),
                               np.asarray(jm.tables.data), **TOL)


def test_adam_state_carried_from_jax_continues_as_jax_does():
    (jcfg, jopt, jm), (pcfg, popt, _) = pair("dlrm", "adagrad", adam=True)
    jstep, pstep = _steps("dlrm", jcfg, jopt, pcfg, popt)
    rng = np.random.default_rng(2)
    for _ in range(2):
        jm, _ = jstep(jm, *(jnp.asarray(x) for x in _batch(rng)))
    pm = ett.dlrm_from_arrays(
        pcfg, [tuple(np.asarray(a) for a in layer) for layer in jm.bottom],
        [tuple(np.asarray(a) for a in layer) for layer in jm.top],
        np.asarray(jm.tables.data), jm.tables.offsets, device="cpu",
        emb_state=jm.emb_state,
        dense_opt_state=adam_arrays(jm.dense_opt_state))
    assert float(pm.dense_opt_state.bottom_params_0__step) == 2.0
    batch = _batch(rng)
    jm, jloss = jstep(jm, *(jnp.asarray(x) for x in batch))
    np.testing.assert_allclose(float(pstep(pm, *batch)), float(jloss), **TOL)
    _assert_adam_matches(pm, jm)


def _adam_model(seed=0):
    cfg = ett.DLRMConfig(vocab_sizes=VOCABS, num_dense=3, dim=8,
                         bottom_mlp=(16, 8), top_mlp=(16, 1),
                         compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    return cfg, ett.init_dlrm(cfg, g, device="cpu", dense_tx=adam_txs()[1])


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_checkpoint_guard_and_resume_restore_the_adam_state(tmp_path):
    cfg, model = _adam_model()
    names = [k for k in model.state_dict() if k.startswith("dense_opt_state")]
    assert len(names) == 3 * len(model.tower_params())
    step = PM.make_train_step(cfg, dense_tx=adam_txs()[1])
    data = batches("dlrm")
    for _ in range(2):
        b = next(data)
        step(model, b["dense"], b["cat"], b["label"])
    mgr = utils.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, model)
    saved = copy.deepcopy(model)
    b = next(data)
    step(model, b["dense"], b["cat"], b["label"])
    assert not _same(model, saved)
    # A guard rollback copies the checkpoint into the model in place: the
    # towers and the Adam state (step and both moments) come back bitwise.
    guard = utils.DivergenceGuard(ckpt=mgr)
    ptr = model.dense_opt_state.bottom_params_0__exp_avg.data_ptr()
    model, rolled = guard.observe(float("nan"), model)
    assert rolled and _same(model, saved)
    assert model.dense_opt_state.bottom_params_0__exp_avg.data_ptr() == ptr
    # The optimizer steps the restored buffers: equal to the saved copy's.
    step(model, b["dense"], b["cat"], b["label"])
    step(saved, b["dense"], b["cat"], b["label"])
    assert _same(model, saved)
    # A resume into a fresh model built with the same factory.
    resumed, at = utils.resume_or_init(mgr, lambda: _adam_model(seed=7)[1])
    assert at == 2
    step(resumed, b["dense"], b["cat"], b["label"])
    restored = _adam_model(seed=8)[1]
    mgr.restore(2, restored)
    step(restored, b["dense"], b["cat"], b["label"])
    assert _same(resumed, restored)


def test_layout_conversion_keeps_the_tower_state():
    cfg = ett.DeepFMConfig(vocab_sizes=VOCABS, num_dense=3, dim=8,
                           deep_mlp=(16, 8), fold_fm_w=False)
    model = ett.init_deepfm(cfg, device="cpu", dense_tx=adam_txs()[1])
    b = next(batches("deepfm"))
    PF.make_train_step(cfg, dense_tx=adam_txs()[1])(model, b["dense"],
                                                    b["cat"], b["label"])
    folded = ett.fuse_deepfm(model)
    for k, v in model.dense_opt_state.state_dict().items():
        got = folded.dense_opt_state.state_dict()[k]
        assert torch.equal(got, v) and got.data_ptr() != v.data_ptr()


def test_train_dlrm_with_adam_towers_matches_jax():
    (jcfg, jopt, jm), (pcfg, popt, pm) = pair("dlrm", "sgd", adam=True)
    jtx, ptx = adam_txs()
    jres = jax_train_dlrm(jcfg, batches("dlrm"), 4, sparse_opt=jopt,
                          dense_tx=jtx, model=jm, log_every=1, verbose=False)
    pres = ett.train_dlrm(pcfg, batches("dlrm"), 4, sparse_opt=popt,
                          dense_tx=ptx, model=pm, log_every=1, verbose=False,
                          device="cpu")
    np.testing.assert_allclose(pres.losses, jres.losses, **TOL)
    _assert_adam_matches(pres.model, jres.model)


def test_dense_tx_without_tower_state_raises_before_the_step():
    # Queue-3 divergence: JAX's loop fails inside optax on a model without
    # a dense_opt_state; the port names init_*(dense_tx=) instead.
    cfg = ett.DLRMConfig(vocab_sizes=VOCABS, num_dense=3, dim=8,
                         bottom_mlp=(16, 8), top_mlp=(16, 1))
    model = ett.init_dlrm(cfg, device="cpu")
    before = copy.deepcopy(model)
    b = next(batches("dlrm"))
    with pytest.raises(ValueError, match=r"init_dlrm\(dense_tx="):
        PM.make_train_step(cfg, dense_tx=adam_txs()[1])(
            model, b["dense"], b["cat"], b["label"])
    assert _same(model, before)
    with pytest.raises(ValueError, match=r"init_dlrm\(dense_tx="):
        ett.train_dlrm(cfg, batches("dlrm"), 1, model=model, device="cpu",
                       dense_tx=adam_txs()[1], verbose=False)
    # An optimizer whose state appears only at its first step is refused
    # when the model is built.
    with pytest.raises(ValueError, match="first step"):
        ett.init_dlrm(cfg, device="cpu", dense_tx=functools.partial(
            torch.optim.SGD, lr=0.1, momentum=0.9))
