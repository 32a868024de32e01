"""The port's DeepFM against the JAX package's, on the CPU.

A JAX `init_deepfm` model is carried into the port with `deepfm_from_arrays`
(weights and optimizer states), and both packages run the same numpy
inputs: the forward folded and unfolded with the `use_fm`/`use_deep`
ablations, three train steps with SGD, indexer AdaGrad and lazy Adam in both
layouts, the layout conversions for all four optimizer states,
`train_deepfm` and `make_deepfm_service`.

Tolerances: f32 towers agree up to the order of f32 sums: rtol/atol 1e-5 on
one forward, one step or one conversion, 1e-4 after three steps or four
loop steps. bf16 towers: the logits to 2^-7 of the largest logit.
"""
import dataclasses

import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu import optim as J
from embeddingtables_tpu.models import deepfm as JF
from embeddingtables_tpu.models.train import train_deepfm as jax_train_deepfm
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.data import SyntheticCriteo
from embeddingtables_tpu_torch.models import deepfm as PF
from _torch_threads import _one_torch_thread  # noqa: F401

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The towers' Adam, as the loops take it (`dense_tx`).
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
SMALL = dict(vocab_sizes=(13, 29, 7, 21), num_dense=5, dim=8,
             deep_mlp=(16, 8))
B = 16
TOL1 = dict(rtol=1e-5, atol=1e-5)
TOL3 = dict(rtol=1e-4, atol=1e-4)


def _opts(name):
    return {"sgd": (J.SparseSGD(0.1), P.SparseSGD(0.1)),
            "adagrad_indexer": (J.SparseRowWiseAdaGrad(0.1, method="indexer"),
                                P.SparseRowWiseAdaGrad(0.1, method="indexer")),
            "lazy_adam": (J.SparseLazyAdam(0.05), P.SparseLazyAdam(0.05)),
            "ftrl": (J.SparseFTRL(0.1, l1=0.01), P.SparseFTRL(0.1, l1=0.01)),
            }[name]


def _arrays(layers):
    return [tuple(np.asarray(a) for a in layer) for layer in layers]


def _carry(jm, pcfg):
    """The JAX model's weights and optimizer states as a port model."""
    return ett.deepfm_from_arrays(
        pcfg, _arrays(jm.deep), _arrays([jm.head])[0], np.asarray(jm.dense_w),
        np.asarray(jm.bias), np.asarray(jm.tables.data), jm.tables.offsets,
        fm_w_data=None if jm.fm_w is None else np.asarray(jm.fm_w.data),
        device="cpu", emb_state=jm.emb_state, fm_state=jm.fm_state)


def _pair(opt_name="sgd", compute="float32", **kw):
    jopt, popt = _opts(opt_name)
    cfg_kw = {**SMALL, **kw}
    jcfg = JF.DeepFMConfig(**cfg_kw, compute_dtype=JAX_DT[compute])
    pcfg = ett.DeepFMConfig(**cfg_kw, compute_dtype=TORCH_DT[compute])
    jm = JF.init_deepfm(jax.random.key(0), jcfg, sparse_opt=jopt)
    # Non-zero first-order and dense weights, so every term of the logit
    # carries a value (JAX starts them at zero).
    rng = np.random.default_rng(11)
    if jm.fm_w is not None:
        jm.fm_w.data = jnp.asarray(
            rng.normal(0, 0.1, jm.fm_w.data.shape).astype(np.float32))
    elif jcfg.folded:
        col = rng.normal(0, 0.1, (jm.tables.data.shape[0], 1))
        jm.tables.data = jm.tables.data.at[:, :1].set(col.astype(np.float32))
    jm.dense_w = jnp.asarray(rng.normal(0, 0.1, jcfg.num_dense)
                             .astype(np.float32))
    jm.bias = jnp.float32(-0.3)
    return (jcfg, jopt, jm), (pcfg, popt, _carry(jm, pcfg))


def _batch(rng, cfg, pad_idx=None):
    dense = rng.standard_normal((B, cfg.num_dense)).astype(np.float32)
    shape = (B,) if cfg.bag is None else (B, cfg.bag)
    cat = np.stack([rng.integers(0, v, shape) for v in cfg.vocab_sizes])
    cat = cat.astype(np.int32)
    if pad_idx is not None:
        cat[rng.random(cat.shape) < 0.3] = pad_idx
    label = rng.integers(0, 2, B).astype(np.float32)
    return dense, cat, label


@pytest.fixture(scope="module")
def jax_programs():
    """One jitted JAX program per (kind, configuration, optimizer), shared
    by the cases of this module."""
    cache = {}

    def get(kind, jcfg, opt_name=None, jopt=None):
        key = (kind, jcfg, opt_name)
        if key not in cache:
            cache[key] = (JF.make_eval_step(jcfg) if kind == "eval" else
                          JF.make_train_step(jcfg, sparse_opt=jopt,
                                             dense_lr=0.05))
        return cache[key]
    return get


def _params(jm):
    return jax.tree_util.tree_leaves((jm.deep, jm.head, jm.dense_w, jm.bias))


def _assert_models_close(pm, jm, tol):
    np.testing.assert_allclose(pm.tables.data.numpy(),
                               np.asarray(jm.tables.data), **tol)
    stacks = [(pm.emb_state, jm.emb_state)]
    assert (pm.fm_w is None) == (jm.fm_w is None)
    if jm.fm_w is not None:
        np.testing.assert_allclose(pm.fm_w.data.numpy(),
                                   np.asarray(jm.fm_w.data), **tol)
        stacks.append((pm.fm_state, jm.fm_state))
    for ps, js in stacks:
        assert type(ps).__name__ == type(js).__name__
        for p, j in zip(ps, js):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), **tol)
    pparams = [*pm.deep_params, *pm.head_params, pm.dense_w, pm.bias]
    assert len(pparams) == len(_params(jm)) == len(list(pm.parameters()))
    for p, j in zip(pparams, _params(jm)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

FORWARD = {
    "folded": dict(fold_fm_w=True),
    "unfolded": dict(fold_fm_w=False),
    "folded_fm_only": dict(fold_fm_w=True, use_deep=False),
    "unfolded_fm_only": dict(fold_fm_w=False, use_deep=False),
    "deep_only": dict(use_fm=False),
    "folded_bag3_mean_pad": dict(bag=3, combiner="mean", pad_idx=-1),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_matches_jax_f32(case, jax_programs):
    kw = FORWARD[case]
    (jcfg, _, jm), (pcfg, _, pm) = _pair(**kw)
    assert pm.tables.data.shape[1] == pcfg.stack_dim
    dense, cat, _ = _batch(np.random.default_rng(1), pcfg, kw.get("pad_idx"))
    want = np.asarray(jax_programs("eval", jcfg)(jm, jnp.asarray(dense),
                                                 jnp.asarray(cat)))
    got = PF.make_eval_step(pcfg)(pm, dense, cat)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, **TOL1)


def test_forward_bf16_towers_keep_the_fm_terms_in_f32(jax_programs):
    (jcfg, _, jm), (pcfg, _, pm) = _pair(compute="bfloat16")
    dense, cat, _ = _batch(np.random.default_rng(2), pcfg)
    want = np.asarray(jax_programs("eval", jcfg)(jm, jnp.asarray(dense),
                                                 jnp.asarray(cat)))
    got = PF.make_eval_step(pcfg)(pm, dense, cat).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    # The FM part alone is f32 under bf16 towers: the deep-off model's
    # logits match an f32 computation to f32 precision.
    emb_t, w_t = PF.lookup_acts(pm.tables, pcfg, torch.from_numpy(cat))
    fm = PF.forward_from_embeddings(
        pm.dense_params, dataclasses.replace(pcfg, use_deep=False),
        torch.from_numpy(dense), emb_t, w_t)
    e = emb_t.double()
    pairs = sum((e[i] * e[j]).sum(-1) for i in range(4) for j in range(i))
    ref = (float(pm.bias.detach()) + w_t[..., 0].double().sum(0)
           + torch.from_numpy(dense).double() @ pm.dense_w.double() + pairs)
    np.testing.assert_allclose(fm.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------

STEPS = {
    "folded_sgd": ("sgd", dict(fold_fm_w=True)),
    "folded_adagrad_indexer": ("adagrad_indexer", dict(fold_fm_w=True)),
    "folded_lazy_adam": ("lazy_adam", dict(fold_fm_w=True)),
    "unfolded_sgd": ("sgd", dict(fold_fm_w=False)),
    "unfolded_adagrad_indexer": ("adagrad_indexer", dict(fold_fm_w=False)),
    "fm_only_sgd": ("sgd", dict(use_deep=False)),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_three_train_steps_match_jax(case, jax_programs):
    opt_name, kw = STEPS[case]
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name, **kw)
    jstep = jax_programs("train", jcfg, opt_name, jopt)
    pstep = PF.make_train_step(pcfg, sparse_opt=popt, dense_lr=0.05)
    rng = np.random.default_rng(3)
    for i in range(3):
        dense, cat, label = _batch(rng, pcfg)
        jm, jloss = jstep(jm, jnp.asarray(dense), jnp.asarray(cat),
                          jnp.asarray(label))
        ploss = pstep(pm, dense, cat, label)
        assert abs(float(ploss) - float(jloss)) <= 1e-4
        if i in (0, 2):
            _assert_models_close(pm, jm, TOL1 if i == 0 else TOL3)


def test_train_step_refuses_what_is_not_ported():
    # A batch that microbatch=k does not divide: JAX's ValueError, raised
    # before the step changes the model.
    cfg = ett.DeepFMConfig(**SMALL)
    batch = _batch(np.random.default_rng(0), cfg)
    jm = JF.init_deepfm(jax.random.key(0), JF.DeepFMConfig(**SMALL))
    want = f"batch {B} not divisible by microbatch 3"
    with pytest.raises(ValueError, match=want):
        JF.make_train_step(JF.DeepFMConfig(**SMALL), microbatch=3)(
            jm, *(jnp.asarray(x) for x in batch))
    model = ett.init_deepfm(cfg, device="cpu")
    before = model.tables.data.clone()
    with pytest.raises(ValueError, match=want):
        PF.make_train_step(cfg, microbatch=3)(model, *batch)
    assert torch.equal(model.tables.data, before)


# ---------------------------------------------------------------------------
# Layout conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name",
                         ["sgd", "adagrad_indexer", "lazy_adam", "ftrl"])
def test_fuse_and_unfuse_match_jax(opt_name, jax_programs):
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name, fold_fm_w=False)
    # One step first, so every state carries values.
    rng = np.random.default_rng(4)
    dense, cat, label = _batch(rng, pcfg)
    jm, _ = jax_programs("train", jcfg, opt_name, jopt)(
        jm, jnp.asarray(dense), jnp.asarray(cat), jnp.asarray(label))
    PF.make_train_step(pcfg, sparse_opt=popt, dense_lr=0.05)(pm, dense, cat,
                                                             label)
    want = JF._fuse_states(jm.emb_state, jm.fm_state, jcfg.dim)
    got = PF._fuse_states(pm.emb_state, pm.fm_state, pcfg.dim)
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL1)
    jf, pf = JF.fuse_deepfm(jm), PF.fuse_deepfm(pm)
    assert pf.config.folded and pf.fm_w is None and pf.fm_state is None
    _assert_models_close(pf, jf, TOL1)
    ju, pu = JF.unfuse_deepfm(jf), PF.unfuse_deepfm(pf)
    assert not pu.config.folded
    _assert_models_close(pu, ju, TOL1)
    # The converted models score like the original.
    dense, cat, _ = _batch(rng, pcfg)
    ref = PF.make_eval_step(pcfg)(pm, dense, cat)
    for m in (pf, pu):
        torch.testing.assert_close(PF.make_eval_step(m.config)(m, dense, cat),
                                   ref, **TOL1)
    # Each stack owns its state: training the unfused model leaves the
    # fused one as it was.
    before = [t.clone() for t in pf.emb_state]
    PF.make_train_step(pu.config, sparse_opt=popt)(pu, *_batch(rng, pcfg))
    assert all(torch.equal(a, b) for a, b in zip(before, pf.emb_state))
    if opt_name == "adagrad_indexer":
        assert pu.emb_state.accum.data_ptr() != pu.fm_state.accum.data_ptr()


def test_fuse_refuses_a_model_without_fm():
    _, (_, _, pm) = _pair(use_fm=False)
    with pytest.raises(ValueError, match="use_fm=False"):
        PF.fuse_deepfm(pm)
    assert PF.unfuse_deepfm(pm) is pm


# ---------------------------------------------------------------------------
# The loop and the service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name,fold", [("sgd", True),
                                           ("adagrad_indexer", False)])
def test_train_deepfm_losses_match_jax(opt_name, fold):
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name, fold_fm_w=fold)
    data = dict(vocab_sizes=SMALL["vocab_sizes"], num_dense=5, batch_size=B,
                seed=3)
    evals = list(SyntheticCriteo(**data, stream_seed=99).batches(2))
    jres = jax_train_deepfm(jcfg, SyntheticCriteo(**data).batches(), 4,
                            sparse_opt=jopt, dense_lr=0.05, model=jm,
                            log_every=1, verbose=False)
    pres = ett.train_deepfm(pcfg, SyntheticCriteo(**data).batches(), 4,
                            sparse_opt=popt, dense_lr=0.05, model=pm,
                            log_every=1, verbose=False, eval_batches=evals,
                            eval_every=4, eval_metrics=True)
    assert pres.model is pm and len(pres.losses) == 4
    np.testing.assert_allclose(pres.losses, jres.losses, **TOL3)
    assert [s for s, _ in pres.aucs] == [4]


def test_deepfm_service_gives_the_eval_steps_results():
    _, (pcfg, _, pm) = _pair(fold_fm_w=False)
    svc = ett.make_deepfm_service(pm, max_batch=16, max_latency_ms=1.0)
    try:
        dense, cat, _ = _batch(np.random.default_rng(5), pcfg)
        reqs = [(dense[:b], cat[:, :b]) for b in (1, 5, 16)]
        futs = [svc.submit(d, c) for d, c in reqs]
        for (d, c), fut in zip(reqs, futs):
            want = PF.make_eval_step(pcfg)(pm, d, c).numpy()
            np.testing.assert_allclose(fut.result(timeout=30), want,
                                       rtol=1e-6, atol=1e-6)
    finally:
        svc.stop()
    # A single-device model on a mesh waits for the planner; quantized on
    # a mesh raises JAX's own error.
    for kw in (dict(mesh=True), dict(quantized=True, mesh=True)):
        with pytest.raises(NotImplementedError):
            ett.make_deepfm_service(pm, **kw)


@pytest.mark.parametrize("name", ["mesh", "plan", "evict_every",
                                  "delta_ckpt", "ckpt_manager", "guard",
                                  "device_prefetch", "microbatch",
                                  "dense_tx"])
def test_train_deepfm_options_not_ported_raise(name):
    # Every option is ported, beside a mesh and a plan too (items I-2c,
    # I-3a): each comes with a (here fake) mesh and a plan and the loop
    # reaches the plan, but delta checkpoints under a plan raise JAX's
    # NotImplementedError before anything touches the mesh.
    value = {"evict_every": 10, "device_prefetch": 2, "microbatch": 2,
             "dense_tx": ADAM}.get(name, object())
    kw = {"mesh": object(), "plan": object(), name: value}
    if name == "delta_ckpt":
        kw["delta_every"] = 2
    cfg = ett.DeepFMConfig(**SMALL)
    if name == "delta_ckpt":
        with pytest.raises(NotImplementedError, match="delta checkpointing"):
            ett.train_deepfm(cfg, iter(()), 1, device="cpu", **kw)
    else:
        with pytest.raises(AttributeError):      # reaches the fake plan
            ett.train_deepfm(cfg, iter(()), 1, device="cpu", **kw)
    kw.pop("plan")
    with pytest.raises(AttributeError):          # reaches the fake mesh
        ett.train_deepfm(cfg, iter(()), 1, device="cpu", **kw)


@pytest.mark.parametrize("fold", [True, False])
def test_init_deepfm_layouts(fold):
    cfg = ett.DeepFMConfig(**SMALL, fold_fm_w=fold)
    m = ett.init_deepfm(cfg, torch.Generator().manual_seed(0), device="cpu",
                        sparse_opt=P.SparseRowWiseAdaGrad(initial_accum=0.5))
    assert m.tables.data.shape == (70, 9 if fold else 8)
    if fold:
        assert m.fm_w is None and m.fm_state is None
        assert not m.tables.data[:, 0].any()
    else:
        assert m.fm_w.data.shape == (70, 1) and not m.fm_w.data.any()
        assert torch.equal(m.fm_state.accum, torch.full((70,), 0.5))
        assert {"fm_accum", "emb_accum"} <= dict(m.named_buffers()).keys()
    assert not m.dense_w.any() and float(m.bias.detach()) == 0.0
    plain = ett.init_deepfm(dataclasses.replace(cfg, use_deep=False),
                            device="cpu")
    assert plain.deep == [] and tuple(plain.head[0].shape) == (1, 1)
