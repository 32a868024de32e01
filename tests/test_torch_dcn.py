"""The port's DCN-v2 against the JAX package's, on the CPU.

A JAX `init_dcn` model is carried into the port with `dcn_from_arrays`
(weights and optimizer state, not seeds), and both packages run the same
numpy inputs: the forward in both structures at rank 64 and full rank, three
train steps with SGD, indexer AdaGrad and lazy Adam (and a bag-4 mean case
with padding), `train_dcn` and `make_dcn_service`.

Tolerances: f32 towers agree up to the order of f32 sums: rtol/atol 1e-5 on
one forward or one step, 1e-4 after three steps or four loop steps. bf16
towers: the logits to 2^-7 of the largest logit (a couple of bf16
roundings), as in `test_torch_dlrm.py`.
"""
import dataclasses

import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu import optim as J
from embeddingtables_tpu.models import dcn as JD
from embeddingtables_tpu.models.train import train_dcn as jax_train_dcn
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.data import SyntheticCriteo
from embeddingtables_tpu_torch.models import dcn as PD
from _torch_threads import _one_torch_thread  # noqa: F401

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The towers' Adam, as the loops take it (`dense_tx`).
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
SMALL = dict(vocab_sizes=(13, 29, 7, 21), num_dense=5, dim=8,
             deep_mlp=(16, 8), num_cross=2)
B = 16


def _opts(name):
    return {"sgd": (J.SparseSGD(0.1), P.SparseSGD(0.1)),
            "adagrad_indexer": (J.SparseRowWiseAdaGrad(0.1, method="indexer"),
                                P.SparseRowWiseAdaGrad(0.1, method="indexer")),
            "lazy_adam": (J.SparseLazyAdam(0.05), P.SparseLazyAdam(0.05))
            }[name]


def _arrays(layers):
    return [tuple(np.asarray(a) for a in layer) for layer in layers]


def _carry(jm, pcfg):
    """The JAX model's weights and optimizer state as a port model."""
    return ett.dcn_from_arrays(
        pcfg, _arrays(jm.cross), _arrays(jm.deep), _arrays([jm.head])[0],
        np.asarray(jm.tables.data), jm.tables.offsets, device="cpu",
        emb_state=jm.emb_state)


def _pair(opt_name="sgd", compute="float32", **kw):
    jopt, popt = _opts(opt_name)
    cfg_kw = {**SMALL, **kw}
    jcfg = JD.DCNConfig(**cfg_kw, compute_dtype=JAX_DT[compute])
    pcfg = ett.DCNConfig(**cfg_kw, compute_dtype=TORCH_DT[compute])
    jm = JD.init_dcn(jax.random.key(0), jcfg, sparse_opt=jopt)
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
            cache[key] = (JD.make_eval_step(jcfg) if kind == "eval" else
                          JD.make_train_step(jcfg, sparse_opt=jopt,
                                             dense_lr=0.05))
        return cache[key]
    return get


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [64, None], ids=["rank64", "full_rank"])
@pytest.mark.parametrize("structure", ["stacked", "parallel"])
def test_forward_matches_jax_f32(structure, rank, jax_programs):
    (jcfg, _, jm), (pcfg, _, pm) = _pair(structure=structure,
                                         cross_rank=rank)
    assert len(pm.cross[0]) == (2 if rank is None else 3)
    dense, cat, _ = _batch(np.random.default_rng(1), pcfg)
    want = np.asarray(jax_programs("eval", jcfg)(jm, jnp.asarray(dense),
                                                 jnp.asarray(cat)))
    got = ett.dcn_forward(pm, dense, cat)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    out = PD.make_eval_step(pcfg)(pm, dense, cat)
    assert not out.requires_grad and torch.equal(out, got.detach())


def test_forward_bf16_towers_within_stated_tolerance(jax_programs):
    (jcfg, _, jm), (pcfg, _, pm) = _pair(compute="bfloat16")
    dense, cat, _ = _batch(np.random.default_rng(2), pcfg)
    want = np.asarray(jax_programs("eval", jcfg)(jm, jnp.asarray(dense),
                                                 jnp.asarray(cat)))
    got = ett.dcn_forward(pm, dense, cat).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_x0_puts_the_embeddings_before_the_dense_features():
    # One cross layer with W = 0 and b = 1 gives x1 = 2 * x0; the head reads
    # only the first feature of the parallel structure's [x_cross, deep]:
    # table 0's first column, not a dense feature.
    cfg = ett.DCNConfig(vocab_sizes=(3, 4), num_dense=2, dim=2,
                        num_cross=1, cross_rank=None, deep_mlp=(2,),
                        structure="parallel", compute_dtype=torch.float32)
    m = ett.init_dcn(cfg, device="cpu")
    with torch.no_grad():
        w, b = m.cross[0]
        w.zero_()
        b.fill_(1.0)
        hw, hb = m.head
        hw.zero_()
        hw[0, 0] = 1.0
    dense = np.full((1, 2), 100.0, np.float32)
    cat = np.array([[1], [2]], np.int32)
    want = 2.0 * float(m.tables.data[1, 0])
    assert abs(float(PD.make_eval_step(cfg)(m, dense, cat)[0]) - want) < 1e-6


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------

STEPS = {
    "stacked_sgd": ("sgd", {}),
    "stacked_adagrad_indexer": ("adagrad_indexer", {}),
    "parallel_lazy_adam": ("lazy_adam", dict(structure="parallel")),
    "bag4_mean_pad_sgd": ("sgd", dict(bag=4, combiner="mean", pad_idx=-1)),
}


def _assert_models_close(pm, jm, tol):
    np.testing.assert_allclose(pm.tables.data.numpy(),
                               np.asarray(jm.tables.data), **tol)
    assert type(pm.emb_state).__name__ == type(jm.emb_state).__name__
    for p, j in zip(pm.emb_state, jm.emb_state):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **tol)
    jparams = jax.tree_util.tree_leaves((jm.cross, jm.deep, jm.head))
    pparams = list(pm.parameters())
    assert len(jparams) == len(pparams)
    for p, j in zip(pparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_three_train_steps_match_jax(case, jax_programs):
    opt_name, kw = STEPS[case]
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name, **kw)
    jstep = jax_programs("train", jcfg, opt_name, jopt)
    pstep = ett.models.dcn.make_train_step(pcfg, sparse_opt=popt,
                                           dense_lr=0.05)
    rng = np.random.default_rng(3)
    for i in range(3):
        dense, cat, label = _batch(rng, pcfg, kw.get("pad_idx"))
        jm, jloss = jstep(jm, jnp.asarray(dense), jnp.asarray(cat),
                          jnp.asarray(label))
        ploss = pstep(pm, dense, cat, label)
        tol = dict(rtol=1e-5, atol=1e-5) if i == 0 else \
            dict(rtol=1e-4, atol=1e-4)
        assert abs(float(ploss) - float(jloss)) <= 1e-4
        if i in (0, 2):
            _assert_models_close(pm, jm, tol)


def test_train_step_refuses_what_is_not_ported():
    # A batch that microbatch=k does not divide: JAX's ValueError, raised
    # before the step changes the model.
    cfg = ett.DCNConfig(**SMALL)
    batch = _batch(np.random.default_rng(0), cfg)
    jm = JD.init_dcn(jax.random.key(0), JD.DCNConfig(**SMALL))
    want = f"batch {B} not divisible by microbatch 3"
    with pytest.raises(ValueError, match=want):
        JD.make_train_step(JD.DCNConfig(**SMALL), microbatch=3)(
            jm, *(jnp.asarray(x) for x in batch))
    model = ett.init_dcn(cfg, device="cpu")
    before = model.tables.data.clone()
    with pytest.raises(ValueError, match=want):
        PD.make_train_step(cfg, microbatch=3)(model, *batch)
    assert torch.equal(model.tables.data, before)
    step = PD.make_train_step(
        cfg, sparse_opt=P.SparseSGD(stochastic_rounding=True))
    with pytest.raises(ValueError, match="generator="):
        step(ett.init_dcn(cfg, device="cpu"),
             *_batch(np.random.default_rng(0), cfg))


# ---------------------------------------------------------------------------
# The loop and the service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name", ["sgd", "adagrad_indexer"])
def test_train_dcn_losses_match_jax(opt_name):
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name)
    data = dict(vocab_sizes=SMALL["vocab_sizes"], num_dense=5, batch_size=B,
                seed=3)
    evals = list(SyntheticCriteo(**data, stream_seed=99).batches(2))
    jres = jax_train_dcn(jcfg, SyntheticCriteo(**data).batches(), 4,
                         sparse_opt=jopt, dense_lr=0.05, model=jm,
                         log_every=1, verbose=False)
    pres = ett.train_dcn(pcfg, SyntheticCriteo(**data).batches(), 4,
                         sparse_opt=popt, dense_lr=0.05, model=pm,
                         log_every=1, verbose=False, eval_batches=evals,
                         eval_every=2)
    assert pres.model is pm and len(pres.losses) == 4
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4,
                               atol=1e-4)
    assert [s for s, _ in pres.aucs] == [2, 4]


def test_train_dcn_from_arrays_with_eval_metrics_matches_jax():
    # model= as numpy arrays (the family's from_arrays builder) and the
    # eval_metrics sweep: the same AUC and metrics as JAX's evaluate_metrics.
    from embeddingtables_tpu.models.train import evaluate_metrics as jem
    (jcfg, jopt, jm), (pcfg, popt, _) = _pair("sgd")
    arrays = dict(cross=_arrays(jm.cross), deep=_arrays(jm.deep),
                  head=_arrays([jm.head])[0],
                  table_data=np.asarray(jm.tables.data),
                  offsets=jm.tables.offsets)
    data = dict(vocab_sizes=SMALL["vocab_sizes"], num_dense=5, batch_size=B,
                seed=4)
    evals = list(SyntheticCriteo(**data, stream_seed=7).batches(2))
    pres = ett.train_dcn(pcfg, SyntheticCriteo(**data).batches(), 2,
                         sparse_opt=popt, dense_lr=0.05, model=arrays,
                         device="cpu", log_every=1, verbose=False,
                         eval_batches=evals, eval_every=2, eval_metrics=True)
    jres = jax_train_dcn(jcfg, SyntheticCriteo(**data).batches(), 2,
                         sparse_opt=jopt, dense_lr=0.05, model=jm,
                         log_every=1, verbose=False)
    want = jem(JD.make_eval_step(jcfg), jres.model, evals)
    got = ett.evaluate_metrics(PD.make_eval_step(pcfg), pres.model, evals)
    assert pres.aucs == [(2, got["auc"])]
    for key in ("auc", "log_loss", "normalized_entropy", "calibration"):
        assert abs(got[key] - want[key]) <= 1e-4, key


def test_dcn_service_gives_the_eval_steps_results():
    _, (pcfg, _, pm) = _pair()
    svc = ett.make_dcn_service(pm, max_batch=16, max_latency_ms=1.0)
    try:
        rng = np.random.default_rng(5)
        reqs = [_batch(rng, pcfg)[:2] for _ in range(3)]
        reqs = [(d[:b], c[:, :b]) for (d, c), b in zip(reqs, (1, 5, 16))]
        outs = [svc.submit(d, c) for d, c in reqs]
        for (d, c), fut in zip(reqs, outs):
            want = PD.make_eval_step(pcfg)(pm, d, c).numpy()
            np.testing.assert_allclose(fut.result(timeout=30), want,
                                       rtol=1e-6, atol=1e-6)
    finally:
        svc.stop()
    # A single-device model on a mesh is refused (a mesh serves a
    # ShardedDCN or a PlannedDCN); quantized on a mesh raises JAX's own
    # error.
    for kw in (dict(mesh=True), dict(quantized=True, mesh=True)):
        with pytest.raises(NotImplementedError):
            ett.make_dcn_service(pm, **kw)


@pytest.mark.parametrize("name", ["mesh", "plan", "evict_every",
                                  "delta_ckpt", "ckpt_manager", "guard",
                                  "device_prefetch", "microbatch",
                                  "dense_tx"])
def test_train_dcn_options_not_ported_raise(name):
    # Every option is ported, beside a mesh and a plan too (items I-2c,
    # I-3a): each comes with a (here fake) mesh and a plan and the loop
    # reaches the mesh, but delta checkpoints under a plan raise JAX's
    # NotImplementedError before anything touches the mesh.
    value = {"evict_every": 10, "device_prefetch": 2, "microbatch": 2,
             "dense_tx": ADAM}.get(name, object())
    kw = {"mesh": object(), "plan": object(), name: value}
    if name == "delta_ckpt":
        kw["delta_every"] = 2
    cfg = ett.DCNConfig(**SMALL)
    if name == "delta_ckpt":
        with pytest.raises(NotImplementedError, match="delta checkpointing"):
            ett.train_dcn(cfg, iter(()), 1, device="cpu", **kw)
    else:
        with pytest.raises(AttributeError):      # reaches the fake mesh
            ett.train_dcn(cfg, iter(()), 1, device="cpu", **kw)
    kw.pop("plan")
    with pytest.raises(AttributeError):          # reaches the fake mesh
        ett.train_dcn(cfg, iter(()), 1, device="cpu", **kw)


def test_init_dcn_shapes_and_state():
    cfg = ett.DCNConfig(**SMALL, table_dtype=torch.bfloat16)
    m = ett.init_dcn(cfg, torch.Generator().manual_seed(0), device="cpu",
                     sparse_opt=P.SparseRowWiseAdaGrad(initial_accum=0.5))
    f = cfg.input_features
    assert f == 4 * 8 + 5
    assert [tuple(t.shape) for t in m.cross[0]] == [(f, 64), (f, 64), (f,)]
    assert [tuple(w.shape) for w, _ in m.deep] == [(f, 16), (16, 8)]
    assert tuple(m.head[0].shape) == (8, 1)
    assert m.tables.data.shape == (70, 8)
    assert m.tables.data.dtype == torch.bfloat16
    assert torch.equal(m.emb_state.accum, torch.full((70,), 0.5))
    parallel = ett.init_dcn(dataclasses.replace(cfg, structure="parallel"),
                            device="cpu")
    assert tuple(parallel.head[0].shape) == (f + 8, 1)
