"""The port's DLRM training slice against the JAX package's, on the CPU.

  - The block interaction's backward (`_BlockInteraction`) against `jax.vjp`
    of `_block_interaction_fn`, and against `torch.autograd.gradcheck` in
    float64.
  - `make_train_step` against JAX's for three steps from one state (weights
    and the optimizer state carried by `dlrm_from_arrays`) with SGD,
    row-wise AdaGrad, lazy Adam and FTRL: tables, every state leaf, towers
    and losses.
  - `SyntheticCriteo`, `auc`, `log_loss` and `train_dlrm` against JAX's.

Tolerances: f32 towers agree up to the order of f32 sums (matmuls, the
run-scatter against XLA's scatter): rtol/atol 1e-5 on one backward, 1e-4
after three steps or four loop steps. bf16 towers: XLA and PyTorch may round
bf16 matmul partial results differently, so three steps are held to 2^-6
of the largest value: a few bf16 roundings (2^-9 each), compounded.
"""
import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu.data import SyntheticCriteo as JaxCriteo
from embeddingtables_tpu.metrics import auc as jax_auc
from embeddingtables_tpu.metrics import log_loss as jax_log_loss
from embeddingtables_tpu.models import DLRMConfig as JaxConfig
from embeddingtables_tpu.models import init_dlrm as jax_init_dlrm
from embeddingtables_tpu.models.dlrm import \
    _block_interaction_fn as jax_block_fn
from embeddingtables_tpu.models.dlrm import make_train_step as jax_train_step
from embeddingtables_tpu import metrics as JM
from embeddingtables_tpu.models.dlrm import make_eval_step as jax_eval_step
from embeddingtables_tpu.models.train import \
    evaluate_metrics as jax_evaluate_metrics
from embeddingtables_tpu.models.train import train_dlrm as jax_train_dlrm
from embeddingtables_tpu import optim as J
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import metrics as PM
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.data import SyntheticCriteo
from embeddingtables_tpu_torch.models import dlrm as PD
from embeddingtables_tpu_torch.models.train import train_dlrm
from _torch_threads import _one_torch_thread  # noqa: F401


JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# The block interaction's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [-1, 0])
def test_block_interaction_backward_matches_jax_vjp(offset, dtype):
    rng = np.random.default_rng(offset + 3)
    t, b, d = 5, 6, 8
    bot = rng.standard_normal((b, d)).astype(np.float32)
    emb = rng.standard_normal((t, b, d)).astype(np.float32)
    fn = jax_block_fn(t, offset)
    jbot, jemb = (jnp.asarray(x, JAX_DT[dtype]) for x in (bot, emb))
    out, vjp = jax.vjp(fn, jbot, jemb)
    dflat = rng.standard_normal(out.shape).astype(np.float32)
    jdbot, jdemb = vjp(jnp.asarray(dflat, JAX_DT[dtype]))
    tbot = torch.tensor(bot).to(TORCH_DT[dtype]).requires_grad_(True)
    temb = torch.tensor(emb).to(TORCH_DT[dtype]).requires_grad_(True)
    tout = PD._block_interaction(tbot, temb, offset)
    tdbot, tdemb = torch.autograd.grad(
        tout, (tbot, temb), torch.tensor(dflat).to(TORCH_DT[dtype]))
    assert tdbot.dtype == tdemb.dtype == TORCH_DT[dtype]
    # f32: summation order. bf16: each side rounds every product matrix to
    # bf16 once (2^-8 relative, of values of order 10 here).
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -3)
    for got, want in ((tout, out), (tdbot, jdbot), (tdemb, jdemb)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want).astype(np.float32), **tol)


@pytest.mark.parametrize("offset", [-1, 0])
def test_block_interaction_gradcheck(offset):
    g = torch.Generator().manual_seed(offset + 7)
    bot = torch.randn((3, 4), generator=g, dtype=torch.float64,
                      requires_grad=True)
    emb = torch.randn((4, 3, 4), generator=g, dtype=torch.float64,
                      requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, e: PD._block_interaction(a, e, offset), (bot, emb))


# ---------------------------------------------------------------------------
# make_train_step against JAX's
# ---------------------------------------------------------------------------

# The towers' Adam, as the loops take it (`dense_tx`).
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
SMALL = dict(vocab_sizes=(13, 29, 7, 21), num_dense=5, dim=8,
             bottom_mlp=(16, 8), top_mlp=(32, 16, 1))
B = 16


def _opts(name):
    return {"sgd": (J.SparseSGD(0.1), P.SparseSGD(0.1)),
            "adagrad_indexer": (J.SparseRowWiseAdaGrad(0.1, method="indexer"),
                                P.SparseRowWiseAdaGrad(0.1, method="indexer")),
            "adagrad_dense": (J.SparseRowWiseAdaGrad(0.1, method="dense",
                                                     initial_accum=0.1),
                              P.SparseRowWiseAdaGrad(0.1, method="dense",
                                                     initial_accum=0.1)),
            "lazy_adam": (J.SparseLazyAdam(0.05), P.SparseLazyAdam(0.05)),
            "ftrl": (J.SparseFTRL(0.1, l1=0.01), P.SparseFTRL(0.1, l1=0.01)),
            }[name]


def _arrays(layers):
    return [(np.asarray(w), np.asarray(b)) for w, b in layers]


def _pair(opt_name, compute="float32", **kw):
    jopt, popt = _opts(opt_name)
    cfg_kw = {**SMALL, **kw}
    jcfg = JaxConfig(**cfg_kw, compute_dtype=JAX_DT[compute])
    pcfg = ett.DLRMConfig(**cfg_kw, compute_dtype=TORCH_DT[compute])
    jm = jax_init_dlrm(jax.random.key(0), jcfg, sparse_opt=jopt)
    state = jm.emb_state if opt_name != "sgd" else None
    pm = ett.dlrm_from_arrays(pcfg, _arrays(jm.bottom), _arrays(jm.top),
                              np.asarray(jm.tables.data), jm.tables.offsets,
                              device="cpu", emb_state=state)
    return (jcfg, jopt, jm), (pcfg, popt, pm)


def _batch(rng, cfg, pad_idx=None):
    dense = rng.standard_normal((B, cfg.num_dense)).astype(np.float32)
    shape = (B,) if cfg.bag is None else (B, cfg.bag)
    cat = np.stack([rng.integers(0, v, shape) for v in cfg.vocab_sizes])
    cat = cat.astype(np.int32)
    if pad_idx is not None:
        cat[rng.random(cat.shape) < 0.3] = pad_idx
    label = rng.integers(0, 2, B).astype(np.float32)
    return dense, cat, label


STEPS = {
    # name: (optimizer, config overrides)
    "onehot_sgd": ("sgd", {}),
    "onehot_adagrad_indexer": ("adagrad_indexer", {}),
    "onehot_adagrad_dense": ("adagrad_dense", {}),
    "bag_mean_pad_sgd": ("sgd", dict(bag=3, combiner="mean", pad_idx=-1)),
    "bag_sum_adagrad_indexer": ("adagrad_indexer", dict(bag=3)),
    "cat_interaction_sgd": ("sgd", dict(interaction="cat")),
    "self_interaction_adagrad": ("adagrad_indexer",
                                 dict(self_interaction=True)),
    "onehot_lazy_adam": ("lazy_adam", {}),
    "bag_mean_pad_ftrl": ("ftrl", dict(bag=3, combiner="mean", pad_idx=-1)),
}


def _run_both(opt_name, compute, kw, steps=3):
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name, compute, **kw)
    jstep = jax_train_step(jcfg, sparse_opt=jopt, dense_lr=0.05)
    pstep = ett.make_train_step(pcfg, sparse_opt=popt, dense_lr=0.05)
    rng = np.random.default_rng(1)
    jl, pl = [], []
    for _ in range(steps):
        dense, cat, label = _batch(rng, pcfg, kw.get("pad_idx"))
        jm, loss = jstep(jm, jnp.asarray(dense), jnp.asarray(cat),
                         jnp.asarray(label))
        jl.append(float(loss))
        pl.append(float(pstep(pm, dense, cat, label)))
    return jm, pm, np.array(jl), np.array(pl)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_matches_jax_f32(case):
    opt_name, kw = STEPS[case]
    jm, pm, jl, pl = _run_both(opt_name, "float32", kw)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pl, jl, **tol)
    np.testing.assert_allclose(pm.tables.data.numpy(),
                               np.asarray(jm.tables.data), **tol)
    assert type(pm.emb_state).__name__ == type(jm.emb_state).__name__
    for p, j in zip(pm.emb_state, jm.emb_state):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **tol)
    for (jw, jb), (pw, pb) in zip(jm.bottom + jm.top, pm.bottom + pm.top):
        np.testing.assert_allclose(pw.detach().numpy(), np.asarray(jw), **tol)
        np.testing.assert_allclose(pb.detach().numpy(), np.asarray(jb), **tol)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad_indexer"])
def test_train_step_bf16_towers_stay_close_to_jax(opt_name):
    jm, pm, jl, pl = _run_both(opt_name, "bfloat16", {})
    bound = 2 ** -6
    np.testing.assert_allclose(pl, jl, rtol=bound, atol=bound)
    if opt_name == "sgd":
        # AdaGrad's step lr * g / rms(g) is scale-free: a row whose small
        # gradient is mostly bf16 rounding moves by ~lr on either side, so
        # its tables are compared at f32 only.
        want = np.asarray(jm.tables.data)
        err = np.abs(pm.tables.data.numpy() - want).max()
        assert err <= bound * np.abs(want).max(), err


def test_a_step_reads_the_table_before_it_writes_it():
    _, (pcfg, popt, pm) = _pair("sgd")
    dense, cat, label = _batch(np.random.default_rng(2), pcfg)
    before = pm.tables.data.clone()
    want = PD.bce_loss(ett.dlrm_forward(pm, dense, cat),
                       torch.from_numpy(label))
    loss = ett.make_train_step(pcfg, sparse_opt=popt)(pm, dense, cat, label)
    assert float(loss) == float(want.detach())
    assert not torch.equal(pm.tables.data, before)


def test_train_step_refuses_what_is_not_ported():
    # A batch that microbatch=k does not divide: JAX's ValueError, raised
    # before the step changes the model.
    cfg = ett.DLRMConfig(**SMALL)
    batch = _batch(np.random.default_rng(0), cfg)
    jm = jax_init_dlrm(jax.random.key(0), JaxConfig(**SMALL))
    want = f"batch {B} not divisible by microbatch 3"
    with pytest.raises(ValueError, match=want):
        jax_train_step(JaxConfig(**SMALL), microbatch=3)(
            jm, *(jnp.asarray(x) for x in batch))
    model = ett.init_dlrm(cfg, device="cpu")
    before = model.tables.data.clone()
    with pytest.raises(ValueError, match=want):
        ett.make_train_step(cfg, microbatch=3)(model, *batch)
    assert torch.equal(model.tables.data, before)
    step = ett.make_train_step(
        cfg, sparse_opt=P.SparseSGD(stochastic_rounding=True))
    with pytest.raises(ValueError, match="generator="):
        step(model, *_batch(np.random.default_rng(0), cfg))


# ---------------------------------------------------------------------------
# Data, metrics and the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(bag=4, pad_idx=-1)],
                         ids=["onehot", "bag_pad"])
def test_synthetic_criteo_batches_are_bitwise_jax_batches(kw):
    args = dict(vocab_sizes=(50, 300, 7), num_dense=13, batch_size=64,
                seed=5, **kw)
    for jb, pb in zip(JaxCriteo(**args).batches(3),
                      SyntheticCriteo(**args).batches(3)):
        for key in ("dense", "cat", "label"):
            assert jb[key].dtype == pb[key].dtype
            np.testing.assert_array_equal(pb[key], jb[key])


def test_auc_and_log_loss_match_jax():
    rng = np.random.default_rng(9)
    labels = (rng.random(500) < 0.3).astype(np.float32)
    scores = np.round(rng.standard_normal(500), 1)      # with ties
    assert PM.auc(labels, scores) == jax_auc(labels, scores)
    assert PM.log_loss(labels, scores) == jax_log_loss(labels, scores)
    assert np.isnan(PM.auc(np.ones(4), scores[:4]))


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad_indexer"])
def test_train_dlrm_losses_match_jax(opt_name):
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair(opt_name)
    data = dict(vocab_sizes=SMALL["vocab_sizes"], num_dense=5, batch_size=B,
                seed=3)
    evals = list(SyntheticCriteo(**data, stream_seed=99).batches(2))
    jres = jax_train_dlrm(jcfg, JaxCriteo(**data).batches(), 4,
                          sparse_opt=jopt, dense_lr=0.05, model=jm,
                          log_every=1, verbose=False)
    pres = train_dlrm(pcfg, SyntheticCriteo(**data).batches(), 4,
                      sparse_opt=popt, dense_lr=0.05, model=pm, log_every=1,
                      verbose=False, eval_batches=evals, eval_every=2,
                      lr_schedule=P.warmup_constant_lr(popt.lr, 0))
    assert pres.model is pm and len(pres.losses) == 4
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4, atol=1e-4)
    assert [s for s, _ in pres.aucs] == [2, 4]
    assert all(0.0 <= a <= 1.0 for _, a in pres.aucs)
    assert pres.examples_per_sec > 0


def test_ctr_metrics_match_jax():
    rng = np.random.default_rng(10)
    labels = (rng.random(300) < 0.3).astype(np.float32)
    logits = rng.standard_normal(300).astype(np.float32)
    for name in ("normalized_entropy", "calibration", "accuracy"):
        assert getattr(PM, name)(labels, logits) == \
            getattr(JM, name)(labels, logits), name
    true = rng.integers(0, 50, 40)
    got = rng.integers(0, 50, (40, 10))
    assert PM.recall_at_k(true, got) == JM.recall_at_k(true, got)
    assert np.isnan(PM.normalized_entropy(np.ones(3), logits[:3]))


def test_train_dlrm_eval_metrics_match_jax_evaluate_metrics():
    # train_dlrm runs on the shared CTR loop; eval_metrics=True records the
    # AUC of the same sweep JAX's evaluate_metrics makes.
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair("sgd")
    data = dict(vocab_sizes=SMALL["vocab_sizes"], num_dense=5, batch_size=B,
                seed=6)
    evals = list(SyntheticCriteo(**data, stream_seed=8).batches(2))
    jres = jax_train_dlrm(jcfg, JaxCriteo(**data).batches(), 2,
                          sparse_opt=jopt, dense_lr=0.05, model=jm,
                          log_every=1, verbose=False, eval_batches=evals,
                          eval_every=2, eval_metrics=True)
    pres = train_dlrm(pcfg, SyntheticCriteo(**data).batches(), 2,
                      sparse_opt=popt, dense_lr=0.05, model=pm, log_every=1,
                      verbose=False, eval_batches=evals, eval_every=2,
                      eval_metrics=True)
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4, atol=1e-4)
    want = jax_evaluate_metrics(jax_eval_step(jcfg), jres.model, evals)
    got = ett.evaluate_metrics(ett.make_eval_step(pcfg), pres.model, evals)
    assert set(got) == set(want) == {"auc", "log_loss", "normalized_entropy",
                                     "calibration"}
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-4, key
    assert pres.aucs == [(2, got["auc"])] and jres.aucs[0][0] == 2
    assert abs(pres.aucs[0][1] - jres.aucs[0][1]) <= 1e-4


def test_train_dlrm_with_stochastic_rounding_on_bf16_tables():
    cfg = ett.DLRMConfig(**SMALL, table_dtype=torch.bfloat16)
    data = SyntheticCriteo(vocab_sizes=SMALL["vocab_sizes"], num_dense=5,
                           batch_size=B, seed=4)
    res = train_dlrm(cfg, data.batches(), 3,
                     sparse_opt=P.SparseRowWiseAdaGrad(
                         0.1, stochastic_rounding=True),
                     device="cpu", log_every=1, verbose=False)
    assert res.model.tables.data.dtype == torch.bfloat16
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()


@pytest.mark.parametrize("name", ["mesh", "plan", "exchange", "evict_every",
                                  "delta_ckpt", "ckpt_manager", "guard",
                                  "device_prefetch", "microbatch",
                                  "dense_tx"])
def test_train_dlrm_options_not_ported_raise(name):
    # Every option is ported beside a mesh now, the planner too (items
    # I-2c, I-3a): each comes with a (here fake) mesh and a plan and the
    # loop reaches the mesh, but delta checkpoints under a plan raise JAX's
    # NotImplementedError before anything touches the mesh.
    value = {"exchange": "a2a", "evict_every": 10, "device_prefetch": 2,
             "microbatch": 2, "dense_tx": ADAM}.get(name, object())
    kw = {"mesh": object(), "plan": object()}
    if name == "delta_ckpt":
        kw["delta_every"] = 2
    if name == "exchange":
        kw["plan"] = None          # JAX's own error: a plan needs "gather"
        with pytest.raises(NotImplementedError, match="gather exchange"):
            train_dlrm(ett.DLRMConfig(**SMALL), iter(()), 1, device="cpu",
                       **{**kw, "plan": object()}, exchange=value)
    kw[name] = value
    cfg = ett.DLRMConfig(**SMALL)
    if name == "delta_ckpt":
        with pytest.raises(NotImplementedError,
                           match="delta checkpointing") as err:
            train_dlrm(cfg, iter(()), 1, device="cpu", **kw)
        assert "planner" in str(err.value)
    else:
        with pytest.raises(AttributeError):      # reaches the fake mesh
            train_dlrm(cfg, iter(()), 1, device="cpu", **kw)
    # JAX's axis= at its default is taken and does nothing.
    res = train_dlrm(cfg, iter(()), 0, device="cpu", axis="data")
    assert res.losses == []


def test_init_dlrm_takes_the_optimizer_state():
    cfg = ett.DLRMConfig(**SMALL)
    m = ett.init_dlrm(cfg, device="cpu",
                      sparse_opt=P.SparseRowWiseAdaGrad(initial_accum=0.5))
    assert torch.equal(m.emb_state.accum,
                       torch.full((sum(SMALL["vocab_sizes"]),), 0.5))
    assert ett.init_dlrm(cfg, device="cpu").emb_state.accum.numel() == 0
    # Adam and FTRL state: registered buffers, one per field.
    rows = (sum(SMALL["vocab_sizes"]), SMALL["dim"])
    m = ett.init_dlrm(cfg, device="cpu", sparse_opt=P.SparseLazyAdam())
    assert isinstance(m.emb_state, P.SparseAdamState)
    assert m.emb_m.shape == m.emb_v.shape == rows
    assert m.emb_m.data_ptr() != m.emb_v.data_ptr()
    assert m.emb_count.dtype == torch.int32 and m.emb_count.dim() == 0
    assert {"emb_m", "emb_v", "emb_count"} <= dict(m.named_buffers()).keys()
    m = ett.init_dlrm(cfg, device="cpu", sparse_opt=P.SparseFTRL(l1=0.1))
    assert isinstance(m.emb_state, P.SparseFTRLState)
    assert {"emb_z", "emb_n"} <= dict(m.named_buffers()).keys()
    with pytest.raises(TypeError, match="holds a SparseFTRLState"):
        m.emb_state = P.SparseOptState(torch.zeros(0))
    with pytest.raises(ValueError, match="fields"):
        ett.dlrm_from_arrays(cfg, [], [], np.zeros(rows, np.float32),
                             (0, rows[0]), device="cpu",
                             emb_state={"q": np.zeros(3)})


def test_train_dlrm_refuses_a_schedule_with_ftrl_where_jax_does():
    # JAX's jitted step compares a traced lr with FTRL's alpha and raises at
    # its first step (a TypeError, the tracer's bool); the port raises a
    # ValueError before its first step.
    (jcfg, jopt, jm), (pcfg, popt, pm) = _pair("ftrl")
    data = dict(vocab_sizes=SMALL["vocab_sizes"], num_dense=5, batch_size=B,
                seed=3)
    sched = P.warmup_constant_lr(popt.lr, 0)
    with pytest.raises(TypeError):
        jax_train_dlrm(jcfg, JaxCriteo(**data).batches(), 2, sparse_opt=jopt,
                       model=jm, lr_schedule=sched, verbose=False)
    before = pm.tables.data.clone()
    with pytest.raises(ValueError, match="cannot change lr"):
        train_dlrm(pcfg, SyntheticCriteo(**data).batches(), 2,
                   sparse_opt=popt, model=pm, lr_schedule=sched,
                   verbose=False)
    assert torch.equal(pm.tables.data, before)
    # Without a schedule FTRL trains, and a refused step changes nothing.
    res = train_dlrm(pcfg, SyntheticCriteo(**data).batches(), 2,
                     sparse_opt=popt, model=pm, log_every=1, verbose=False)
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    step = ett.make_train_step(pcfg, sparse_opt=popt)
    towers = [p.detach().clone() for p in pm.parameters()]
    with pytest.raises(ValueError, match="cannot change lr"):
        step(pm, *_batch(np.random.default_rng(0), pcfg), lr=0.5)
    assert all(torch.equal(a, b) for a, b in zip(towers, pm.parameters()))
