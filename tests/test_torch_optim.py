"""The port's sparse optimizers and stochastic rounding against the JAX
package's, on the same numpy inputs on the CPU.

`SparseSGD`, `SparseRowWiseAdaGrad`, `SparseLazyAdam` and `SparseFTRL` run on
tables on both sides of the 512-padded-row line (`hot_accumulate` below it,
the scatter above), with weighted, mean and padded bags, regularizers, a
bf16 gradient scratch, and ids outside the vocabulary. Tolerance: rtol/atol
1e-5, the order of f32 additions (run-scatter or `index_add_` here, XLA's
scatter or a one-hot matmul there); 1e-3 where both sides accumulate in a
bf16 scratch, whose partial sums round (2^-9 relative each) in different
orders. Adam and FTRL are held over three steps (JAX jitted, one program
per optimizer and shape) to rtol/atol 1e-5 as well.

Stochastic rounding draws its noise from a `torch.Generator`, which cannot
reproduce JAX's bits, so it is held to its properties, as
`tests/test_rounding.py` holds JAX's.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import embeddingtables_tpu as et
from embeddingtables_tpu import optim as J
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.interop import tensor_from_array
from embeddingtables_tpu_torch.ops.cuda import scatter as S
from embeddingtables_tpu_torch.ops.cuda import segsum as H
from embeddingtables_tpu_torch.rounding import (stochastic_cast,
                                                stochastic_round_to_bf16)
from _torch_threads import _one_torch_thread  # noqa: F401


D, B, BAG = 128, 24, 3

OPTS = {
    # name: (JAX optimizer, port optimizer)
    "sgd": (J.SparseSGD(lr=0.3), P.SparseSGD(lr=0.3)),
    "sgd_decay_clip": (J.SparseSGD(lr=0.3, weight_decay=0.1, clipnorm=0.5),
                       P.SparseSGD(lr=0.3, weight_decay=0.1, clipnorm=0.5)),
    "sgd_decay_bf16_scratch": (
        J.SparseSGD(lr=0.3, weight_decay=0.1, dense_grad_dtype="bfloat16"),
        P.SparseSGD(lr=0.3, weight_decay=0.1, dense_grad_dtype="bfloat16")),
    "adagrad_indexer": (J.SparseRowWiseAdaGrad(lr=0.3, method="indexer"),
                        P.SparseRowWiseAdaGrad(lr=0.3, method="indexer")),
    "adagrad_dense": (J.SparseRowWiseAdaGrad(lr=0.3, method="dense"),
                      P.SparseRowWiseAdaGrad(lr=0.3, method="dense")),
    "adagrad_auto_clip": (J.SparseRowWiseAdaGrad(lr=0.3, clipnorm=0.5),
                          P.SparseRowWiseAdaGrad(lr=0.3, clipnorm=0.5)),
    "adagrad_decay_bf16_scratch": (
        J.SparseRowWiseAdaGrad(lr=0.3, weight_decay=0.1,
                               dense_grad_dtype="bfloat16",
                               initial_accum=0.1),
        P.SparseRowWiseAdaGrad(lr=0.3, weight_decay=0.1,
                               dense_grad_dtype="bfloat16",
                               initial_accum=0.1)),
}


def _update(rng, v, kind, wrap_ids):
    """(JAX update, port update) from one numpy draw. kind "rows": one-hot
    with out-of-range ids; "bags": mean bags with pads and weights."""
    if kind == "rows":
        idx = rng.integers(0, v, B).astype(np.int32)
        bad = [v, v + 7, 2**31 - 1] + ([-1, -v, -v - 1] if wrap_ids else [])
        idx[:len(bad)] = bad
        w = None
    else:
        idx = rng.integers(0, v, (B, BAG)).astype(np.int32)
        idx[rng.random((B, BAG)) < 0.3] = -1
        w = np.asarray(et.effective_weights(
            jnp.asarray(idx), "mean",
            jnp.asarray(rng.uniform(0.5, 1.5, (B, BAG)).astype(np.float32)),
            pad_idx=-1))
    delta = rng.standard_normal((B, D)).astype(np.float32)
    delta[1] = 0.0                      # a touched row with no gradient
    jupd = et.SparseEmbeddingUpdate(
        delta=jnp.asarray(delta), indices=jnp.asarray(idx),
        weights=None if w is None else jnp.asarray(w))
    pupd = ett.SparseEmbeddingUpdate(
        delta=torch.from_numpy(delta), indices=torch.from_numpy(idx),
        weights=None if w is None else torch.from_numpy(w.copy()))
    return jupd, pupd


@pytest.mark.parametrize("kind", ["rows", "bags"])
@pytest.mark.parametrize("v", [300, 1000])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_step_matches_jax(name, v, kind):
    jopt, popt = OPTS[name]
    rng = np.random.default_rng(v + len(name) + len(kind))
    # JAX's indexer path reads a negative id's accumulator at row 0 (a
    # clip) but writes the row the id wraps to, and writes row V-1 for an
    # id below -V: no negative ids there.
    jupd, pupd = _update(rng, v, kind, wrap_ids="indexer" not in name)
    arr = rng.standard_normal((v, D)).astype(np.float32)
    jstate = jopt.init(jnp.asarray(arr))
    jdata, jstate = jopt.apply(jnp.asarray(arr), jupd, jstate)
    data = tensor_from_array(arr, "cpu")
    state = popt.init(data)
    launches = (S.scatter_add_rows_sorted.launches,
                H.hot_accumulate.launches)
    got, pstate = popt.apply(data, pupd, state)
    assert got is data and pstate.accum is state.accum     # in place
    assert launches == (S.scatter_add_rows_sorted.launches,
                        H.hot_accumulate.launches)         # CPU: plain
    tol = 1e-3 if "bf16" in name else 1e-5
    np.testing.assert_allclose(data.numpy(), np.asarray(jdata), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(pstate.accum.numpy(), np.asarray(jstate.accum),
                               rtol=tol, atol=1e-7)


@pytest.mark.parametrize("method", ["indexer", "dense"])
def test_adagrad_at_eps_0_keeps_zero_gradient_rows_finite(method):
    # The port clamps max(accum + eps, 1e-30) on both methods, as JAX's
    # dense method does; JAX's indexer has no clamp and gives NaN here.
    v = 1000
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((v, D)).astype(np.float32)
    idx = np.array([5, 5, 9, 700], np.int32)
    delta = rng.standard_normal((4, D)).astype(np.float32)
    delta[2] = 0.0                       # row 9: touched, zero gradient
    jopt = J.SparseRowWiseAdaGrad(lr=0.3, eps=0.0, method="dense")
    jdata, jstate = jopt.apply(
        jnp.asarray(arr), et.SparseEmbeddingUpdate(
            delta=jnp.asarray(delta), indices=jnp.asarray(idx)),
        jopt.init(jnp.asarray(arr)))
    popt = P.SparseRowWiseAdaGrad(lr=0.3, eps=0.0, method=method)
    data = torch.from_numpy(arr.copy())
    popt.apply(data, ett.SparseEmbeddingUpdate(
        delta=torch.from_numpy(delta), indices=torch.from_numpy(idx)),
        popt.init(data))
    assert torch.isfinite(data).all() and torch.equal(data[9],
                                                      torch.from_numpy(arr[9]))
    np.testing.assert_allclose(data.numpy(), np.asarray(jdata), rtol=1e-5,
                               atol=1e-5)


def test_the_same_value_errors_as_jax():
    data = torch.zeros((1000, D), dtype=torch.bfloat16)
    upd = ett.SparseEmbeddingUpdate(delta=torch.ones((2, D)),
                                    indices=torch.tensor([1, 2]))
    for opt in (P.SparseSGD(stochastic_rounding=True),
                P.SparseRowWiseAdaGrad(stochastic_rounding=True)):
        with pytest.raises(ValueError, match="stochastic_rounding=True needs"):
            opt.apply(data, upd, opt.init(data))
    for kw in ({"weight_decay": 0.1}, {"clipnorm": 1.0},
               {"stochastic_rounding": True}):
        opt = P.SparseRowWiseAdaGrad(method="indexer", **kw)
        with pytest.raises(ValueError, match="require the dense realization"):
            opt.apply(data, upd, opt.init(data),
                      generator=torch.Generator().manual_seed(0))


def test_what_waits_for_the_indexer_raises():
    # idx_result= no longer waits: "auto" takes the indexer method with it
    # (JAX: `optim.py` SparseRowWiseAdaGrad).
    v = 1000
    rng = np.random.default_rng(6)
    arr = rng.standard_normal((v, D)).astype(np.float32)
    idx = np.array([5, 5, 9, 700, 9, 5], np.int32)
    delta = rng.standard_normal((6, D)).astype(np.float32)
    jopt = J.SparseRowWiseAdaGrad(lr=0.3)
    jdata, jstate = jax.jit(lambda d, u, s: jopt.apply(
        d, u, s, idx_result=et.index(u.indices)))(
        jnp.asarray(arr), et.SparseEmbeddingUpdate(
            delta=jnp.asarray(delta), indices=jnp.asarray(idx)),
        jopt.init(jnp.asarray(arr)))
    data = torch.from_numpy(arr.copy())
    upd = ett.SparseEmbeddingUpdate(delta=torch.from_numpy(delta),
                                    indices=torch.from_numpy(idx))
    opt = P.SparseRowWiseAdaGrad(lr=0.3)
    state = opt.init(data)
    calls = S.scatter_add_rows_sorted.launches
    opt.apply(data, upd, state, idx_result=ett.index(upd.indices))
    np.testing.assert_allclose(data.numpy(), np.asarray(jdata), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.accum.numpy(), np.asarray(jstate.accum),
                               rtol=1e-5, atol=1e-7)
    assert calls == S.scatter_add_rows_sorted.launches      # CPU: plain
    # A port-side choice: JAX silently ignores the scratch dtype here.
    opt = P.SparseRowWiseAdaGrad(method="indexer", dense_grad_dtype="bfloat16")
    with pytest.raises(ValueError, match="dense method only"):
        opt.apply(data, upd, opt.init(data))


ZOO = {
    # name: (JAX optimizer, port optimizer)
    "lazy_adam_decay_clip": (
        J.SparseLazyAdam(lr=0.05, weight_decay=0.1, clipnorm=0.5),
        P.SparseLazyAdam(lr=0.05, weight_decay=0.1, clipnorm=0.5)),
    "ftrl": (J.SparseFTRL(lr=0.1), P.SparseFTRL(lr=0.1)),
    "ftrl_l1_l2_clip": (J.SparseFTRL(lr=0.1, l1=0.05, l2=0.1, clipnorm=2.0,
                                     initial_accum=0.1),
                        P.SparseFTRL(lr=0.1, l1=0.05, l2=0.1, clipnorm=2.0,
                                     initial_accum=0.1)),
}


@pytest.mark.parametrize("v", [300, 1000])
@pytest.mark.parametrize("name", sorted(ZOO))
def test_adam_and_ftrl_match_jax_over_three_steps(name, v):
    """A one-hot step, a bag step and a one-hot step, with ids outside the
    vocabulary: V = 300 takes `hot_accumulate`'s plain version, V = 1000 the
    `index_add_` scratch. The state is updated in place; Adam's count is a
    0-d int32 tensor."""
    jopt, popt = ZOO[name]
    rng = np.random.default_rng(v + len(name))
    arr = (0.1 * rng.standard_normal((v, D))).astype(np.float32)
    jdata = jnp.asarray(arr)
    jstate = jopt.init(jdata)
    jstep = jax.jit(lambda d, u, s: jopt.apply(d, u, s))
    data = torch.from_numpy(arr.copy())
    state = popt.init(data)
    leaves = [t.data_ptr() for t in state if t.dim()]
    for kind in ("rows", "bags", "rows"):
        jupd, pupd = _update(rng, v, kind, wrap_ids=True)
        jdata, jstate = jstep(jdata, jupd, jstate)
        got, state = popt.apply(data, pupd, state)
        assert got is data
    assert [t.data_ptr() for t in state if t.dim()] == leaves  # in place
    np.testing.assert_allclose(data.numpy(), np.asarray(jdata), rtol=1e-5,
                               atol=1e-5)
    for p, j in zip(state, jstate):
        assert p.dtype == torch.float32 or p.dtype == torch.int32
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    if "ftrl" in name and "l1" in name:
        assert int((data == 0).sum()) > 0              # l1: exact zeros


def test_ftrl_init_reproduces_the_table_and_untouched_rows_stay():
    rng = np.random.default_rng(2)
    arr = rng.standard_normal((60, 8)).astype(np.float32)
    opt = P.SparseFTRL(lr=0.05, l1=0.2, l2=0.3, initial_accum=0.1)
    z0, n0 = P.ftrl_init_arrays(torch.from_numpy(arr), 0.05, 1.0, 0.2, 0.3,
                                0.1)
    jz0, jn0 = J.ftrl_init_arrays(jnp.asarray(arr), 0.05, 1.0, 0.2, 0.3, 0.1)
    np.testing.assert_array_equal(z0.numpy(), np.asarray(jz0))
    np.testing.assert_array_equal(n0.numpy(), np.asarray(jn0))
    # The closed form of (z0, n0) gives the table back.
    denom = (1.0 + torch.sqrt(n0)) / 0.05 + 0.3
    back = torch.where(z0.abs() > 0.2, -(z0 - torch.sign(z0) * 0.2) / denom,
                       0.0)
    np.testing.assert_allclose(back.numpy(), arr, rtol=1e-5, atol=1e-6)
    data = torch.from_numpy(arr.copy())
    idx = rng.integers(0, 10, 32).astype(np.int32)
    delta = rng.standard_normal((32, 8)).astype(np.float32)
    opt.apply(data, ett.SparseEmbeddingUpdate(
        delta=torch.from_numpy(delta), indices=torch.from_numpy(idx)),
        opt.init(data))
    assert torch.equal(data[10:], torch.from_numpy(arr[10:]))
    assert not torch.equal(data[:10], torch.from_numpy(arr[:10]))


def test_ftrl_refuses_another_lr():
    opt = P.SparseFTRL(lr=0.05)
    data = torch.ones((4, 2))
    state = opt.init(data)
    upd = ett.SparseEmbeddingUpdate(delta=torch.full((1, 2), 1e-9),
                                    indices=torch.tensor([0]))
    with pytest.raises(ValueError, match="cannot change lr"):
        opt.apply(data, upd, state, lr=0.01)
    assert torch.equal(data, torch.ones((4, 2)))
    opt.apply(data, upd, state, lr=0.05)           # the built value passes
    assert torch.equal(data[1:], torch.ones((3, 2)))
    for o in (P.SparseFTRL(stochastic_rounding=True),
              P.SparseLazyAdam(stochastic_rounding=True)):
        with pytest.raises(ValueError, match="needs apply"):
            o.apply(data, upd, o.init(data))


@pytest.mark.parametrize("v,run_scatters", [(160, 0), (161, 1)])
def test_auto_method_follows_the_n16_rule(v, run_scatters, monkeypatch):
    # n * 16 >= V takes the dense method (hot_accumulate or index_add_),
    # else the indexer (the run-scatter), seen here by a spy on its entry.
    upd = ett.SparseEmbeddingUpdate(delta=torch.ones((10, D)),
                                    indices=torch.arange(10))
    opt = P.SparseRowWiseAdaGrad()
    calls = []
    real = P.scatter_update
    monkeypatch.setattr(P, "scatter_update",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    data = torch.zeros((v, D))
    opt.apply(data, upd, opt.init(data))
    assert len(calls) == run_scatters


def test_apply_dense_tx_is_plain_sgd_in_place():
    rng = np.random.default_rng(8)
    ps = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal(4).astype(np.float32))]
    gs = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
          for p in ps]
    want, _ = J.apply_dense_tx([jnp.asarray(p.numpy()) for p in ps],
                               [jnp.asarray(g.numpy()) for g in gs], None,
                               None, 0.1)
    before = [p.data_ptr() for p in ps]
    P.apply_dense_tx(ps, gs, None, None, 0.1)
    assert [p.data_ptr() for p in ps] == before
    for p, w in zip(ps, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-6)
    # A dense_tx that is not an optimizer factory is refused.
    with pytest.raises(TypeError, match="torch.optim"):
        P.apply_dense_tx(ps, gs, object(), None, 0.1)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedules_match_jax(schedule):
    if schedule == "cosine":
        j, p = (J.warmup_cosine_lr(0.1, 50, 10, 0.1),
                P.warmup_cosine_lr(0.1, 50, 10, 0.1))
    else:
        j, p = J.warmup_constant_lr(0.1, 7), P.warmup_constant_lr(0.1, 7)
    for step in range(60):
        assert math.isclose(p(step), j(step), rel_tol=1e-12)


# ---------------------------------------------------------------------------
# Stochastic rounding: properties
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sr_lands_on_the_two_neighbours_only():
    x = torch.full((4000,), 1.0 + 2 ** -10)   # between 1.0 and 1.0078125
    out = stochastic_round_to_bf16(x, _gen(0))
    assert out.dtype == torch.bfloat16
    assert set(out.float().tolist()) == {1.0, 1.0078125}


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_sr_is_unbiased(k):
    # x = 1 + k/8 ulp rounds up with probability k/8; on the negative side
    # it rounds away from zero with the same probability.
    ulp = 2 ** -7
    for sign in (1.0, -1.0):
        x = torch.full((8000,), sign * (1.0 + (k / 8) * ulp))
        out = stochastic_round_to_bf16(x, _gen(k)).float()
        up = float((out.abs() > 1.0).float().mean())
        assert abs(up - k / 8) < 0.03, (k, sign, up)


def test_sr_keeps_representable_and_special_values():
    vals = torch.tensor([0.0, -0.0, 1.0, -2.5, 2.0 ** -100, math.inf,
                         -math.inf, math.nan])
    got = stochastic_round_to_bf16(vals, _gen(0)).float()
    assert got[0] == 0.0 and got[2] == 1.0 and got[3] == -2.5
    assert torch.signbit(got[1])
    assert got[5] == math.inf and got[6] == -math.inf and torch.isnan(got[7])


def test_stochastic_cast_passthrough():
    x = torch.tensor([1.1, 2.2])
    assert torch.equal(stochastic_cast(x, torch.float32, _gen(0)), x)
    assert torch.equal(stochastic_cast(x, torch.bfloat16, None),
                       x.to(torch.bfloat16))


@pytest.mark.parametrize("opt", [
    P.SparseSGD(lr=0.5, stochastic_rounding=True),
    P.SparseRowWiseAdaGrad(lr=0.5, stochastic_rounding=True),
    P.SparseRowWiseAdaGrad(lr=0.5, stochastic_rounding=True,
                           weight_decay=0.1),
    P.SparseLazyAdam(lr=0.05, stochastic_rounding=True),
    P.SparseFTRL(lr=1.0, stochastic_rounding=True)],
    ids=["sgd", "adagrad", "adagrad_decay", "lazy_adam", "ftrl"])
def test_sr_leaves_untouched_rows_exact(opt):
    v = 10
    data = (1.0 + torch.arange(v * 4, dtype=torch.float32).reshape(v, 4)
            / 64.0).to(torch.bfloat16)
    before = data.clone()
    # A step above one bf16 ulp: touched rows move under any noise draw.
    upd = ett.SparseEmbeddingUpdate(delta=torch.full((2, 4), 0.02),
                                    indices=torch.tensor([3, 7]))
    opt.apply(data, upd, opt.init(data), generator=_gen(0))
    keep = [i for i in range(v) if i not in (3, 7)]
    assert torch.equal(data[keep], before[keep])
    assert not torch.equal(data[[3, 7]], before[[3, 7]])


def test_bf16_sub_ulp_steps_accumulate_only_under_sr():
    v, d, steps = 4, 8, 400
    step = 2 ** -7 / 16                    # 1/16 of a bf16 ulp at 1.0
    upd = ett.SparseEmbeddingUpdate(delta=torch.full((v, d), step),
                                    indices=torch.arange(v))
    nearest, sr = P.SparseSGD(lr=1.0), P.SparseSGD(lr=1.0,
                                                   stochastic_rounding=True)
    d_n = torch.ones((v, d), dtype=torch.bfloat16)
    d_s = d_n.clone()
    gen = _gen(3)
    for _ in range(steps):
        nearest.apply(d_n, upd, nearest.init(d_n))
        sr.apply(d_s, upd, sr.init(d_s), generator=gen)
    assert torch.equal(d_n, torch.ones_like(d_n))
    drift = 1.0 - float(d_s.float().mean())
    assert 0.6 * steps * step < drift < 1.4 * steps * step
