"""The port's sharded DLRM (`parallel/dlrm.py`), `train_dlrm(mesh=)` and
`make_dlrm_service(mesh=)` on a 4-rank gloo group, against JAX's on its
`local_mesh(4)` and `(2, 2)` ("data", "model") mesh: the same weights
(`dlrm_from_arrays`), the same global batches, each rank stepping on its
data block. Steps to rtol 1e-5 (the tower all-reduce's and the
run-scatter's addition orders), the a2a overflow counts equal, the evals
and served scores to rtol 1e-5.
"""
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu.models import dlrm as JM
from embeddingtables_tpu.models import train as JT
from embeddingtables_tpu.parallel import dlrm as JP
from embeddingtables_tpu.parallel.mesh import default_mesh, local_mesh
from embeddingtables_tpu.serving import make_dlrm_service as jax_service
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.data import SyntheticCriteo
from embeddingtables_tpu_torch.parallel import make_sharded_train_step
from embeddingtables_tpu_torch.parallel.dlrm import rank_generator
from _torch_mesh import MeshPool
from _torch_persist import arrays, opts
from _torch_threads import _one_torch_thread  # noqa: F401

AXES = {"1d": "data", "2d": ("data", "model")}
VOCABS = (64, 96, 33)
B = 32
SMALL = dict(vocab_sizes=VOCABS, num_dense=4, dim=8, bottom_mlp=(16, 8),
             top_mlp=(16, 1))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("mesh")))
    yield p
    p.close()


def jax_mesh(kind):
    if kind == "1d":
        return local_mesh(4)
    return default_mesh(("data", "model"), shape=(2, 2),
                        devices=jax.devices()[:4])


def cfgs(**kw):
    kw = {**SMALL, **kw}
    return (JM.DLRMConfig(compute_dtype=jnp.float32, **kw),
            ett.DLRMConfig(compute_dtype=torch.float32, **kw))


def batches(n=2, seed=3, **kw):
    data = SyntheticCriteo(vocab_sizes=VOCABS, num_dense=4, batch_size=B,
                           seed=seed, **kw)
    return [(b["dense"], b["cat"], b["label"]) for b in data.batches(n)]


def model_arrays(jm):
    return dict(bottom=arrays(jm.bottom), top=arrays(jm.top),
                table_data=np.asarray(jm.tables.data),
                offsets=jm.tables.offsets,
                emb_state={k: np.asarray(v)
                           for k, v in jm.emb_state._asdict().items()})


def jax_model(jcfg, jopt, seed=0, **kw):
    return JM.init_dlrm(jax.random.key(seed), jcfg, sparse_opt=jopt, **kw)


def jax_steps(kind, jcfg, jopt, jm, data, **kw):
    mesh, axis = jax_mesh(kind), AXES[kind]
    sm = JP.shard_dlrm(jm, mesh, axis, sparse_opt=jopt,
                       dense_tx=kw.get("dense_tx"))
    step = JP.make_sharded_train_step(jcfg, mesh, axis, sparse_opt=jopt,
                                      dense_lr=0.1, **kw)
    sd, sc, sl = JP.batch_shardings(mesh, axis)
    losses, overflows = [], []
    for dense, cat, label in data:
        sm, out = step(sm, jax.device_put(dense, sd), jax.device_put(cat, sc),
                       jax.device_put(label, sl))
        if isinstance(out, tuple):
            overflows.append(int(out[1]))
            out = out[0]
        losses.append(float(out))
    return losses, overflows, JP.unshard_dlrm(sm)


def assert_model_close(got, jm, rtol=1e-5):
    np.testing.assert_allclose(got["tables"], np.asarray(jm.tables.data),
                               rtol=rtol, atol=1e-6)
    for g, w in zip(got["state"], jm.emb_state):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=rtol,
                                   atol=1e-6)
    want = [np.asarray(t) for layer in jm.bottom + jm.top for t in layer]
    assert len(got["towers"]) == len(want)
    for g, w in zip(got["towers"], want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6)


def run_case(pool, kind, exchange, opt, cfg_kw=None, data_kw=None,
             step_kw=None, jax_kw=None, port_kw=None):
    jcfg, pcfg = cfgs(**(cfg_kw or {}))
    jopt, popt = opts(opt)
    jm = jax_model(jcfg, jopt)
    data = batches(**(data_kw or {}))
    step_kw = dict(exchange=exchange, **(step_kw or {}))
    if exchange == "a2a":
        step_kw.update(capacity_factor=1.0, with_overflow=True)
    got = pool.submit("dlrm_steps", AXES[kind], pcfg, model_arrays(jm),
                      popt, data, {**step_kw, **(port_kw or {})})
    losses, overflows, want = jax_steps(kind, jcfg, jopt, jm, data,
                                        **step_kw, **(jax_kw or {}))
    got = got()
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-5)
        assert g["overflows"] == overflows
    assert_model_close(got[0], want)
    return got, overflows


@pytest.mark.parametrize("exchange,opt", [
    ("gather", "sgd"), ("gather", "adagrad"), ("gather", "adam"),
    ("gather", "ftrl"), ("a2a", "sgd"), ("a2a", "adagrad"), ("a2a", "adam"),
    ("a2a", "ftrl")])
def test_sharded_step_matches_jax(pool, exchange, opt):
    _, overflows = run_case(pool, "1d", exchange, opt)
    if exchange == "a2a":
        assert sum(overflows) > 0       # the Zipf ids overflow at factor 1


@pytest.mark.parametrize("exchange,opt", [("gather", "adagrad"),
                                          ("a2a", "sgd")])
def test_sharded_step_on_the_2d_mesh_matches_jax(pool, exchange, opt):
    run_case(pool, "2d", exchange, opt)


@pytest.mark.parametrize("exchange,opt", [("gather", "adagrad"),
                                          ("a2a", "sgd")])
def test_sharded_step_with_padded_mean_bags_matches_jax(pool, exchange, opt):
    run_case(pool, "1d", exchange, opt,
             cfg_kw=dict(bag=3, combiner="mean", pad_idx=-1),
             data_kw=dict(bag=3, pad_idx=-1))


def test_sharded_microbatch_matches_jax(pool):
    run_case(pool, "1d", "gather", "sgd", step_kw=dict(microbatch=2))


def test_sharded_adam_towers_match_jax(pool):
    run_case(pool, "1d", "gather", "adagrad",
             jax_kw=dict(dense_tx=optax.adam(1e-2)),
             port_kw=dict(dense_tx=functools.partial(torch.optim.Adam,
                                                     lr=1e-2)))


def test_sharded_bf16_wire_step_matches_jax(pool):
    run_case(pool, "1d", "a2a", "sgd", jax_kw=dict(wire_dtype=jnp.bfloat16),
             port_kw=dict(wire_dtype=torch.bfloat16))


def test_what_jax_refuses_the_sharded_step_refuses():
    _, pcfg = cfgs()
    with pytest.raises(NotImplementedError, match="gather exchange only"):
        make_sharded_train_step(pcfg, None, exchange="a2a", microbatch=2)
    with pytest.raises(ValueError, match="wire_dtype"):
        make_sharded_train_step(pcfg, None, wire_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="supports"):
        make_sharded_train_step(pcfg, None, sparse_opt=object())


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_sharded_eval_matches_jax(pool, kind):
    jcfg, pcfg = cfgs()
    jm = jax_model(jcfg, opts("sgd")[0])
    dense, cat, _ = batches(1, seed=5)[0]
    mesh, axis = jax_mesh(kind), AXES[kind]
    sd, sc, _ = JP.batch_shardings(mesh, axis)
    want = JP.make_sharded_eval_step(jcfg, mesh, axis)(
        JP.shard_dlrm(jm, mesh, axis), jax.device_put(dense, sd),
        jax.device_put(cat, sc))
    for got in pool.run("dlrm_eval", axis, pcfg, model_arrays(jm), dense,
                        cat):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_unshard_dlrm_gives_back_the_model(pool):
    jcfg, pcfg = cfgs()
    jm = jax_model(jcfg, opts("adam")[0])
    got = pool.run("dlrm_steps", "data", pcfg, model_arrays(jm),
                   opts("adam")[1], [], {})
    for g in got:
        np.testing.assert_array_equal(g["tables"], np.asarray(jm.tables.data))
        for s, w in zip(g["state"], jm.emb_state):
            np.testing.assert_array_equal(s, np.asarray(w, np.float32))


# The telemetry phases of `test_train_dlrm_on_a_mesh_matches_jax`'s loop
# (4 steps, 2 evals) on every rank: each layer span once a step.
MESH_PHASES = {"data": 4, "step": 4, "eval": 2, **dict.fromkeys(
    ("step.lookup", "step.forward", "step.backward", "step.sparse_update",
     "step.dense_update", "update.sort", "update.permute", "update.scatter"),
    4)}
MESH_EXCHANGES = {
    # a step: the lookup's ids all-gather and reduce-scatter, the towers'
    # all-reduce, the update's ids and delta all-gathers and its owned
    # count; an eval: one all-gather and one reduce-scatter, then the
    # scores' all-gather
    "gather": {"update.owned_count": 4, "exchange.all_gather": 16,
               "exchange.reduce_scatter": 6, "exchange.all_reduce": 4},
    # the butterfly's all-to-alls, the towers' all-reduce and the overflow
    # counts' all-reduces; the tuner retunes once
    "a2a": {"retune": 1, "exchange.all_to_all": 16,
            "exchange.all_reduce": 12, "exchange.all_gather": 4,
            "exchange.reduce_scatter": 2}}


@pytest.mark.parametrize("exchange", ["gather", "a2a"])
def test_train_dlrm_on_a_mesh_matches_jax(pool, exchange):
    """Both loops on the same global batches; on the butterfly the capacity
    tuner starts at factor 0.5 and must retune at the same steps. Every
    rank opens the same telemetry phases, each collective its own."""
    jcfg, pcfg = cfgs()
    jopt, popt = opts("adagrad")
    jm = jax_model(jcfg, jopt)
    data = batches(4, seed=7)
    evals = [dict(dense=d, cat=c, label=l) for d, c, l in batches(1, seed=8)]
    kw = dict(exchange=exchange, dense_lr=0.1, log_every=1, eval_every=2,
              eval_batches=evals)
    if exchange == "a2a":
        kw.update(capacity_factor=0.5, auto_capacity=True)
    got = pool.submit("train_loop", "data", pcfg, model_arrays(jm), popt,
                      data, kw)
    res = JT.train_dlrm(jcfg, iter([dict(dense=d, cat=c, label=l)
                                    for d, c, l in data]), len(data),
                        sparse_opt=jopt, model=jm, mesh=jax_mesh("1d"),
                        axis="data", verbose=False, **kw)
    got = got()
    for g in got:
        np.testing.assert_allclose(g["losses"], res.losses, rtol=1e-5)
        assert [s for s, _ in g["aucs"]] == [s for s, _ in res.aucs]
        np.testing.assert_allclose([a for _, a in g["aucs"]],
                                   [a for _, a in res.aucs], atol=1e-6)
        assert g["phases"] == {**MESH_PHASES, **MESH_EXCHANGES[exchange]}
    assert_model_close(got[0], JP.unshard_dlrm(res.model))


def test_mesh_service_matches_jax_and_stops_the_followers(pool):
    """Divergence pin (ROADMAP.md queue 3): rank 0 serves, the other ranks
    follow each broadcast batch until rank 0's stop() releases them."""
    jcfg, pcfg = cfgs()
    jm = jax_model(jcfg, opts("sgd")[0])
    rng = np.random.default_rng(9)
    requests = []
    for size in (1, 3, 6, 2):
        requests.append((rng.standard_normal((size, 4)).astype(np.float32),
                         np.stack([rng.integers(0, v, size) for v in VOCABS])
                         .astype(np.int32)))
    got = pool.run("serve", "data", pcfg, model_arrays(jm), requests)
    mesh = jax_mesh("1d")
    svc = jax_service(JP.shard_dlrm(jm, mesh, "data"), mesh=mesh,
                      max_batch=16, max_latency_ms=2.0)
    try:
        want = [svc.predict(d, c, timeout=60) for d, c in requests]
    finally:
        svc.stop()
    for g, w in zip(got[0], want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert all(isinstance(b, int) and b >= 1 for b in got[1:])
    assert len(set(got[1:])) == 1


def test_quantized_mesh_service_raises_as_jax_does():
    _, pcfg = cfgs()
    model = ett.init_dlrm(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="single-chip"):
        ett.make_dlrm_service(model, mesh=object(), quantized=True)


def test_stochastic_rounding_draws_each_ranks_own_noise(pool):
    """Divergence pin (ROADMAP.md queue 3): each rank rounds with its own
    generator (`rank_generator(seed, rank)`), where JAX folds the shard
    index into one key; held by SR's properties on every rank."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((193, 8)).astype(np.float32)
    upd = dict(delta=rng.standard_normal((B, 8)).astype(np.float32) * 1e-3,
               indices=rng.integers(0, 193, B).astype(np.int32))
    for before, after, target in pool.run("sr_update", table, upd, 0.5):
        touched = target != before
        assert touched.any()
        np.testing.assert_array_equal(after[~touched], before[~touched])
        lo, hi = _bf16_neighbours(target)
        assert np.all((after == lo) | (after == hi))
    draws = {tuple(torch.randint(0, 2**16, (8,), generator=rank_generator(
        0, r, "cpu")).tolist()) for r in range(4)}
    assert len(draws) == 4


def _bf16_neighbours(x):
    """The bf16 values just below and above each f32 (equal when exact)."""
    b = x.view(np.uint32)
    toward_zero = b & np.uint32(0xFFFF0000)
    away = np.where(b & np.uint32(0xFFFF), toward_zero + np.uint32(0x10000),
                    toward_zero).astype(np.uint32)
    a, c = toward_zero.view(np.float32), away.view(np.float32)
    return np.minimum(a, c), np.maximum(a, c)


def test_init_sharded_dlrm_holds_only_its_shard(pool):
    _, pcfg = cfgs()
    out = pool.run("init_sharded", "data", pcfg, batches(1, seed=12))
    rows = -(-sum(VOCABS) // 4)
    assert all(o["rows"] == rows for o in out)
    assert len({o["first_row"] for o in out}) == 4
    assert all(np.isfinite(o["loss"]) for o in out)
    assert len({o["loss"] for o in out}) == 1
