"""The port's ensemble lookup (`maplookup`, `maplookup_vjp`, the execution
strategies, `Slicer` and the `StackedTables` path) against the JAX
package's, on the same numpy tables and ids on the CPU; mirrors
`tests/test_map.py`.

Tolerance: rtol/atol 1e-6. Both sides gather the same f32 rows and sum a
bag of three in the same order; a mean divides once.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import embeddingtables_tpu as et
import embeddingtables_tpu_torch as ett
from _torch_threads import _one_torch_thread  # noqa: F401


T, V, B, BAG, DIM = 3, 60, 12, 3, 16
TOL = dict(rtol=1e-6, atol=1e-6)
STRATEGIES = {"default": (et.DefaultStrategy(), ett.DefaultStrategy()),
              "parallel": (et.SimpleParallelStrategy(),
                           ett.SimpleParallelStrategy()),
              "prealloc": (et.PreallocationStrategy(5),
                           ett.PreallocationStrategy(5))}


def _tables(rng, dims=(DIM,) * T):
    arrs = [rng.standard_normal((V, d)).astype(np.float32) for d in dims]
    return ([et.SimpleEmbedding(jnp.asarray(a)) for a in arrs],
            [ett.SimpleEmbedding(torch.from_numpy(a.copy())) for a in arrs])


def _ids(rng, container, pad):
    """(JAX container, port container, per-table numpy ids)."""
    shape = (B,) if container in ("list_vec", "array2d") else (B, BAG)
    ids = [rng.integers(0, V, shape).astype(np.int32) for _ in range(T)]
    if pad:
        for i in ids:
            i[rng.random(shape) < 0.3] = -1
    if container.startswith("list"):
        return ([jnp.asarray(i) for i in ids],
                [torch.from_numpy(i) for i in ids], ids)
    stacked = np.stack(ids)
    return jnp.asarray(stacked), torch.from_numpy(stacked), ids


def _weights(rng, container, ids):
    w = [rng.uniform(0.5, 1.5, i.shape).astype(np.float32) for i in ids]
    if container == "array3d":
        return jnp.asarray(np.stack(w)), torch.from_numpy(np.stack(w))
    return [jnp.asarray(x) for x in w], [torch.from_numpy(x) for x in w]


def _check(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    else:
        assert torch.is_tensor(got) and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32), **TOL)


@pytest.mark.parametrize("extra", ["plain", "weights", "pad"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("container",
                         ["list_vec", "list_mat", "array2d", "array3d"])
def test_maplookup_matches_jax(container, combiner, extra):
    rng = np.random.default_rng(len(container) + len(combiner) + len(extra))
    jt, pt = _tables(rng)
    jidx, pidx, ids = _ids(rng, container, extra == "pad")
    jw = pw = None
    if extra == "weights":
        jw, pw = _weights(rng, container, ids)
    kw = dict(combiner=combiner, pad_idx=-1 if extra == "pad" else None)
    for name, (js, ps) in STRATEGIES.items():
        _check(ett.maplookup(ps, pt, pidx, weights=pw, **kw),
               et.maplookup(js, jt, jidx, weights=jw, **kw))
    # The StackedTables path: one gather for the ensemble.
    jst, pst = et.StackedTables.stack(jt), ett.StackedTables.stack(pt)
    for name, (js, ps) in STRATEGIES.items():
        _check(ett.maplookup(ps, pst, pidx, weights=pw, **kw),
               et.maplookup(js, jst, jidx, weights=jw, **kw))


def test_maplookup_without_strategy_and_prepend_zeros():
    rng = np.random.default_rng(1)
    jt, pt = _tables(rng, dims=(16, 24, 8))
    jidx, pidx, _ = _ids(rng, "list_vec", False)
    _check(ett.maplookup(pt, pidx), et.maplookup(jt, jidx))
    fused = ett.maplookup(ett.PreallocationStrategy(20), pt, pidx)
    assert tuple(fused.shape) == (B, 20 + 48)
    assert torch.equal(fused[:, :20], torch.zeros((B, 20)))
    assert torch.equal(fused[:, 20:], torch.cat(ett.maplookup(pt, pidx), -1))


def test_preallocation_casts_after_the_gather():
    rng = np.random.default_rng(3)
    jt, pt = _tables(rng, dims=(16, 16, 16))
    jidx, pidx, _ = _ids(rng, "array2d", False)
    want = et.maplookup(et.PreallocationStrategy(4, jnp.bfloat16), jt, jidx)
    for tables in (pt, ett.StackedTables.stack(pt)):
        got = ett.maplookup(ett.PreallocationStrategy(4, torch.bfloat16),
                            tables, pidx)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_maplookup_vjp_pullbacks_match_jax(strategy, combiner):
    rng = np.random.default_rng(4 + len(strategy))
    jt, pt = _tables(rng, dims=(16, 24, 8))
    jidx, pidx, ids = _ids(rng, "list_mat", True)
    jw, pw = _weights(rng, "list_mat", ids)
    js, ps = STRATEGIES[strategy]
    kw = dict(combiner=combiner, pad_idx=-1)
    jout, jpull = et.maplookup_vjp(js, jt, jidx, weights=jw, **kw)
    pout, ppull = ett.maplookup_vjp(ps, pt, pidx, weights=pw, **kw)
    _check(pout, jout)
    if strategy == "prealloc":
        delta = rng.standard_normal(tuple(pout.shape)).astype(np.float32)
        jupds, pupds = jpull(jnp.asarray(delta)), ppull(torch.from_numpy(delta))
        off = 5                              # the Slicer starts at prependrows
        for u, d in zip(pupds, (16, 24, 8)):
            assert torch.equal(u.delta, torch.from_numpy(delta[:, off:off + d]))
            off += d
    else:
        deltas = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
                  for o in pout]
        jupds = jpull([jnp.asarray(d) for d in deltas])
        pupds = ppull([torch.from_numpy(d) for d in deltas])
    assert len(pupds) == len(jupds) == 3
    for p, j in zip(pupds, jupds):
        np.testing.assert_array_equal(p.delta.numpy(), np.asarray(j.delta))
        np.testing.assert_array_equal(p.indices.numpy(), np.asarray(j.indices))
        np.testing.assert_allclose(p.weights.numpy(), np.asarray(j.weights),
                                   **TOL)


def test_slicer_carves_in_steps():
    arr = torch.arange(20).reshape(2, 10)
    s = ett.Slicer(2)
    assert torch.equal(s(3, arr), arr[:, 2:5])
    assert torch.equal(s(4, arr), arr[:, 5:9]) and s.offset == 9


def test_stacked_maplookup_vjp_captures_local_ids():
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((V, DIM)).astype(np.float32) for _ in range(T)]
    jst = et.StackedTables.stack([et.SimpleEmbedding(jnp.asarray(a))
                                  for a in arrs])
    pst = ett.StackedTables.stack([torch.from_numpy(a.copy()) for a in arrs])
    ids = rng.integers(0, V, (T, B, BAG)).astype(np.int32)
    ids[0, 0, 0] = 7                     # a pad id is a real row elsewhere
    kw = dict(combiner="mean", pad_idx=7)
    jout, jpull = et.maplookup_vjp(et.PreallocationStrategy(2), jst,
                                   jnp.asarray(ids), **kw)
    pout, ppull = ett.maplookup_vjp(ett.PreallocationStrategy(2), pst,
                                    torch.from_numpy(ids), **kw)
    _check(pout, jout)
    delta = rng.standard_normal(tuple(pout.shape)).astype(np.float32)
    for p, j in zip(ppull(torch.from_numpy(delta)), jpull(jnp.asarray(delta))):
        np.testing.assert_array_equal(p.delta.numpy(), np.asarray(j.delta))
        np.testing.assert_array_equal(p.indices.numpy(), np.asarray(j.indices))
        np.testing.assert_allclose(p.weights.numpy(), np.asarray(j.weights),
                                   **TOL)


def test_maplookup_mixed_table_types():
    rng = np.random.default_rng(77)
    arrs = [rng.standard_normal((V, DIM)).astype(np.float32) for _ in range(3)]
    jt = [et.SimpleEmbedding(jnp.asarray(arrs[0])),
          et.SplitEmbedding(arrs[1], 20), jnp.asarray(arrs[2])]
    pt = [ett.SimpleEmbedding(torch.from_numpy(arrs[0].copy())),
          ett.SplitEmbedding(torch.from_numpy(arrs[1].copy()), 20),
          torch.from_numpy(arrs[2].copy())]
    jidx, pidx, _ = _ids(rng, "list_vec", False)
    for js, ps in STRATEGIES.values():
        _check(ett.maplookup(ps, pt, pidx), et.maplookup(js, jt, jidx))


def test_containers_are_checked():
    _, pt = _tables(np.random.default_rng(0))
    with pytest.raises(ValueError, match="index sets"):
        ett.maplookup(pt, [torch.zeros(4, dtype=torch.int32)])
    with pytest.raises(ValueError, match="leading dim"):
        ett.maplookup(pt, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="weights array"):
        ett.maplookup(pt, torch.zeros((3, 4, 2), dtype=torch.int32),
                      weights=torch.ones((3, 4)))
