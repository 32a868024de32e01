"""The port's host-offloaded and tiered tables against the JAX package's, on
the CPU.

The JAX tables live in `pinned_host` memory, which JAX's CPU backend here
provides (its own `tests/test_offload.py` and `tests/test_tiered.py` run
rather than skip), so both packages run on the same numpy inputs: lookups,
including ids outside `[0, V)` (each table clamps them, its own contract),
updates with duplicates across tiers, `materialize`, `hot_fraction` and
`retier`. The port is also held to `lookup_oracle` on the clamped ids, which
does not need JAX's pinned memory. On the CPU the port's tables keep plain
host tensors (`device="cpu"`): pinning needs a card. Rows are copies, so
lookups are bitwise; updates agree up to the order of f32 sums (rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import embeddingtables_tpu as et
from embeddingtables_tpu.offload import HostOffloadEmbedding as JOffload
from embeddingtables_tpu.tiered import TieredEmbedding as JTiered
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.offload import host_put
from embeddingtables_tpu_torch.utils.rowstats import (FrequencyTracker,
                                                      inverse_permutation)
from _torch_threads import _one_torch_thread  # noqa: F401

V, D = 60, 8


def _data(seed=0):
    return np.random.default_rng(seed).standard_normal((V, D)).astype(
        np.float32)


IDS = np.array([3, V - 1, 3, 17, -1, V, V + 40, 0], np.int32)
BAGS = np.array([[1, 59], [31, 2], [-5, 70]], np.int32)


def _oracle(data, ids):
    clamped = np.clip(ids, 0, V - 1)
    return ett.lookup_oracle(torch.from_numpy(data), torch.from_numpy(clamped))


def _tables(kind, data):
    if kind == "offload":
        return JOffload(jnp.asarray(data)), ett.HostOffloadEmbedding(
            data, device="cpu")
    jt = JTiered.from_array(jnp.asarray(data), 20)
    return jt, ett.TieredEmbedding.from_array(data, 20, device="cpu")


@pytest.mark.parametrize("kind", ["offload", "tiered"])
def test_lookup_matches_jax_and_the_oracle_on_clamped_ids(kind):
    data = _data()
    jt, pt = _tables(kind, data)
    assert pt.shape == (V, D) and pt.example().device.type == "cpu"
    got = ett.lookup(pt, torch.from_numpy(IDS))
    np.testing.assert_array_equal(got.numpy(), _oracle(data, IDS).numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(et.lookup(jt, jnp.asarray(IDS))))
    bags = ett.lookup(pt, torch.from_numpy(BAGS))
    np.testing.assert_allclose(bags.numpy(),
                               np.asarray(et.lookup(jt, jnp.asarray(BAGS))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pt.materialize().numpy(), data)
    # The port's tables hold copies: the caller's array is not aliased.
    pt.scatter_apply(torch.tensor([1]), torch.ones((1, D)))
    np.testing.assert_array_equal(data, _data())


@pytest.mark.parametrize("kind", ["offload", "tiered"])
def test_updates_accumulate_duplicates_as_jax_does(kind):
    data = _data(1)
    jt, pt = _tables(kind, data)
    delta = np.random.default_rng(2).standard_normal(
        (IDS.size, D)).astype(np.float32)
    jt2 = jt.scatter_apply(jnp.asarray(IDS), jnp.asarray(delta))
    assert pt.scatter_apply(torch.from_numpy(IDS),
                            torch.from_numpy(delta)) is pt
    np.testing.assert_allclose(pt.materialize().numpy(),
                               np.asarray(jt2.materialize()), rtol=1e-6,
                               atol=1e-6)
    # Through the lazy protocol path: lookup_vjp, then sgd_update.
    idx = torch.tensor([7, 7, 45, 9, 45, 45], dtype=torch.int32)
    before = pt.materialize().clone()
    out, pull = ett.lookup_vjp(pt, idx)
    ett.sgd_update(pt, pull(torch.ones_like(out)), 1.0)
    diff = (pt.materialize() - before).numpy()
    np.testing.assert_allclose(diff[[7, 45, 9, 0]][:, 0], [-2, -3, -1, 0],
                               atol=1e-6)
    zeros = pt.zeros_like()
    assert not zeros.materialize().any() and pt.materialize().any()


def test_tiered_from_jax_tiers_and_retier_match_jax():
    data = _data(3)
    jt = JTiered.from_array(jnp.asarray(data), 8)
    pt = ett.tiered_from_arrays(np.asarray(jt.hot), np.asarray(jt.cold),
                                device="cpu")
    assert pt.hot_rows == jt.hot_rows and pt.spec.vocab == V
    np.testing.assert_array_equal(pt.materialize().numpy(), data)
    stream = np.random.default_rng(4).choice(
        np.arange(V - 10, V), size=400).astype(np.int32)
    assert pt.hot_fraction(stream) == jt.hot_fraction(stream) == 0.0
    tracker = FrequencyTracker(V)
    tracker.observe(stream)
    perm = tracker.frequency_permutation()
    jt2, pt2 = jt.retier(perm, hot_rows=16), pt.retier(perm, hot_rows=16)
    assert pt2.hot_rows == 16 and pt2.hot.shape == (16, D)
    np.testing.assert_array_equal(pt2.materialize().numpy(),
                                  np.asarray(jt2.materialize()))
    inv = inverse_permutation(perm)
    assert pt2.hot_fraction(torch.from_numpy(inv[stream])) == 1.0
    np.testing.assert_array_equal(
        ett.lookup(pt2, torch.from_numpy(inv[stream[:32]])).numpy(),
        ett.lookup(pt, torch.from_numpy(stream[:32])).numpy())


def test_tiered_errors_match_jax():
    for h in (0, V):
        with pytest.raises(ValueError, match="hot_rows"):
            ett.TieredEmbedding.from_array(_data(), h, device="cpu")
    t = ett.TieredEmbedding.from_array(_data(), 5, device="cpu")
    with pytest.raises(ValueError, match="perm"):
        t.retier(np.arange(7))
    with pytest.raises(ValueError, match="hot_rows"):
        t.retier(np.arange(V), hot_rows=V)


def test_create_and_host_put_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    t = ett.TieredEmbedding.create(g, 40, 8, 10, device="cpu")
    assert t.hot.shape == (10, 8) and t.cold.shape == (30, 8)
    assert 0.2 < float(t.materialize().std()) < 0.5
    x = torch.ones(3, 2)
    y = host_put(x, device="cpu")
    assert y.device.type == "cpu" and y.data_ptr() != x.data_ptr()
    assert host_put(np.zeros((2, 2)), device="cpu").dtype == torch.float32
