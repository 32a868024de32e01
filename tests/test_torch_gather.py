"""The port's gathers (`embeddingtables_tpu_torch/ops/cuda/gather.py`) against
the JAX Pallas gathers they replace.

On the CPU the wrappers run their plain PyTorch versions; the JAX kernels run
in Pallas interpret mode, as tests/test_lookup.py runs them. Inputs are made
with numpy from a seed and handed to both. The hand-written CUDA kernels are
held against the plain versions by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embeddingtables_tpu.ops.pallas.gather import gather_bags as jax_gather_bags
from embeddingtables_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from embeddingtables_tpu_torch.interop import tensor_from_array
from embeddingtables_tpu_torch.ops.cuda import gather as G
from _torch_threads import _one_torch_thread  # noqa: F401


V = 96
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _table(rng, d, dtype):
    """(numpy table as JAX holds it, the same table as a torch tensor)."""
    base = rng.standard_normal((V, d)).astype(np.float32)
    arr = np.asarray(jnp.asarray(base, DTYPES[dtype]))
    return arr, tensor_from_array(arr, "cpu")


def _np(t):
    return t.float().numpy()


def _bf16_bag_bound(rows_abs_sum, bag):
    """Largest |difference| between an f32-accumulated bag sum rounded once to
    bf16 (the port) and a sum rounded to bf16 after every add (the Pallas
    kernel, gather.py:233): bag roundings of at most half a bf16 ulp (2^-9
    relative) of a partial sum bounded by sum_k |row_k|, with margin 2x."""
    return bag * 2.0 ** -8 * rows_abs_sum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("n", [1, 13])
def test_gather_rows_matches_pallas(dtype, d, n):
    rng = np.random.default_rng(n * 1000 + d)
    arr, tab = _table(rng, d, dtype)
    idx = rng.integers(0, V, n).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(arr), jnp.asarray(idx),
                                      interpret=True))
    got = G.gather_rows(tab, torch.from_numpy(idx))
    assert got.dtype == tab.dtype and got.shape == (n, d)
    # A gather moves bits: exact in both dtypes.
    np.testing.assert_array_equal(_np(got), want.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("bag", [1, 2, 4])
def test_gather_bags_matches_pallas(dtype, d, bag):
    rng = np.random.default_rng(bag * 1000 + d)
    arr, tab = _table(rng, d, dtype)
    n = 6
    idx = rng.integers(0, V, (n, bag)).astype(np.int32)
    want = np.asarray(jax_gather_bags(jnp.asarray(arr), jnp.asarray(idx),
                                      interpret=True)).astype(np.float32)
    got = G.gather_bags(tab, torch.from_numpy(idx))
    assert got.dtype == tab.dtype and got.shape == (n, d)
    if dtype == "float32":
        # Both sum in f32 in bag order: exact.
        np.testing.assert_array_equal(_np(got), want)
    else:
        abs_sum = np.abs(arr.astype(np.float32)[idx]).sum(axis=1)
        assert (np.abs(_np(got) - want)
                <= _bf16_bag_bound(abs_sum, bag)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_bags_sums_in_f32_and_rounds_once(dtype):
    rng = np.random.default_rng(7)
    arr, tab = _table(rng, 64, dtype)
    idx = rng.integers(0, V, (20, 4)).astype(np.int32)
    acc = np.zeros((20, 64), np.float32)
    for k in range(4):
        acc += arr.astype(np.float32)[idx[:, k]]
    want = torch.from_numpy(acc).to(tab.dtype)
    got = G.gather_bags(tab, torch.from_numpy(idx))
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["rows", "bags"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_of_range_ids_wrap_or_nan(which, dtype):
    # [-V, 0) wraps to id + V; anything else gives NaN (jnp.take's fill).
    rng = np.random.default_rng(3)
    arr, tab = _table(rng, 16, dtype)
    ids = np.array([0, -1, -V, -V - 1, V, V + 5, 2**31 - 1, -2**31, 5],
                   np.int32)
    if which == "rows":
        got = _np(G.gather_rows(tab, torch.from_numpy(ids)))
        want = np.asarray(jnp.take(jnp.asarray(arr), jnp.asarray(ids),
                                   axis=0)).astype(np.float32)
    else:
        bags = np.stack([ids, np.full_like(ids, 3)], axis=1)
        got = _np(G.gather_bags(tab, torch.from_numpy(bags)))
        want = np.asarray(jnp.take(jnp.asarray(arr), jnp.asarray(bags),
                                   axis=0).astype(jnp.float32).sum(axis=1))
    assert np.isnan(got[3:8]).all() and not np.isnan(got[[0, 1, 2, 8]]).any()
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == "float32"
                               else 2 ** -7)


def test_nan_rows_carry_the_canonical_nan_bits():
    tab = torch.zeros((4, 3))
    out = G.gather_rows(tab, torch.tensor([9], dtype=torch.int32))
    assert (out.view(torch.int32) == 0x7FC00000).all()
    out = G.gather_rows(tab.to(torch.bfloat16),
                        torch.tensor([9], dtype=torch.int32))
    assert (out.view(torch.int16) == 0x7FC0).all()


@pytest.mark.parametrize("case", ["int64_ids", "f16_table", "3d_table",
                                  "2d_ids_rows", "1d_ids_bags",
                                  "noncontig_table", "noncontig_ids"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    tab = torch.zeros((8, 4))
    ids = torch.zeros(3, dtype=torch.int32)
    fn = G.gather_rows
    if case == "int64_ids":
        ids = ids.long()
    elif case == "f16_table":
        tab = tab.half()
    elif case == "3d_table":
        tab = tab[None]
    elif case == "2d_ids_rows":
        ids = ids[None]
    elif case == "1d_ids_bags":
        fn = G.gather_bags
    elif case == "noncontig_table":
        tab = torch.zeros((4, 8)).t()
    elif case == "noncontig_ids":
        ids = torch.zeros(6, dtype=torch.int32)[::2]
    with pytest.raises((TypeError, ValueError)):
        fn(tab, ids)


def test_cpu_path_does_not_count_launches():
    before = (G.gather_rows.launches, G.gather_bags.launches)
    G.gather_rows(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int32))
    G.gather_bags(torch.zeros((4, 2)), torch.zeros((3, 2), dtype=torch.int32))
    assert (G.gather_rows.launches, G.gather_bags.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 129])
@pytest.mark.parametrize("kind", ["gather_rows", "gather_bags", "lookup_rows",
                                  "lookup_bags"])
def test_odd_widths_match_jax_lookup(kind, d, dtype):
    # The port's odd widths (DeepFM's first-order D = 1 and fused
    # D + 1 = 129) against JAX's lookup on the same numpy inputs, special
    # ids included. JAX takes its non-Pallas path here (jnp.take; the
    # Pallas gathers need D % 128 == 0); the card holds the kernels to these
    # plain versions. Rows move bits: exact. Bags: f32 sums in bag order,
    # one rounding; XLA widens bf16 sums to f32 too, so within one bf16
    # rounding (2^-8 relative, and absolute below 1).
    import jax
    import embeddingtables_tpu as et
    import embeddingtables_tpu_torch as ett
    rng = np.random.default_rng(10 * d + len(kind))
    arr, tab = _table(rng, d, dtype)
    bags = kind.endswith("bags")
    idx = rng.integers(-V, V, (12, 4) if bags else (12,)).astype(np.int32)
    bad = np.array([-V - 1, V, 2**31 - 1, -2**31], np.int32)
    (idx[:4, 1] if bags else idx[:4])[:] = bad
    want = np.asarray(jax.jit(lambda t, i: et.lookup(t, i, combiner="sum"))(
        jnp.asarray(arr), jnp.asarray(idx))).astype(np.float32)
    ids = torch.from_numpy(idx)
    if kind == "gather_rows":
        got = G.gather_rows_plain(tab, ids)
    elif kind == "gather_bags":
        got = G.gather_bags_plain(tab, ids)
    else:
        got = ett.lookup(ett.SimpleEmbedding(tab), ids, combiner="sum")
    assert got.shape == (12, d) and got.dtype == tab.dtype
    assert np.isnan(want[:4]).all() and not np.isnan(want[4:]).any()
    if not bags or dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-6 if bags else 0,
                                   atol=0)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -8, atol=2 ** -8)
