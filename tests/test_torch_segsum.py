"""The port's `hot_accumulate` and `_dense_grad` against the JAX package's, on
the same numpy inputs on the CPU (the Pallas kernel in interpret mode, as
`tests/test_segsum.py` runs it).

Tolerances: both sides round each value to bf16 in bf16 mode (or not at all
in f32 mode) and accumulate in f32, in different orders (a one-hot matmul
there, `index_add_` here). The error is f32 rounding of the summed
magnitude, so it is held against sum(|vals|) per segment: 1e-5 of it. The
bf16 scratch of `_dense_grad` rounds every partial sum to bf16 on both sides,
in possibly different orders: 2^-6 of the summed magnitude.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embeddingtables_tpu.ops.pallas.segsum import \
    hot_accumulate as pallas_hot_accumulate
from embeddingtables_tpu.optim import _dense_grad as jax_dense_grad
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.ops.cuda import segsum as H
from _torch_threads import _one_torch_thread  # noqa: F401


COMPUTE = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float32": (jnp.float32, torch.float32)}


def _stream(seed, n, h, d=128):
    rng = np.random.default_rng(seed)
    # In range, out of range on both sides, heavy duplication.
    rows = rng.integers(-h // 4, 2 * h, n).astype(np.int32)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    return rows, vals


def _magnitude(rows, vals, h):
    out = np.zeros((h, vals.shape[1]))
    ok = (rows >= 0) & (rows < h)
    np.add.at(out, rows[ok], np.abs(vals[ok]))
    return out


@pytest.mark.parametrize("compute", sorted(COMPUTE))
@pytest.mark.parametrize("h", [128, 512])
def test_plain_hot_accumulate_matches_pallas_kernel(compute, h):
    rows, vals = _stream(h, 1000, h)
    jdt, tdt = COMPUTE[compute]
    want = np.asarray(pallas_hot_accumulate(
        jnp.asarray(rows), jnp.asarray(vals), h, compute_dtype=jdt,
        interpret=True))
    got = H.hot_accumulate(torch.from_numpy(rows), torch.from_numpy(vals), h,
                           compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (h, 128)
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-5 * _magnitude(rows, vals, h) + 1e-6).all(), err.max()


def test_duplication_and_empty_segments():
    rows = torch.tensor([0] * 50 + [3] * 20 + [127] * 5 + [500] * 10 + [-1],
                        dtype=torch.int32)
    got = H.hot_accumulate(rows, torch.ones((86, 128)), 128,
                           compute_dtype=torch.float32)
    want = torch.zeros((128, 128))
    want[0], want[3], want[127] = 50.0, 20.0, 5.0   # 500 and -1 dropped
    assert torch.equal(got, want)


def test_validation_messages_match_jax():
    with pytest.raises(ValueError, match="feature dim 64 must be a multiple of 128"):
        H.hot_accumulate(torch.zeros(8, dtype=torch.int32),
                         torch.zeros((8, 64)), 128)
    with pytest.raises(ValueError, match="num_segments 100 must be a multiple of 128"):
        H.hot_accumulate(torch.zeros(8, dtype=torch.int32),
                         torch.zeros((8, 128)), 100)


def test_empty_stream_returns_zeros():
    got = H.hot_accumulate(torch.zeros(0, dtype=torch.int32),
                           torch.zeros((0, 128)), 256)
    assert torch.equal(got, torch.zeros((256, 128)))


# `_dense_grad`'s two branches: hot_accumulate at <= 512 padded rows (ids
# outside [0, vpad) dropped, ids in [V, vpad) cut off with the pad rows) and
# the scratch scatter above it ([-V, 0) wraps, the rest dropped).
@pytest.mark.parametrize("v,grad_dtype", [(300, None), (512, None),
                                          (513, None), (900, "bfloat16")])
def test_dense_grad_matches_jax(v, grad_dtype):
    rng = np.random.default_rng(v)
    n = 400
    rows = rng.integers(-v - 3, v + 40, n).astype(np.int32)
    g = rng.standard_normal((n, 128)).astype(np.float32)
    data = np.zeros((v, 128), np.float32)
    want = np.asarray(jax_dense_grad(jnp.asarray(data), jnp.asarray(rows),
                                     jnp.asarray(g), grad_dtype))
    before = H.hot_accumulate.launches
    got = P._dense_grad(torch.from_numpy(data), torch.from_numpy(rows),
                        torch.from_numpy(g), grad_dtype).numpy()
    assert H.hot_accumulate.launches == before      # CPU: the plain version
    assert got.dtype == np.float32 and got.shape == (v, 128)
    wrapped = np.where(rows < 0, rows + v, rows)
    mag = np.zeros((v + 1, 128))
    np.add.at(mag, np.where((wrapped >= 0) & (wrapped < v), wrapped, v),
              np.abs(g))
    rel = 1e-5 if grad_dtype is None else 2 ** -6
    assert (np.abs(got - want) <= rel * mag[:v] + 1e-6).all()


def test_dense_grad_refuses_an_integer_scratch():
    with pytest.raises(ValueError, match="floating dtype"):
        P._dense_grad(torch.zeros((1000, 8)), torch.zeros(3, dtype=torch.int32),
                      torch.ones((3, 8)), "int32")
