"""The port's DLRM forward slice against the JAX package's, end to end.

A JAX `init_dlrm` model is carried into the port with `dlrm_from_arrays`
(weights, not seeds: the two packages' generators differ), and both
`dlrm_forward`s score the same numpy inputs on the CPU.

Tolerances: f32 towers agree up to matmul summation order (rtol/atol 1e-5).
bf16 towers: the two agree exactly at this size on the CPU, but XLA and
PyTorch are free to round bf16 matmuls and bias adds at different points
(2^-9 relative each), so the logits are held to 2^-7 of the largest logit:
a couple of bf16 roundings.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu.models import DLRMConfig as JaxConfig
from embeddingtables_tpu.models import init_dlrm as jax_init_dlrm
from embeddingtables_tpu.models.dlrm import _block_w1_perm as jax_w1_perm
from embeddingtables_tpu.models.dlrm import bce_loss as jax_bce_loss
from embeddingtables_tpu.models.dlrm import dlrm_forward as jax_forward
from embeddingtables_tpu.models.dlrm import dot_interaction as jax_dot
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.models import dlrm as P
from _torch_threads import _one_torch_thread  # noqa: F401


JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B = 16


def _pair(seed=0, compute_dtype="float32", table_dtype=None, jit=False,
          **kw):
    """(JAX model, the same weights as a port model on the CPU). `jit`:
    JAX's init as one compiled program (many tables: one compile instead
    of one per op and table)."""
    jcfg = JaxConfig(**kw, compute_dtype=JAX_DT[compute_dtype],
                     table_dtype=JAX_DT.get(table_dtype))
    pcfg = ett.DLRMConfig(**kw, compute_dtype=TORCH_DT[compute_dtype],
                          table_dtype=TORCH_DT.get(table_dtype))
    init = (jax.jit(jax_init_dlrm, static_argnums=1) if jit
            else jax_init_dlrm)
    jm = init(jax.random.key(seed), jcfg)

    def arrays(layers):
        return [(np.asarray(w), np.asarray(b)) for w, b in layers]

    pm = ett.dlrm_from_arrays(pcfg, arrays(jm.bottom), arrays(jm.top),
                              np.asarray(jm.tables.data), jm.tables.offsets,
                              device="cpu")
    return jm, pm


def _inputs(cfg, seed=1, pad_frac=0.0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((B, cfg.num_dense)).astype(np.float32)
    shape = (B,) if cfg.bag is None else (B, cfg.bag)
    cat = np.stack([rng.integers(0, v, shape) for v in cfg.vocab_sizes])
    cat = cat.astype(np.int32)
    if pad_frac:
        cat[rng.random(cat.shape) < pad_frac] = cfg.pad_idx
    return dense, cat


def _both(jm, pm, dense, cat, jit=False):
    forward = jax.jit(jax_forward) if jit else jax_forward
    want = np.asarray(forward(jm, jnp.asarray(dense), jnp.asarray(cat)))
    got = ett.dlrm_forward(pm, dense, cat)
    assert got.dtype == torch.float32 and got.shape == (B,)
    return got.detach().numpy(), want


SMALL = dict(vocab_sizes=(13, 29, 7, 21), num_dense=5, dim=8,
             bottom_mlp=(16, 8), top_mlp=(32, 16, 1))
MODES = {
    "onehot": {},
    "bag3_sum": dict(bag=3),
    "bag3_mean": dict(bag=3, combiner="mean"),
    "bag3_pad": dict(bag=3, combiner="mean", pad_idx=-1),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("interaction", ["dot", "cat"])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_forward_matches_jax_f32(self_interaction, interaction, mode):
    jm, pm = _pair(**SMALL, **MODES[mode], interaction=interaction,
                   self_interaction=self_interaction)
    dense, cat = _inputs(pm.config, pad_frac=0.3 if "pad" in mode else 0.0)
    got, want = _both(jm, pm, dense, cat)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_64_tables_take_the_index_fallback(self_interaction):
    # t1 = 65: t1^2 * pairs exceeds _SEL_MAX_ENTRIES, so both packages take
    # the canonical Gram with triangle indexing.
    kw = dict(vocab_sizes=(3,) * 64, num_dense=3, dim=4, bottom_mlp=(8, 4),
              top_mlp=(16, 1), self_interaction=self_interaction)
    t1 = 65
    pairs = t1 * (t1 + 1) // 2 if self_interaction else t1 * (t1 - 1) // 2
    assert t1 * t1 * pairs > P._SEL_MAX_ENTRIES
    jm, pm = _pair(jit=True, **kw)
    got, want = _both(jm, pm, *_inputs(pm.config), jit=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_towers_within_stated_tolerance():
    jm, pm = _pair(**SMALL, compute_dtype="bfloat16")
    got, want = _both(jm, pm, *_inputs(pm.config))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_bf16_tables_f32_towers():
    jm, pm = _pair(**SMALL, table_dtype="bfloat16")
    assert pm.tables.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pm.tables.data.float().numpy(),
        np.asarray(jm.tables.data).astype(np.float32))
    got, want = _both(jm, pm, *_inputs(pm.config))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_eval_step_matches_forward_without_autograd():
    jm, pm = _pair(**SMALL)
    dense, cat = _inputs(pm.config)
    out = ett.make_eval_step(pm.config)(pm, dense, cat)
    assert not out.requires_grad
    _, want = _both(jm, pm, dense, cat)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,offset,dim", [(4, -1, 8), (4, 0, 8),
                                          (26, -1, 128), (26, 0, 16)])
def test_block_w1_perm_matches_jax(t, offset, dim):
    np.testing.assert_array_equal(P._block_w1_perm(t, offset, dim),
                                  jax_w1_perm(t, offset, dim))


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_matches_jax(self_interaction):
    rng = np.random.default_rng(2)
    bot = rng.standard_normal((B, 8)).astype(np.float32)
    emb = rng.standard_normal((B, 5, 8)).astype(np.float32)
    want = np.asarray(jax_dot(jnp.asarray(bot), jnp.asarray(emb),
                              self_interaction))
    got = P.dot_interaction(torch.from_numpy(bot), torch.from_numpy(emb),
                            self_interaction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bce_loss_matches_jax():
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(64) * 5).astype(np.float32)
    y = (rng.random(64) < 0.5).astype(np.float32)
    want = float(jax_bce_loss(jnp.asarray(z), jnp.asarray(y)))
    got = float(P.bce_loss(torch.from_numpy(z), torch.from_numpy(y)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_init_dlrm_shapes_and_generator():
    cfg = ett.DLRMConfig(**SMALL, table_dtype=torch.bfloat16)

    def make(seed):
        return ett.init_dlrm(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")

    a, b, c = make(0), make(0), make(1)
    assert [tuple(w.shape) for w, _ in a.bottom] == [(5, 16), (16, 8)]
    assert [tuple(w.shape) for w, _ in a.top] == \
        [(cfg.interaction_features, 32), (32, 16), (16, 1)]
    assert a.tables.data.shape == (sum(SMALL["vocab_sizes"]), 8)
    assert a.tables.data.dtype == torch.bfloat16
    assert a.tables.offsets == (0, 13, 42, 49, 70)
    assert a.tables.data.float().abs().max() <= 8 ** -0.5
    assert torch.equal(a.tables.data, b.tables.data)
    assert not torch.equal(a.tables.data, c.tables.data)
    assert all((bb == 0).all() for _, bb in a.top)
