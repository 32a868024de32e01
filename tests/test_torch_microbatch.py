"""The port's `microbatch=k` train steps against the JAX package's, on the
CPU: one k = 4 step of DLRM (SGD and row-wise AdaGrad, one-hot and bags of
4), DCN-v2 and DeepFM (unfolded with `use_fm` on and off, and folded) from
one state, with f32 towers; `microbatch` at None, 0 and 1 is bitwise the
monolithic step; k = 4 against k = 1 on the same batch.

Tolerances: one step with f32 towers agrees up to the order of f32 sums
(matmuls, the run-scatter against XLA's scatter): rtol 1e-5, atol 1e-6.
k = 4 against k = 1 moves each tensor by the same update up to that
re-association: the difference stays within 1e-5 of the largest update
plus two f32 roundings of the largest value (a re-associated update may
round the stored value one ulp the other way).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embeddingtables_tpu.models import dcn as JD
from embeddingtables_tpu.models import deepfm as JF
from embeddingtables_tpu.models import dlrm as JM
from embeddingtables_tpu_torch.models import dcn as PD
from embeddingtables_tpu_torch.models import deepfm as PF
from embeddingtables_tpu_torch.models import dlrm as PM
from embeddingtables_tpu_torch.models.microbatch import microbatch_grads
from _torch_persist import B, VOCABS, pair
from _torch_threads import _one_torch_thread  # noqa: F401

K = 4
TOL = dict(rtol=1e-5, atol=1e-6)
MODULES = {"dlrm": (JM, PM), "dcn": (JD, PD), "deepfm": (JF, PF),
           "deepfm_folded": (JF, PF)}

CASES = {
    # name: (family, sparse optimizer, config overrides)
    "dlrm_sgd_onehot": ("dlrm", "sgd", {}),
    "dlrm_adagrad_onehot": ("dlrm", "adagrad", {}),
    "dlrm_sgd_bag4": ("dlrm", "sgd", dict(bag=4)),
    "dlrm_adagrad_bag4": ("dlrm", "adagrad", dict(bag=4)),
    "dcn_adagrad": ("dcn", "adagrad", {}),
    "deepfm_unfolded_fm": ("deepfm", "adagrad", {}),
    "deepfm_unfolded_no_fm": ("deepfm", "sgd", dict(use_fm=False)),
    "deepfm_folded": ("deepfm_folded", "adagrad", {}),
}


def _batch(rng, bag=None):
    dense = rng.standard_normal((B, 3)).astype(np.float32)
    shape = (B,) if bag is None else (B, bag)
    cat = np.stack([rng.integers(0, v, shape) for v in VOCABS])
    label = rng.integers(0, 2, B).astype(np.float32)
    return dense, cat.astype(np.int32), label


def _state_items(model):
    """Every table, row state and tower tensor of a port model, by name."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _jax_leaves(jm, family):
    """The JAX model's tables, states and towers, by the port's names."""
    out = {"tables.data": jm.tables.data}
    for i, leaf in enumerate(jm.emb_state):
        out[f"emb_{jm.emb_state._fields[i]}"] = leaf
    if family == "dlrm":
        towers = {"bottom_params": jm.bottom, "top_params": jm.top}
    elif family == "dcn":
        towers = {"cross_params": jm.cross, "deep_params": jm.deep,
                  "head_params": [jm.head]}
    else:
        towers = {"deep_params": jm.deep, "head_params": [jm.head]}
        out["dense_w"], out["bias"] = jm.dense_w, jm.bias
        if jm.fm_w is not None:
            out["fm_w.data"] = jm.fm_w.data
            for i, leaf in enumerate(jm.fm_state):
                out[f"fm_{jm.fm_state._fields[i]}"] = leaf
    for name, layers in towers.items():
        flat = [t for layer in layers for t in layer]
        for i, t in enumerate(flat):
            out[f"{name}.{i}"] = t
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_microbatch_step_matches_jax(case):
    family, opt, kw = CASES[case]
    (jcfg, jopt, jm), (pcfg, popt, pm) = pair(family, opt, **kw)
    jmod, pmod = MODULES[family]
    dense, cat, label = _batch(np.random.default_rng(3), kw.get("bag"))
    jm, jloss = jmod.make_train_step(jcfg, sparse_opt=jopt, dense_lr=0.05,
                                     microbatch=K)(
        jm, jnp.asarray(dense), jnp.asarray(cat), jnp.asarray(label))
    ploss = pmod.make_train_step(pcfg, sparse_opt=popt, dense_lr=0.05,
                                 microbatch=K)(pm, dense, cat, label)
    np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    got = dict(pm.named_parameters())
    got.update(pm.named_buffers())
    want = _jax_leaves(jm, family)
    for name, w in want.items():
        g = got[name]
        if g.numel() == 0:
            continue
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("k", [None, 0, 1])
def test_microbatch_off_is_bitwise_the_monolithic_step(k):
    _, (pcfg, popt, pm) = pair("dlrm", "adagrad", bag=4)
    ref = pair("dlrm", "adagrad", bag=4)[1][2]
    batch = _batch(np.random.default_rng(4), 4)
    loss = PM.make_train_step(pcfg, sparse_opt=popt, microbatch=k)(pm, *batch)
    want = PM.make_train_step(pcfg, sparse_opt=popt)(ref, *batch)
    assert torch.equal(loss, want)
    for (name, a), (_, b) in zip(_state_items(pm).items(),
                                 _state_items(ref).items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("family", ["dlrm", "deepfm"])
def test_microbatch_of_4_moves_the_tables_as_one_batch_does(family):
    _, (pcfg, popt, pm) = pair(family, "sgd")
    one = pair(family, "sgd")[1][2]
    start = _state_items(pm)
    batch = _batch(np.random.default_rng(5))
    mod = MODULES[family][1]
    l4 = mod.make_train_step(pcfg, sparse_opt=popt, microbatch=K)(pm, *batch)
    l1 = mod.make_train_step(pcfg, sparse_opt=popt)(one, *batch)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    for name, t0 in start.items():
        if t0.dtype != torch.float32 or t0.numel() == 0:
            continue
        a, b = pm.state_dict()[name], one.state_dict()[name]
        moved = (b - t0).abs().max()
        bound = 1e-5 * moved + 2.0 ** -22 * b.abs().max()
        assert (a - b).abs().max() <= bound, name


def test_microbatch_grads_reassembles_the_slices_in_order():
    # Each slice's delta lands in its own columns, divided by k; the dense
    # gradients are the slice mean; the loss is the mean of the slice means.
    params = [torch.zeros(2)]
    dense = torch.arange(8.0).reshape(8, 1)
    cat = torch.arange(24).reshape(3, 8)

    def slice_grads(d, c, lab):
        return (d.sum(), [torch.full((2,), float(d[0, 0]))],
                (c[..., None].float().repeat(1, 1, 2),))

    loss, dg, (delta,) = microbatch_grads(params, dense, cat, dense[:, 0], 4,
                                          slice_grads)
    assert float(loss) == float(np.mean([1.0, 5.0, 9.0, 13.0]))
    assert torch.equal(dg[0], torch.full((2,), (0 + 2 + 4 + 6) / 4))
    assert delta.dtype == torch.float32 and delta.shape == (3, 8, 2)
    assert torch.equal(delta[..., 0], cat.float() / 4)
    with pytest.raises(ValueError, match="batch 8 not divisible by "
                                         "microbatch 3"):
        microbatch_grads(params, dense, cat, dense[:, 0], 3, slice_grads)
