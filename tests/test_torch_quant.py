"""The port's quantized tables and quantized serving against the JAX
package's `quant.py`, on the CPU.

`quantize_rows` and `quantize_rows_int4` are held bitwise (`q`, `packed`,
`scale`), as are the gathered rows, their NaN rows for ids outside
`[-V, V)` and the dense reconstructions. The quantized DLRM, DCN-v2 and
DeepFM evals (int8 and int4, both DeepFM layouts, one-hot and bag-4 batches)
are held to JAX's `eval_fn` with the weights carried by the
`*_from_arrays` builders: f32 towers, so they agree up to the order of f32
sums (rtol/atol 1e-5). One deliberate divergence is pinned: JAX's quantized
bags add the pad id's wrapped row, the port's follow the lookup's pad
contract.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu import quant as JQ
from embeddingtables_tpu import serving as jax_serving
from embeddingtables_tpu.models import dcn as JD
from embeddingtables_tpu.models import deepfm as JF
from embeddingtables_tpu.models import dlrm as JM
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import quant as PQ
from _torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
VOCABS = (13, 29, 7)
B = 8

# The JAX gathers, jitted: one compile per program instead of one per op.
# `quantize_rows` stays eager, as the JAX package calls it: under jit, XLA
# turns its division by 127 into a multiply by the reciprocal, one rounding
# off.
_rows = jax.jit(lambda t, i: t.rows(i))
_dequantize = jax.jit(lambda t: t.dequantize())


def _table(rng, v, d, zero_rows=(3,)):
    data = rng.standard_normal((v, d)).astype(np.float32)
    # Values on the rounding grid's half points and an all-zero row.
    data[1, :4] = np.array([0.5, -0.5, 1.5, 2.5], np.float32)
    data[1, 4] = 127.0
    for r in zero_rows:
        data[r] = 0.0
    return data


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 6])
def test_quantize_rows_is_bitwise_jax(dtype, d):
    data = _table(np.random.default_rng(d), 40, d)
    jdata = jnp.asarray(data).astype(dtype)
    pdata = torch.from_numpy(np.array(jdata.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = JQ.quantize_rows(jdata)
    pq, ps = PQ.quantize_rows(pdata)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    jp, js4 = JQ.quantize_rows_int4(jdata)
    pp, ps4 = PQ.quantize_rows_int4(pdata)
    assert pp.dtype == torch.uint8 and pp.shape == (40, d // 2)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ps4.numpy().view(np.int32),
                                  np.asarray(js4).view(np.int32))
    np.testing.assert_array_equal(PQ._unpack_int4(pp).numpy(),
                                  np.asarray(JQ._unpack_int4(jp)))


def test_int4_refuses_an_odd_dim_as_jax_does():
    data = np.ones((4, 5), np.float32)
    with pytest.raises(ValueError, match="even dim"):
        JQ.quantize_rows_int4(jnp.asarray(data))
    with pytest.raises(ValueError, match="even dim"):
        PQ.quantize_rows_int4(torch.from_numpy(data))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_rows_match_jax_with_nan_rows_in_the_same_places(bits):
    v, d = 50, 8
    data = _table(np.random.default_rng(bits), v, d)
    jcls = JQ.QuantizedEmbedding if bits == 8 else JQ.Int4QuantizedEmbedding
    jt = jcls.quantize(jnp.asarray(data))
    pt = (ett.QuantizedEmbedding if bits == 8 else ett.Int4QuantizedEmbedding
          ).quantize(torch.from_numpy(data))
    # The builder from JAX's arrays gives the same table.
    stored = {"q": jt.q} if bits == 8 else {"packed": jt.packed}
    carried = ett.quantized_from_arrays(
        np.asarray(jt.scale), device="cpu",
        **{k: np.asarray(a) for k, a in stored.items()})
    ids = np.array([[0, 3, v - 1, -1], [-v, v, -v - 1, 2**31 - 1],
                    [7, 7, -2**31, 1]], np.int32)
    want = np.asarray(_rows(jt, jnp.asarray(ids)))
    for t in (pt, carried):
        got = t.rows(torch.from_numpy(ids)).numpy()
        assert got.shape == (3, 4, d)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
        np.testing.assert_array_equal(t.dequantize().numpy(),
                                      np.asarray(_dequantize(jt)))
        assert t.nbytes == jt.nbytes and tuple(t.shape) == tuple(jt.shape)
        assert t.spec.vocab == v and t.spec.dim == d
    # Through the lookup, as a protocol table: a bag sum of the rows.
    got = ett.lookup(pt, torch.from_numpy(ids[:1]))
    np.testing.assert_allclose(got.numpy(), want[:1].sum(1), **TOL)
    assert PQ.max_quantization_error(torch.from_numpy(data)) == \
        JQ.max_quantization_error(jnp.asarray(data))


def _arrays(layers):
    return [tuple(np.asarray(a) for a in layer) for layer in layers]


def _family_pair(family, bag=None, fold=True, pad_idx=None):
    """A JAX model of `family` and its port copy (f32 towers)."""
    common = dict(vocab_sizes=VOCABS, num_dense=3, dim=8, bag=bag,
                  pad_idx=pad_idx)
    key = jax.random.key(1)
    if family == "dlrm":
        kw = dict(common, bottom_mlp=(16, 8), top_mlp=(16, 1))
        jcfg = JM.DLRMConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DLRMConfig(**kw, compute_dtype=torch.float32)
        jm = JM.init_dlrm(key, jcfg)
        pm = ett.dlrm_from_arrays(pcfg, _arrays(jm.bottom), _arrays(jm.top),
                                  np.asarray(jm.tables.data),
                                  jm.tables.offsets, device="cpu")
    elif family == "dcn":
        kw = dict(common, deep_mlp=(16, 8), num_cross=1)
        jcfg = JD.DCNConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DCNConfig(**kw, compute_dtype=torch.float32)
        jm = JD.init_dcn(key, jcfg)
        pm = ett.dcn_from_arrays(pcfg, _arrays(jm.cross), _arrays(jm.deep),
                                 _arrays([jm.head])[0],
                                 np.asarray(jm.tables.data),
                                 jm.tables.offsets, device="cpu")
    else:
        kw = dict(common, deep_mlp=(16, 8), fold_fm_w=fold)
        jcfg = JF.DeepFMConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DeepFMConfig(**kw, compute_dtype=torch.float32)
        jm = JF.init_deepfm(key, jcfg)
        rng = np.random.default_rng(5)
        # Non-zero first-order weights (JAX starts them at zero).
        if jm.fm_w is not None:
            jm.fm_w.data = jnp.asarray(
                rng.normal(0, 0.1, jm.fm_w.data.shape).astype(np.float32))
        else:
            col = rng.normal(0, 0.1, (jm.tables.data.shape[0], 1))
            jm.tables.data = jm.tables.data.at[:, :1].set(
                col.astype(np.float32))
        pm = ett.deepfm_from_arrays(
            pcfg, _arrays(jm.deep), _arrays([jm.head])[0],
            np.asarray(jm.dense_w), np.asarray(jm.bias),
            np.asarray(jm.tables.data), jm.tables.offsets,
            fm_w_data=None if jm.fm_w is None else np.asarray(jm.fm_w.data),
            device="cpu")
    return jm, pm


QUANTIZE = {"dlrm": (JQ.quantize_dlrm, PQ.quantize_dlrm),
            "dcn": (JQ.quantize_dcn, PQ.quantize_dcn),
            "deepfm_folded": (JQ.quantize_deepfm, PQ.quantize_deepfm),
            "deepfm_unfolded": (JQ.quantize_deepfm, PQ.quantize_deepfm)}


def _batch(rng, b, bag=None):
    dense = rng.standard_normal((b, 3)).astype(np.float32)
    shape = (b,) if bag is None else (b, bag)
    cat = np.stack([rng.integers(0, v, shape) for v in VOCABS])
    return dense, cat.astype(np.int32)


@pytest.fixture(scope="module")
def pairs():
    """One JAX model and its port copy per configuration, shared by the
    cases of this module."""
    cache = {}

    def get(family, bag=None):
        key = (family, bag)
        if key not in cache:
            cache[key] = _family_pair(family.split("_")[0], bag=bag,
                                      fold=family != "deepfm_unfolded")
        return cache[key]
    return get


@pytest.mark.parametrize("bag", [None, 4], ids=["one_hot", "bag4"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("family", sorted(QUANTIZE))
def test_quantized_eval_matches_jax(family, bits, bag, pairs):
    jm, pm = pairs(family, bag)
    jq, pq = QUANTIZE[family]
    if family == "deepfm_folded" and bits == 4:
        # The fused (sum V, D + 1) stack is odd-width: int4 refuses it.
        with pytest.raises(ValueError, match="even dim"):
            jq(jm, bits=4)
        with pytest.raises(ValueError, match="even dim"):
            pq(pm, bits=4)
        return
    jt, jeval = jq(jm, bits=bits)
    pt, peval = pq(pm, bits=bits)
    stored = (pt.q, jt.q) if bits == 8 else (pt.packed, jt.packed)
    np.testing.assert_array_equal(stored[0].numpy(), np.asarray(stored[1]))
    dense, cat = _batch(np.random.default_rng(bits), B, bag)
    want = np.asarray(jeval(jnp.asarray(dense), jnp.asarray(cat)))
    got = peval(dense, cat)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_quantize_refuses_other_bits_as_jax_does(pairs):
    jm, pm = pairs("dlrm")
    with pytest.raises(ValueError, match="bits"):
        JQ.quantize_dlrm(jm, bits=2)
    with pytest.raises(ValueError, match="bits"):
        PQ.quantize_dlrm(pm, bits=2)


@pytest.mark.parametrize("family,bits", [("dlrm", 8), ("dcn", 4),
                                         ("deepfm", 8)])
def test_quantized_service_matches_jax_service(family, bits, pairs):
    jm, pm = pairs(family if family != "deepfm" else "deepfm_folded")
    fn = f"make_{family}_service"
    theirs = getattr(jax_serving, fn)(jm, quantized=True, quantize_bits=bits,
                                      max_batch=16)
    ours = getattr(ett, fn)(pm, quantized=True, quantize_bits=bits,
                            max_batch=16)
    rng = np.random.default_rng(9)
    reqs = [_batch(rng, b) for b in (1, 3, 5)]
    try:
        got = [f.result(timeout=60) for f in
               [ours.submit(d, c) for d, c in reqs]]
        want = [theirs.predict(d, c, timeout=60) for d, c in reqs]
    finally:
        ours.stop()
        theirs.stop()
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)


def test_a_quantized_service_on_a_mesh_raises_what_jax_raises(pairs):
    _, pm = pairs("dlrm")
    with pytest.raises(NotImplementedError, match="single-chip"):
        ett.make_dlrm_service(pm, quantized=True, mesh=object())


def test_quantized_bags_follow_the_lookup_pad_contract_where_jax_adds_row_v_minus_1():
    """The deliberate divergence: with `pad_idx=-1`, JAX's quantized eval
    gathers a pad like any id, so it adds a real row (row V-1 of the stack
    for the first table) into the bag; the port masks it, so its quantized
    eval equals its unquantized eval on the dequantized table."""
    jm, pm = _family_pair("dlrm", bag=3, pad_idx=-1)
    rng = np.random.default_rng(4)
    dense, cat = _batch(rng, B, 3)
    cat[:, :, 2] = -1                      # one pad in every bag
    jt, jeval = JQ.quantize_dlrm(jm)
    pt, peval = PQ.quantize_dlrm(pm)
    got = peval(dense, cat).numpy()
    # The port: the unquantized eval of the same model on the dequantized
    # rows (pads add nothing).
    deq = ett.dlrm_from_arrays(pm.config, _arrays(jm.bottom), _arrays(jm.top),
                               pt.dequantize().numpy(), jm.tables.offsets,
                               device="cpu")
    np.testing.assert_allclose(
        got, ett.make_eval_step(pm.config)(deq, dense, cat).numpy(), **TOL)
    # JAX: the pad is an id like any other, -1 + the table's offset, which
    # wraps into row V-1 of the stack for table 0 (and gives the previous
    # table's last row for the others): the port's eval with no pad_idx.
    want = np.asarray(jeval(jnp.asarray(dense), jnp.asarray(cat)))
    cfg = pm.config
    pm.config = dataclasses.replace(cfg, pad_idx=None)
    try:
        _, peval_nopad = PQ.quantize_dlrm(pm)
    finally:
        pm.config = cfg
    np.testing.assert_allclose(want, peval_nopad(dense, cat).numpy(), **TOL)
    assert np.abs(got - want).max() > 1e-3
