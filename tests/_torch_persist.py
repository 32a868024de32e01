"""Model pairs for the port's tests: one JAX model of each family (DLRM,
DCN, DeepFM folded and unfolded, the two-tower retriever) and the port's
copy of it, carried by the `*_from_arrays` functions with the optimizer
state (and the towers' Adam state with `adam=`), plus the batches both loops
read."""
import functools

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu import optim as J
from embeddingtables_tpu.models import dcn as JD
from embeddingtables_tpu.models import deepfm as JF
from embeddingtables_tpu.models import dlrm as JM
from embeddingtables_tpu.models import two_tower as JT
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as P
from embeddingtables_tpu_torch.data import SyntheticCriteo, SyntheticRetrieval

VOCABS = (13, 29, 7)
B = 16
TT = dict(query_vocab_sizes=(11, 23, 40), item_vocab=60, num_dense=3, dim=8,
          embed_dim=8, query_mlp=(16, 8), item_mlp=(16, 8))


def opts(name):
    return {"sgd": (J.SparseSGD(0.1), P.SparseSGD(0.1)),
            "adagrad": (J.SparseRowWiseAdaGrad(0.1, method="indexer"),
                        P.SparseRowWiseAdaGrad(0.1, method="indexer")),
            "adam": (J.SparseLazyAdam(0.05), P.SparseLazyAdam(0.05)),
            "ftrl": (J.SparseFTRL(0.1, l1=0.01), P.SparseFTRL(0.1, l1=0.01)),
            }[name]


def arrays(layers):
    return [tuple(np.asarray(a) for a in layer) for layer in layers]


ADAM_LR = 1e-2


def adam_txs():
    """The towers' Adam in both packages: `(optax.adam, torch.optim.Adam
    factory)`, at `ADAM_LR` with their (equal) default betas and eps."""
    return (optax.adam(ADAM_LR),
            functools.partial(torch.optim.Adam, lr=ADAM_LR))


def adam_arrays(state):
    """optax Adam's state as `*_from_arrays(dense_opt_state=)` takes it."""
    st = state[0]
    return (np.asarray(st.count), jax.tree.map(np.asarray, st.mu),
            jax.tree.map(np.asarray, st.nu))


def pair(family, opt="adagrad", seed=2, adam=False, **cfg_kw):
    """((jax_cfg, jax_opt, jax_model), (cfg, opt, model)): the same weights
    and optimizer state in both packages, f32 towers. `adam=True`: both
    models hold the towers' Adam state (`adam_txs`). `cfg_kw` override the
    family's small config."""
    jopt, popt = opts(opt)
    key = jax.random.key(seed)
    tx = {"dense_tx": adam_txs()[0]} if adam else {}

    def carried(jm):
        return adam_arrays(jm.dense_opt_state) if adam else None
    if family == "two_tower":
        jcfg = JT.TwoTowerConfig(**TT)
        pcfg = ett.TwoTowerConfig(**TT)
        jm = JT.init_two_tower(key, jcfg, sparse_opt=jopt)
        pm = ett.two_tower_from_arrays(
            pcfg, arrays(jm.query_mlp), arrays(jm.item_mlp),
            np.asarray(jm.query_tables.data), jm.query_tables.offsets,
            np.asarray(jm.item_table.data), device="cpu", q_state=jm.q_state,
            i_state=jm.i_state)
        return (jcfg, jopt, jm), (pcfg, popt, pm)
    common = dict(vocab_sizes=VOCABS, num_dense=3, dim=8)
    if family == "dlrm":
        kw = dict(common, bottom_mlp=(16, 8), top_mlp=(16, 1), **cfg_kw)
        jcfg = JM.DLRMConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DLRMConfig(**kw, compute_dtype=torch.float32)
        jm = JM.init_dlrm(key, jcfg, sparse_opt=jopt, **tx)
        pm = ett.dlrm_from_arrays(pcfg, arrays(jm.bottom), arrays(jm.top),
                                  np.asarray(jm.tables.data),
                                  jm.tables.offsets, device="cpu",
                                  emb_state=jm.emb_state,
                                  dense_opt_state=carried(jm))
    elif family == "dcn":
        kw = dict(common, deep_mlp=(16, 8), num_cross=1, **cfg_kw)
        jcfg = JD.DCNConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DCNConfig(**kw, compute_dtype=torch.float32)
        jm = JD.init_dcn(key, jcfg, sparse_opt=jopt, **tx)
        pm = ett.dcn_from_arrays(pcfg, arrays(jm.cross), arrays(jm.deep),
                                 arrays([jm.head])[0],
                                 np.asarray(jm.tables.data),
                                 jm.tables.offsets, device="cpu",
                                 emb_state=jm.emb_state,
                                 dense_opt_state=carried(jm))
    else:
        kw = dict(common, deep_mlp=(16, 8),
                  fold_fm_w=family == "deepfm_folded", **cfg_kw)
        jcfg = JF.DeepFMConfig(**kw, compute_dtype=jnp.float32)
        pcfg = ett.DeepFMConfig(**kw, compute_dtype=torch.float32)
        jm = JF.init_deepfm(key, jcfg, sparse_opt=jopt, **tx)
        fm = None
        if jm.fm_w is not None:
            # Nonzero first-order weights, so their stack moves visibly.
            jm.fm_w.data = jnp.asarray(np.random.default_rng(5).normal(
                0, 0.1, jm.fm_w.data.shape).astype(np.float32))
            fm = np.asarray(jm.fm_w.data)
        pm = ett.deepfm_from_arrays(
            pcfg, arrays(jm.deep), arrays([jm.head])[0],
            np.asarray(jm.dense_w), np.asarray(jm.bias),
            np.asarray(jm.tables.data), jm.tables.offsets, fm_w_data=fm,
            device="cpu", emb_state=jm.emb_state, fm_state=jm.fm_state,
            dense_opt_state=carried(jm))
    return (jcfg, jopt, jm), (pcfg, popt, pm)


def batches(family, seed=6, b=B):
    """An endless iterator of host batches for `family`'s loop."""
    if family == "two_tower":
        return SyntheticRetrieval(TT["query_vocab_sizes"], TT["item_vocab"],
                                  num_dense=3, batch_size=b,
                                  seed=seed).batches()
    return SyntheticCriteo(vocab_sizes=VOCABS, num_dense=3, batch_size=b,
                           seed=seed).batches()


def loop_name(family):
    return "train_" + family.replace("_folded", "")


def fresh(family, opt="adagrad", seed=9):
    """A port model of `family` with other weights than `pair`'s."""
    return pair(family, opt, seed=seed)[1][2]
