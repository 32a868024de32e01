"""Carry the models' weights into the port from plain numpy arrays.

The arrays are what `np.asarray` gives for the JAX package's parameters and
optimizer states, so a model trained there can be served or trained on
here, and the tests can hold both packages to the same weights. bfloat16
arrays arrive as the `ml_dtypes` bfloat16 numpy type, which
`torch.from_numpy` refuses; they are reinterpreted bit for bit through
uint16.

Each builder puts the model on `device` (CUDA unless given). The table
variants' builders (`quantized_from_arrays`, `qr_from_arrays`,
`md_from_arrays`, `tt_from_arrays`, `tiered_from_arrays`) take the arrays of
the JAX tables of the same names. Layers are
lists of tuples of arrays (`(W (fan_in, fan_out), b)`; DCN's low-rank cross
layers `(U, V, b)`). A sparse optimizer's state (`emb_state=` and the
like) is any object with named fields, a NamedTuple such as the JAX
package's or a dict: `accum` (SGD's zero-size one, or row-wise AdaGrad's);
`m`, `v`, `count` (lazy Adam); or `z`, `n` (FTRL). None: SGD's empty state.
The CTR models' `dense_opt_state=` carries the towers' `optax.adam`
state, `(count, mu, nu)` with `mu` and `nu` nested like the JAX model's
tower parameters, into the `DenseOptState` that `torch.optim.Adam` steps
(`count` becomes every parameter's `step`).

The torch bridge (JAX's `interop.py` moves weights between its tables and
`torch.nn` modules; here both sides are torch): `from_torch` copies an
`nn.Embedding`, an `nn.EmbeddingBag` or a `(V, D)` tensor into a
`SimpleEmbedding` on that tensor's device, `to_torch_embedding` gives an
`nn.Embedding` (or `nn.EmbeddingBag`) holding a table's rows as float32 on
the table's device, and `stacked_from_torch` / `stacked_to_torch` do the
same for a `StackedTables` and its per-table modules. Each copies, as JAX's
does, so training one side leaves the other as it was.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .config import resolve_device
from .models.dcn import DCN, DCNConfig
from .models.deepfm import DeepFM, DeepFMConfig
from .models.dlrm import _STATE_TYPES, DLRM, DLRMConfig
from .models.two_tower import TwoTower, TwoTowerConfig
from .ops.ensemble import StackedTables
from .md import MDEmbedding
from .offload import host_put
from .optim import DenseOptState, SparseOptState
from .qr import QREmbedding
from .quant import Int4QuantizedEmbedding, QuantizedEmbedding
from .tiered import TieredEmbedding
from .tt import TTEmbedding
from .tables import SimpleEmbedding, as_table
from .types import Dynamic, TableSpec

_STATES = {c._fields: c for c in _STATE_TYPES}


def tensor_from_array(arr, device) -> torch.Tensor:
    """numpy array -> tensor on `device`, bfloat16 carried bit for bit."""
    arr = np.array(arr)          # a private, writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.int16)
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _layers(layers, device) -> list:
    return [tuple(tensor_from_array(a, device) for a in layer)
            for layer in layers]


def _state(state, device):
    """A sparse optimizer's state from named arrays; None stays None."""
    if state is None:
        return None
    fields = state if isinstance(state, dict) else state._asdict()
    cls = _STATES.get(tuple(fields))
    if cls is None:
        raise ValueError(f"no optimizer state has the fields {tuple(fields)}")
    return cls(**{k: tensor_from_array(v, device) for k, v in fields.items()})


def _leaves(tree) -> list:
    """The arrays of nested tuples and lists, in JAX's flattening order."""
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _with_adam_state(model, dense_opt_state):
    """`model` holding optax Adam's `(count, mu, nu)` as the tower state
    `torch.optim.Adam` steps (None: no tower state)."""
    if dense_opt_state is None:
        return model
    count, mu, nu = dense_opt_state
    named = model.tower_params()
    mu, nu = _leaves(mu), _leaves(nu)
    if not len(mu) == len(nu) == len(named):
        raise ValueError(f"dense_opt_state has {len(mu)} / {len(nu)} "
                         f"moments for {len(named)} tower parameters")
    step = float(np.asarray(count))
    fields = {}
    for (name, p), m, v in zip(named, mu, nu):
        m, v = tensor_from_array(m, p.device), tensor_from_array(v, p.device)
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"{name}: moments {tuple(m.shape)} / "
                             f"{tuple(v.shape)}, parameter {tuple(p.shape)}")
        fields[name] = {"step": torch.tensor(step, dtype=torch.float32),
                        "exp_avg": m, "exp_avg_sq": v}
    model.dense_opt_state = DenseOptState([n for n, _ in named], fields)
    return model


def _stack(data, offsets, device) -> StackedTables:
    t = tensor_from_array(data, device)
    return StackedTables(t, tuple(offsets), t.shape[1])


def dlrm_from_arrays(cfg: DLRMConfig, bottom: Sequence, top: Sequence,
                     table_data, offsets: Sequence[int],
                     device=None, emb_accum=None, emb_state=None,
                     dense_opt_state=None) -> DLRM:
    """The port's `DLRM` from numpy arrays: `bottom`/`top` the towers,
    `table_data` the stacked `(sum V, dim)` table, `offsets` its T+1 row
    offsets, and the sparse optimizer's state, so both packages train from
    one state: `emb_accum`, the row-wise-AdaGrad accumulator `(sum V,)`, or
    `emb_state`, and the towers' Adam state `dense_opt_state` (module
    docstring)."""
    device = resolve_device(device)
    if emb_accum is not None and emb_state is not None:
        raise ValueError("pass emb_accum= or emb_state=, not both")
    if emb_accum is not None:
        emb_state = SparseOptState(accum=tensor_from_array(emb_accum, device))
    else:
        emb_state = _state(emb_state, device)
    return _with_adam_state(
        DLRM(cfg, _layers(bottom, device), _layers(top, device),
             _stack(table_data, offsets, device), emb_state), dense_opt_state)


def dcn_from_arrays(cfg: DCNConfig, cross: Sequence, deep: Sequence, head,
                    table_data, offsets: Sequence[int], device=None,
                    emb_state=None, dense_opt_state=None) -> DCN:
    """The port's `DCN` from numpy arrays: `cross` the cross layers, `deep`
    the tower, `head` one `(W, b)`, the stacked table, its offsets, its
    optimizer state and the towers' Adam state."""
    device = resolve_device(device)
    return _with_adam_state(
        DCN(cfg, _layers(cross, device), _layers(deep, device),
            _layers([head], device)[0], _stack(table_data, offsets, device),
            _state(emb_state, device)), dense_opt_state)


def deepfm_from_arrays(cfg: DeepFMConfig, deep: Sequence, head, dense_w,
                       bias, table_data, offsets: Sequence[int],
                       fm_w_data=None, device=None, emb_state=None,
                       fm_state=None, dense_opt_state=None) -> DeepFM:
    """The port's `DeepFM` from numpy arrays, in either layout: `table_data`
    is the fused `(sum V, D+1)` stack when `cfg.folded`, else the D-wide
    vectors with the `(sum V, 1)` first-order weights in `fm_w_data` and
    their state in `fm_state`; `dense_opt_state` the Adam state of
    `(deep, head, dense_w, bias)`."""
    device = resolve_device(device)
    if cfg.use_fm and not cfg.folded and fm_w_data is None:
        raise ValueError("the unfolded layout needs fm_w_data=")
    fm_w = None if fm_w_data is None else _stack(fm_w_data, offsets, device)
    return _with_adam_state(
        DeepFM(cfg, _layers(deep, device), _layers([head], device)[0],
               tensor_from_array(dense_w, device),
               tensor_from_array(bias, device),
               _stack(table_data, offsets, device), fm_w,
               _state(emb_state, device), _state(fm_state, device)),
        dense_opt_state)


def two_tower_from_arrays(cfg: TwoTowerConfig, query_mlp: Sequence,
                          item_mlp: Sequence, query_table_data,
                          offsets: Sequence[int], item_data, device=None,
                          q_state=None, i_state=None) -> TwoTower:
    """The port's `TwoTower` from numpy arrays: the two MLPs, the stacked
    query table and its offsets, the `(item_vocab, dim)` item table, and
    each table's optimizer state."""
    device = resolve_device(device)
    return TwoTower(cfg, _stack(query_table_data, offsets, device),
                    tensor_from_array(item_data, device),
                    _layers(query_mlp, device), _layers(item_mlp, device),
                    _state(q_state, device), _state(i_state, device))


def quantized_from_arrays(scale, *, q=None, packed=None,
                          out_dtype=torch.float32, device=None, name=None):
    """A `QuantizedEmbedding` from int8 rows `q` (V, D), or an
    `Int4QuantizedEmbedding` from packed rows `packed` (V, D//2) uint8, with
    their `(V,)` f32 scales."""
    device = resolve_device(device)
    if (q is None) == (packed is None):
        raise ValueError("pass q= (int8) or packed= (int4), not both")
    scale = tensor_from_array(scale, device)
    if q is not None:
        q = tensor_from_array(q, device)
        spec = TableSpec(vocab=q.shape[0], dim=q.shape[1], dtype=torch.int8,
                         lookup=Dynamic(), name=name)
        return QuantizedEmbedding(q=q, scale=scale, spec=spec,
                                  out_dtype=out_dtype)
    packed = tensor_from_array(packed, device)
    spec = TableSpec(vocab=packed.shape[0], dim=packed.shape[1] * 2,
                     dtype=torch.uint8, lookup=Dynamic(), name=name)
    return Int4QuantizedEmbedding(packed=packed, scale=scale, spec=spec,
                                  out_dtype=out_dtype)


def qr_from_arrays(q_data, r_data, vocab: int, *, combine: str = "mult",
                   device=None, name=None) -> QREmbedding:
    """A `QREmbedding` of `vocab` rows from its quotient and remainder
    tables (Q is the remainder table's row count)."""
    device = resolve_device(device)
    q_data = tensor_from_array(q_data, device)
    r_data = tensor_from_array(r_data, device)
    dim = q_data.shape[1] + (r_data.shape[1] if combine == "concat" else 0)
    spec = TableSpec(vocab=vocab, dim=dim, dtype=q_data.dtype,
                     lookup=Dynamic(), name=name)
    return QREmbedding(q_data=q_data, r_data=r_data, spec=spec,
                       num_remainder=r_data.shape[0], combine=combine)


def md_from_arrays(data, proj, *, device=None, name=None) -> MDEmbedding:
    """An `MDEmbedding` from its `(V, d_small)` rows and `(d_small, D)`
    projection."""
    device = resolve_device(device)
    data = tensor_from_array(data, device)
    proj = tensor_from_array(proj, device)
    spec = TableSpec(vocab=data.shape[0], dim=proj.shape[1], dtype=data.dtype,
                     lookup=Dynamic(), name=name)
    return MDEmbedding(data=data, proj=proj, spec=spec)


def tt_from_arrays(cores: Sequence, vocab: int, *, device=None,
                   name=None) -> TTEmbedding:
    """A `TTEmbedding` of `vocab` rows from its cores
    `(v_k, r_{k-1}, d_k, r_k)`; the factors are the cores' shapes."""
    device = resolve_device(device)
    cores = tuple(tensor_from_array(c, device) for c in cores)
    vf = tuple(c.shape[0] for c in cores)
    df = tuple(c.shape[2] for c in cores)
    dim = int(np.prod(df))
    spec = TableSpec(vocab=vocab, dim=dim, dtype=cores[0].dtype,
                     lookup=Dynamic(), name=name)
    return TTEmbedding(cores=cores, spec=spec, vocab_factors=vf,
                       dim_factors=df)


def tiered_from_arrays(hot, cold, *, device=None, name=None
                       ) -> TieredEmbedding:
    """A `TieredEmbedding` from its hot rows (to `device`) and cold rows (to
    pinned host memory for a card)."""
    device = resolve_device(device)
    hot = tensor_from_array(hot, device)
    cold = host_put(tensor_from_array(cold, "cpu"), device)
    spec = TableSpec(vocab=hot.shape[0] + cold.shape[0], dim=hot.shape[1],
                     dtype=hot.dtype, lookup=Dynamic(), name=name)
    return TieredEmbedding(hot=hot, cold=cold, spec=spec,
                           hot_rows=hot.shape[0])


# ---------------------------------------------------------------------------
# The torch bridge
# ---------------------------------------------------------------------------

def _weight_of(src, device=None) -> torch.Tensor:
    """A copy of the `(vocab, dim)` rows of an `nn.Embedding` /
    `nn.EmbeddingBag`, a tensor (on its device) or an array (on
    `resolve_device(device)`)."""
    w = src.weight if hasattr(src, "weight") else src
    if torch.is_tensor(w):
        w = w.detach().clone()
    else:
        w = tensor_from_array(np.asarray(w), resolve_device(device))
    if w.dim() != 2:
        raise ValueError(f"expected (vocab, dim) weights, got "
                         f"{tuple(w.shape)}")
    return w


def from_torch(src, *, name: str | None = None,
               device=None) -> SimpleEmbedding:
    """`nn.Embedding` / `nn.EmbeddingBag` / `(V, D)` tensor -> a
    `SimpleEmbedding` of a copy of its rows, on the tensor's device (an
    array goes to `device`, CUDA unless given)."""
    return SimpleEmbedding(_weight_of(src, device), name=name)


def _module(w: torch.Tensor, bag: bool = False, mode: str = "sum"):
    v, d = w.shape
    m = (torch.nn.EmbeddingBag(v, d, mode=mode, device=w.device) if bag
         else torch.nn.Embedding(v, d, device=w.device))
    with torch.no_grad():
        m.weight.copy_(w.float())
    return m


def to_torch_embedding(table, *, bag: bool = False, mode: str = "sum"):
    """A table -> `nn.Embedding` (or `nn.EmbeddingBag(mode=mode)` with
    `bag=True`) holding a float32 copy of its rows on the table's device.
    Any protocol table with a dense form exports: `data`, or
    `materialize()` of the compositional, offloaded and tiered tables."""
    t = as_table(table)
    data = getattr(t, "data", None)
    if data is None:
        data = t.materialize()
    return _module(data, bag=bag, mode=mode)


def stacked_from_torch(sources: Sequence, device=None) -> StackedTables:
    """Per-table torch weights (modules or tensors) -> ONE stacked
    `(sum V, D)` ensemble, offsets rebuilt from the vocab sizes."""
    ws = [_weight_of(s, device) for s in sources]
    dims = {w.shape[1] for w in ws}
    if len(dims) != 1:
        raise ValueError(f"stacked tables need one dim, got {sorted(dims)}")
    offs = [0]
    for w in ws:
        offs.append(offs[-1] + w.shape[0])
    return StackedTables(torch.cat([w.to(ws[0].device) for w in ws]),
                         tuple(offs), ws[0].shape[1])


def stacked_to_torch(tables: StackedTables) -> list:
    """A `StackedTables` -> one `nn.Embedding` per member table."""
    return [_module(tables.data[tables.offsets[i]:tables.offsets[i + 1]])
            for i in range(tables.ntables)]
