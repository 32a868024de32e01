"""Quantized embedding tables for serving: int8 and int4 rows with one f32
scale per row (counterpart of `embeddingtables_tpu/quant.py`).

Training stays in f32/bf16; a trained model's stacked tables are quantized
for serving, where the tables' bytes bound the corpus one card holds.

Scheme, symmetric per row: `row ≈ scale_r * q_r` with
`scale_r = max(|row|) / 127` (int8) or `/ 7` (int4, two values packed in a
byte, the even column in the low nibble). An all-zero row gets scale 0. The
arithmetic is the JAX package's, in its order (f32 scale, the reciprocal
clamped at 1e-30, round half to even, clip), so `q` and `scale` come out
bitwise the same.

`QuantizedEmbedding` and `Int4QuantizedEmbedding` implement the table
protocol (`spec`, `rows`, `example`), so `lookup` and the eval paths take
them. `rows` follows `jnp.take`'s fill mode, as the JAX tables do: an id in
`[-V, 0)` wraps, any other out-of-range id gives a row of NaN. Its gather is
torch ops (`index_select` of the int8 or packed rows and of the scales, the
unpack, one multiply), as the JAX package computes it outside any Pallas
kernel.

`quantize_dlrm`, `quantize_dcn` and `quantize_deepfm` turn a trained model
into `(quantized table, eval_fn)`. One deliberate divergence: JAX's eval sums
a bag's rows as they are, so a pad id of -1 adds row V-1; here bags follow
the lookup's pad contract (pads add nothing and leave the mean's
denominator), as the unquantized eval does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ops.cuda.gather import _resolve
from .tables import SimpleEmbedding, as_table
from .types import TableSpec


def _absmax_scale(data: torch.Tensor, qmax: float):
    """(f32 rows, per-row scale, per-row reciprocal) in the JAX order. Both
    divisions are tensor by tensor: on the card PyTorch divides by a Python
    scalar as a multiply by its reciprocal, one rounding off JAX's."""
    x = data.float()
    absmax = x.abs().amax(dim=-1)
    scale = absmax / torch.full_like(absmax, qmax)
    inv = torch.where(scale > 0,
                      torch.ones_like(scale) / torch.clamp_min(scale, 1e-30),
                      torch.zeros_like(scale))
    return x, scale, inv


def quantize_rows(data: torch.Tensor):
    """(V, D) float -> (int8 rows (V, D), per-row scales (V,) f32)."""
    x, scale, inv = _absmax_scale(data, 127.0)
    q = torch.clamp(torch.round(x * inv[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows_int4(data: torch.Tensor):
    """(V, D) float -> (packed uint8 (V, D//2), per-row scales (V,) f32):
    q in [-7, 7], `scale = max(|row|) / 7`, the even column in the low
    nibble. D must be even."""
    if data.shape[-1] % 2:
        raise ValueError(
            f"int4 packing needs an even dim, got {tuple(data.shape)}")
    x, scale, inv = _absmax_scale(data, 7.0)
    q = torch.clamp(torch.round(x * inv[:, None]), -7, 7).to(torch.int16)
    lo = q[:, 0::2] & 0xF
    hi = (q[:, 1::2] & 0xF) << 4
    return (lo | hi).to(torch.uint8), scale


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D//2) uint8 -> (..., D) f32 with 4-bit sign extension."""
    p = packed.to(torch.int16)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2).float()


def _dense_rows(table) -> torch.Tensor:
    t = as_table(table)
    if isinstance(t, SimpleEmbedding):
        return t.data
    return t.rows(torch.arange(t.spec.vocab, device=t.example().device))


def _gather_scaled(stored: torch.Tensor, scale: torch.Tensor, idx,
                   unpack, out_dtype, dim: int) -> torch.Tensor:
    """`unpack(stored[idx]) * scale[idx]` under `jnp.take`'s fill mode: the
    scale of an id outside `[-V, V)` is NaN, so its row is NaN."""
    idx = torch.as_tensor(idx).to(stored.device)
    safe, ok = _resolve(idx.reshape(-1), stored.shape[0])
    s = torch.where(ok, scale.index_select(0, safe),
                    torch.full_like(safe, float("nan"), dtype=torch.float32))
    rows = unpack(stored.index_select(0, safe)) * s[:, None]
    return rows.to(out_dtype).reshape(*idx.shape, dim)


@dataclasses.dataclass
class QuantizedEmbedding:
    """Int8 per-row-scaled table (read-only: serving and eval). Build it
    with `QuantizedEmbedding.quantize`."""

    q: torch.Tensor         # (V, D) int8
    scale: torch.Tensor     # (V,) f32
    spec: TableSpec
    out_dtype: torch.dtype = torch.float32

    @classmethod
    def quantize(cls, table, *, out_dtype=torch.float32,
                 name: Optional[str] = None) -> "QuantizedEmbedding":
        t = as_table(table)
        q, scale = quantize_rows(_dense_rows(t))
        spec = TableSpec(vocab=q.shape[0], dim=q.shape[1], dtype=torch.int8,
                         lookup=t.spec.lookup, name=name)
        return cls(q=q, scale=scale, spec=spec, out_dtype=out_dtype)

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.out_dtype

    def example(self) -> torch.Tensor:
        return self.q

    def rows(self, idx, context=None) -> torch.Tensor:
        """Gather int8 rows and their scales, dequantize: `(*idx.shape, D)`."""
        return _gather_scaled(self.q, self.scale, idx, lambda r: r.float(),
                              self.out_dtype, self.spec.dim)

    def dequantize(self) -> torch.Tensor:
        """The dense reconstruction (a test oracle)."""
        return (self.q.float() * self.scale[:, None]).to(self.out_dtype)

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4


@dataclasses.dataclass
class Int4QuantizedEmbedding:
    """Int4 per-row-scaled table, two values a byte (read-only, like
    `QuantizedEmbedding`): the gather moves packed bytes and unpacks the
    gathered rows only."""

    packed: torch.Tensor    # (V, D//2) uint8
    scale: torch.Tensor     # (V,) f32
    spec: TableSpec
    out_dtype: torch.dtype = torch.float32

    @classmethod
    def quantize(cls, table, *, out_dtype=torch.float32,
                 name: Optional[str] = None) -> "Int4QuantizedEmbedding":
        t = as_table(table)
        data = _dense_rows(t)
        packed, scale = quantize_rows_int4(data)
        spec = TableSpec(vocab=data.shape[0], dim=data.shape[1],
                         dtype=torch.uint8,
                         lookup=t.spec.lookup, name=name)
        return cls(packed=packed, scale=scale, spec=spec, out_dtype=out_dtype)

    @property
    def shape(self):
        return (self.packed.shape[0], self.packed.shape[1] * 2)

    @property
    def dtype(self):
        return self.out_dtype

    def example(self) -> torch.Tensor:
        return self.packed

    def rows(self, idx, context=None) -> torch.Tensor:
        return _gather_scaled(self.packed, self.scale, idx, _unpack_int4,
                              self.out_dtype, self.spec.dim)

    def dequantize(self) -> torch.Tensor:
        """The dense reconstruction (a test oracle)."""
        return (_unpack_int4(self.packed)
                * self.scale[:, None]).to(self.out_dtype)

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + self.scale.numel() * 4


def _quantize_stack(model, bits: int):
    """The model's stacked tables, quantized, and a `StackedTables` over the
    quantized rows that carries the offsets (for `stacked_flat_indices`)."""
    from .ops.ensemble import StackedTables
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qcls = QuantizedEmbedding if bits == 8 else Int4QuantizedEmbedding
    qt = qcls.quantize(SimpleEmbedding(model.tables.data),
                       out_dtype=torch.float32)
    return qt, StackedTables(qt.example(), model.tables.offsets,
                             qt.spec.dim)


def _stacked_rows(table, stack, cfg, cat) -> torch.Tensor:
    """`(T, B[, bag])` local ids -> `(T, B, width)` activations of `table`
    (a protocol table over the stacked rows), bags combined under the
    lookup's pad contract."""
    from .models.dlrm import stacked_flat_indices
    from .ops.lookup import lookup
    cat = torch.as_tensor(cat).to(stack.data.device)
    flat, valid = stacked_flat_indices(stack, cat, cfg.pad_idx)
    out = lookup(table, flat, combiner=cfg.combiner,
                 weights=None if valid is None else valid.float())
    return out.reshape(stack.ntables, cat.shape[1], out.shape[-1])


def quantize_dlrm(model, bits: int = 8):
    """Serving conversion of a trained DLRM: its stacked tables as int8
    (`bits=8`) or int4 rows. Returns `(quantized table, eval_fn)`;
    `eval_fn(dense, cat) -> logits` is `models.dlrm.make_eval_step`'s
    output, gathered from the quantized rows. It holds the towers and the
    quantized rows, not the model's float tables."""
    from .models.dlrm import forward_from_embeddings
    cfg = model.config
    qt, stack = _quantize_stack(model, bits)
    bottom, top = model.bottom, model.top

    def eval_fn(dense, cat):
        with torch.inference_mode():
            emb = _stacked_rows(qt, stack, cfg, cat)
            return forward_from_embeddings(
                bottom, top, cfg, torch.as_tensor(dense).to(emb.device), emb)
    return qt, eval_fn


def quantize_dcn(model, bits: int = 8):
    """Serving conversion of a DCN-v2 (`quantize_dlrm`'s contract): the
    stacked tables quantized, the cross layers, tower and head as they
    are."""
    from .models.dcn import forward_from_embeddings, single_device_only
    cfg = model.config
    single_device_only(cfg, "quantize_dcn")
    qt, stack = _quantize_stack(model, bits)
    cross, deep, head = model.cross, model.deep, model.head

    def eval_fn(dense, cat):
        with torch.inference_mode():
            emb = _stacked_rows(qt, stack, cfg, cat)
            return forward_from_embeddings(
                cross, deep, head, cfg, torch.as_tensor(dense).to(emb.device),
                emb)
    return qt, eval_fn


def quantize_deepfm(model, bits: int = 8):
    """Serving conversion of a DeepFM (`quantize_dlrm`'s contract). Folded
    layout: the fused `(sum V, D+1)` row quantizes as one row, the
    first-order weight sharing its scale (so `bits=4` raises on the odd
    width, as in JAX). Unfolded layout: the `(sum V, 1)` first-order stack
    stays in its storage dtype; per-row scales on one-value rows would save
    nothing."""
    from .models.deepfm import forward_from_embeddings, split_fused
    cfg = model.config
    qt, stack = _quantize_stack(model, bits)
    dense_params = model.dense_params
    fm_w = (SimpleEmbedding(model.fm_w.data)
            if cfg.use_fm and not cfg.folded else None)

    def eval_fn(dense, cat):
        with torch.inference_mode():
            g = _stacked_rows(qt, stack, cfg, cat)
            if cfg.folded:
                w_t, emb = split_fused(g)
            else:
                emb = g
                w_t = (None if fm_w is None
                       else _stacked_rows(fm_w, stack, cfg, cat))
            return forward_from_embeddings(
                dense_params, cfg, torch.as_tensor(dense).to(emb.device),
                emb, w_t)
    return qt, eval_fn


def max_quantization_error(table) -> float:
    """The scheme's worst absolute error per element on `table` (int8):
    half the largest row scale."""
    data = as_table(table).data
    absmax = data.float().abs().amax(dim=-1)
    return float(absmax.max() / 127.0 / 2.0)
