"""Precision of the plain reference, and its control.

The reference computes in float32 with TF32 off (`exact()` sets that). The
control computes the same in the next precision below what a configuration
states: its bf16 tower products become fp8 (e4m3, one scale per tensor from
its largest magnitude, forward and backward), and its f32 tables are held as
bf16. Plain PyTorch; nothing of the port is imported here.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def exact():
    """Context: f32 products without TF32, restored after."""
    @contextlib.contextmanager
    def ctx():
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
    return ctx()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded through float8 e4m3 with one per-tensor scale."""
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """`a @ b` with both operands rounded to fp8, and the backward's
    products from fp8-rounded operands too, accumulated in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """`matmul` and `table` of the reference ("f32") or of its control
    ("lower")."""

    def __init__(self, name: str):
        if name not in ("f32", "lower"):
            raise ValueError(name)
        self.name = name

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "lower":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def table(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows as this precision stores them (f32 values)."""
        if self.name == "lower":
            return rows.to(torch.bfloat16).to(torch.float32)
        return rows
