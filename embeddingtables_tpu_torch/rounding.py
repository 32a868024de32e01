"""Stochastic rounding for low-precision embedding training (counterpart of
`embeddingtables_tpu/rounding.py`).

An SGD step smaller than half a bf16 ulp rounds back to the old value every
time under round-to-nearest, so small-gradient rows of a bf16 table stop
learning. Stochastic rounding (SR) rounds to one of the two neighbouring
bf16 values with probability proportional to proximity, so it is unbiased
and tiny steps accumulate in expectation.

The bit trick is the JAX package's: view f32 as its 32 bits, add a uniform
random 16-bit integer, drop the low 16 bits. NaN and Inf pass through. The
noise comes from an explicit `torch.Generator` (`torch.randint`), so its bits
differ from JAX's: SR is held to its properties, not to JAX's draws.
"""
from __future__ import annotations

import torch


def stochastic_round_to_bf16(x: torch.Tensor,
                             generator: torch.Generator) -> torch.Tensor:
    """SR-cast to bf16: unbiased, always one of the two bf16 neighbours of
    `x` (or `x` itself when it is representable)."""
    x = x.float()
    bits = x.view(torch.int32)
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          dtype=torch.int32, device=x.device)
    # int32 addition wraps like the uint32 add it stands for; the bf16
    # pattern is the high half.
    rounded = ((bits + noise) >> 16).to(torch.int16).view(torch.bfloat16)
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, x.to(torch.bfloat16), rounded)


def stochastic_cast(x: torch.Tensor, dtype: torch.dtype,
                    generator: torch.Generator | None) -> torch.Tensor:
    """Cast an f32 result to the table's storage dtype: SR for bf16 when a
    generator is given, else a plain cast (round to nearest even)."""
    if generator is not None and dtype == torch.bfloat16:
        return stochastic_round_to_bf16(x, generator)
    return x.to(dtype)
