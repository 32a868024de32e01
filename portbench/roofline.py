"""Peaks of the card and the bytes a kernel's inputs need.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit: 989 TFLOP/s in bf16, 67 TFLOP/s in f32 outside the
tensor cores, 3.35 TB/s of HBM. A card the table does not know has no
peak, and every share of a peak is then left out rather than guessed.

Bytes are what the inputs need, each input byte read once and each output
byte written once, whatever the kernel reads again (the byte bounds of the
port's `chip_smoke.py`, `gather_bound_ms` and `time_scatter`):

    gather_rows of n ids, U of them distinct, rows of D elements:
        U*D*s (rows read) + 4n (ids) + n*D*s (rows written)
    run-scatter of n sorted occurrences onto U distinct rows:
        4nD (values) + 4n (row ids) + 2*U*D*s (rows read and written)
        + 2*4U (row-wise AdaGrad's accumulator read and written)
"""
from __future__ import annotations

PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak(kind: str, what: str):
    """The card `kind`'s peak `what`, or None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks[what]
    return None


def gather_rows_bytes(n: int, unique: int, d: int, itemsize: int = 4) -> int:
    return unique * d * itemsize + 4 * n + n * d * itemsize


def run_scatter_bytes(n: int, unique: int, d: int, adagrad: bool,
                      itemsize: int = 4) -> int:
    return (4 * n * d + 4 * n + 2 * unique * d * itemsize
            + (8 * unique if adagrad else 0))


def train_step_gather_bytes(n: int, unique: int, d: int) -> int:
    """A training step's two gathers: the lookup of its n ids, and the
    update's permute of its n value rows (all distinct) into sorted
    order."""
    return gather_rows_bytes(n, unique, d) + gather_rows_bytes(n, n, d)
