"""The numbers `correct` compares, and their limits.

Training: each of the first steps' loss, the norm of the first gradient as
the optimizer got it, and the norm of each leaf's change after the checked
steps, held against the plain reference's. A leaf's gap is the gap between
the two norms, not the norm of the difference, over the reference's norm of
that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of both (they move by rounding alone). One more number sees what a gap of
norms cannot at these batch sizes: the share of rows whose state the first
update should have touched and did not, or should not have and did (a step
on part of the batch, or a card that applies only its own part of it,
touches fewer rows; a gradient norm over a quarter of 65,536 examples is
within a few percent of the whole batch's). On several cards, one more:
the widest gap between the cards' copies of the towers after the checked
steps, which the gradient all-reduce keeps bitwise equal.

A number is correct when it is finite and at most its limit in
`limits/<cell>.json`; a number with no limit there is not.
"""
from __future__ import annotations

import math
import statistics

# Below this share of the median leaf's reference gradient, a leaf moves
# by rounding alone and is left out.
NEGLIGIBLE = 1e-3


def kept_leaves(ref_grad: dict) -> list:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med]


def leaf_gap(prog: dict, ref: dict, keep: list) -> float:
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def train_gaps(prog: dict, ref: dict) -> dict:
    """{loss_gap, grad_gap, change_gap} of `prog` against `ref` (each a
    reference `steps` result, or the program's readings in its form)."""
    keep = kept_leaves(ref["grad"])
    loss_gap = (max(abs(p - r) / abs(r)
                    for p, r in zip(prog["loss"], ref["loss"]))
                if len(prog["loss"]) == len(ref["loss"]) else math.inf)
    return {
        "loss_gap": loss_gap,
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], keep),
        "change_gap": leaf_gap(prog["change"], ref["change"], keep),
        "rows_gap": abs(prog["touched"] - ref["touched"]) / ref["touched"],
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number finite and within
    its limit."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
