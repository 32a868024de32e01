"""Training-quality metrics in numpy (the port's copy of `auc` and
`log_loss` from `embeddingtables_tpu/metrics.py`; evaluation is a host-side
concern)."""
from __future__ import annotations

import numpy as np


def auc(labels, scores) -> float:
    """Exact ROC-AUC: P(score_pos > score_neg) + 0.5 * P(tie).

    Rank-based (Mann-Whitney U) with average ranks for ties.
    """
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, scores.size + 1, dtype=np.float64)
    # Average ranks over tie groups.
    sorted_scores = scores[order]
    is_new = np.concatenate([[True], sorted_scores[1:] != sorted_scores[:-1]])
    group = np.cumsum(is_new) - 1
    gsum = np.zeros(group[-1] + 1)
    gcnt = np.zeros(group[-1] + 1)
    np.add.at(gsum, group, ranks[order])
    np.add.at(gcnt, group, 1)
    avg = gsum / gcnt
    ranks[order] = avg[group]
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def log_loss(labels, logits, eps: float = 1e-7) -> float:
    """Mean binary cross-entropy from LOGITS (the CTR industry's primary
    loss metric). Computed in float64 with the numerically-stable
    softplus form: `bce = softplus(logit) - label * logit`."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    logits = np.asarray(logits, np.float64).reshape(-1)
    bce = np.logaddexp(0.0, logits) - labels * logits
    del eps  # kept for signature stability with probability-space callers
    return float(bce.mean())
