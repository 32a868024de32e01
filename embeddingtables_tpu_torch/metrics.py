"""Training-quality metrics (the port's copy of
`embeddingtables_tpu/metrics.py`): `auc`, `log_loss`, `normalized_entropy`,
`calibration`, `accuracy` and `recall_at_k` in numpy on the host, and
`auc_jax`, the same AUC on tensors where they lie."""
from __future__ import annotations

import numpy as np
import torch


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


def auc_jax(labels, scores) -> torch.Tensor:
    """ROC-AUC with average-rank ties, computed on the device of `scores`
    (JAX's jit-compatible `auc_jax`, in float32): a 0-d tensor, no host
    sync. With one class only it is 0 where `auc` gives NaN, as JAX's."""
    scores = torch.as_tensor(scores).reshape(-1).float()
    labels = torch.as_tensor(labels).to(scores.device).reshape(-1).float()
    n = scores.numel()
    order = torch.argsort(scores, stable=True)
    s = scores[order]
    base = torch.arange(1, n + 1, dtype=torch.float32, device=s.device)
    is_new = torch.ones(n, dtype=torch.bool, device=s.device)
    is_new[1:] = s[1:] != s[:-1]
    group = torch.cumsum(is_new.long(), 0) - 1
    gsum = torch.zeros(n, device=s.device).index_add_(0, group, base)
    gcnt = torch.zeros(n, device=s.device).index_add_(
        0, group, torch.ones(n, device=s.device))
    avg = torch.where(gcnt > 0, gsum / torch.clamp_min(gcnt, 1.0), 0.0)
    ranks = torch.zeros(n, device=s.device).index_copy_(0, order, avg[group])
    n_pos = labels.sum()
    n_neg = n - n_pos
    u = (ranks * labels).sum() - n_pos * (n_pos + 1) / 2.0
    return u / torch.clamp_min(n_pos * n_neg, 1.0)


def log_loss(labels, logits, eps: float = 1e-7) -> float:
    """Mean binary cross-entropy from LOGITS (the CTR industry's primary
    loss metric). Computed in float64 with the numerically-stable
    softplus form: `bce = softplus(logit) - label * logit`."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    logits = np.asarray(logits, np.float64).reshape(-1)
    bce = np.logaddexp(0.0, logits) - labels * logits
    del eps  # kept for signature stability with probability-space callers
    return float(bce.mean())


def normalized_entropy(labels, logits) -> float:
    """Log loss normalized by the entropy of the base CTR (He et al.,
    "Practical Lessons from Predicting Clicks on Ads at Facebook", ADKDD
    2014). NE < 1 means the model beats the best constant predictor."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    p = labels.mean()
    if p <= 0.0 or p >= 1.0:
        return float("nan")
    base = -(p * np.log(p) + (1.0 - p) * np.log(1.0 - p))
    return float(log_loss(labels, logits) / base)


def calibration(labels, logits) -> float:
    """Mean predicted CTR / empirical CTR; 1.0 is calibrated in aggregate."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    logits = np.asarray(logits, np.float64).reshape(-1)
    p = 1.0 / (1.0 + np.exp(-logits))
    actual = labels.mean()
    if actual <= 0.0:
        return float("nan")
    return float(p.mean() / actual)


def accuracy(labels, scores, threshold: float = 0.0) -> float:
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    return float(((scores > threshold) == (labels > 0.5)).mean())


def recall_at_k(true_ids, retrieved_ids) -> float:
    """Fraction of queries whose positive item appears in the retrieved
    top k. true_ids: (B,); retrieved_ids: (B, k)."""
    true_ids = np.asarray(true_ids).reshape(-1, 1)
    retrieved_ids = np.asarray(retrieved_ids)
    return float((retrieved_ids == true_ids).any(axis=1).mean())
