"""Classification metric battery on tensors, batched.

Counterpart of ``multimodalautoencoder_tpu/ops/metrics.py``.  The reference
computes acc/AUC/F1/precision/recall with sklearn on the host
(generic_wrapper.py:591-604) and turns errors into NaN (:563-577, e.g. AUC
with one class present).  These are torch functions that keep sklearn's
values on binary inputs and the NaN degradation, so a sweep's metrics are
computed where its predictions are.

Every function reduces over the LAST axis (the rows) and broadcasts over
any leading axes, so one call scores a whole (config, fold, label) stack.
``valid`` is an optional boolean row mask of the same shape, for padded
fold stacks (ragged CV folds padded to a common length).  Results are
float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _mask(valid: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones(like.shape, dtype=torch.float32, device=like.device)
    return valid.to(torch.float32).expand(like.shape)


def _nan_where(cond: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, val, torch.full_like(val, float("nan")))


def binary_accuracy(preds: torch.Tensor, true_y: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of exact matches (generic_wrapper.py:579-589); NaN on an
    empty valid slice (the reference's 0/0 raises and becomes NaN,
    :563-577, so a fold mean skips it)."""
    m = _mask(valid, preds)
    n = m.sum(-1)
    hit = (preds.float() == true_y.float()).float()
    return _nan_where(n > 0, (hit * m).sum(-1) / n.clamp(min=1))


def roc_auc(scores: torch.Tensor, true_y: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank-based (Mann-Whitney) AUC with tie-averaged ranks, equal to
    ``sklearn.roc_auc_score`` including on hard 0/1 predictions (the
    reference feeds hard predictions, :600); NaN when one class is
    absent.  Invalid rows sort past every valid score (+inf)."""
    m = _mask(valid, scores)
    yb = (true_y > 0.5).float()
    pos, neg = yb * m, (1.0 - yb) * m
    n_pos, n_neg = pos.sum(-1), neg.sum(-1)
    s = scores.float().expand(m.shape).contiguous()
    srt, _ = torch.sort(torch.where(m > 0, s, torch.full_like(s,
                                                              float("inf"))),
                        dim=-1)
    lo = torch.searchsorted(srt, s, side="left")
    hi = torch.searchsorted(srt, s, side="right")
    rank = 0.5 * (lo + hi + 1).float()          # 1-based, tie-averaged
    auc = ((rank * pos).sum(-1) - n_pos * (n_pos + 1) / 2) \
        / (n_pos * n_neg).clamp(min=1)
    return _nan_where((n_pos > 0) & (n_neg > 0), auc)


def precision(preds: torch.Tensor, true_y: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sklearn ``precision_score``: 0.0 without positive predictions; NaN
    on an empty valid slice."""
    m = _mask(valid, preds)
    p = (preds > 0.5).float() * m
    y = (true_y > 0.5).float()
    tp, pp = (p * y).sum(-1), p.sum(-1)
    val = torch.where(pp > 0, tp / pp.clamp(min=1), torch.zeros_like(tp))
    return _nan_where(m.sum(-1) > 0, val)


def recall(preds: torch.Tensor, true_y: torch.Tensor,
           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sklearn ``recall_score``: 0.0 without positive labels; NaN on an
    empty valid slice."""
    m = _mask(valid, preds)
    p = (preds > 0.5).float()
    y = (true_y > 0.5).float() * m
    tp, ap = (p * y).sum(-1), y.sum(-1)
    val = torch.where(ap > 0, tp / ap.clamp(min=1), torch.zeros_like(tp))
    return _nan_where(m.sum(-1) > 0, val)


def f1(preds: torch.Tensor, true_y: torch.Tensor,
       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sklearn ``f1_score``; NaN where precision or recall is NaN."""
    pr = precision(preds, true_y, valid)
    rc = recall(preds, true_y, valid)
    val = torch.where(pr + rc > 0,
                      2 * pr * rc / (pr + rc).clamp(min=1e-20),
                      torch.zeros_like(pr))
    return _nan_where(~(torch.isnan(pr) | torch.isnan(rc)), val)


def all_classification_metrics(preds: torch.Tensor, true_y: torch.Tensor,
                               valid: Optional[torch.Tensor] = None
                               ) -> Dict[str, torch.Tensor]:
    """acc/auc/f1/precision/recall, the reference battery
    (generic_wrapper.py:591-604)."""
    return {
        "acc": binary_accuracy(preds, true_y, valid),
        "auc": roc_auc(preds, true_y, valid),
        "f1": f1(preds, true_y, valid),
        "precision": precision(preds, true_y, valid),
        "recall": recall(preds, true_y, valid),
    }


def majority_baseline(y: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Most-frequent-class rate (generic_wrapper.py:549-561); NaN on an
    empty valid slice."""
    m = _mask(valid, y)
    n = m.sum(-1)
    frac = ((y > 0.5).float() * m).sum(-1) / n.clamp(min=1)
    return _nan_where(n > 0, torch.maximum(frac, 1.0 - frac))
