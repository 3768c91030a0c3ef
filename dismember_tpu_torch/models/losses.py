"""Loss functions with reference-equivalent reductions.

Port of ``dismember_tpu/models/losses.py``:
- ``bce_with_logits``: max(x,0) - x*z + log1p(exp(-|x|)), size-averaged —
  scalann nn/BCECriterionWithLogits.scala:29-60.
- ``cross_entropy``: LogSoftMax + ClassNLL, size-averaged — scalann
  nn/CrossEntropyCriterion.scala.
"""

from __future__ import annotations

import torch


def bce_with_logits(
    logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor | None = None,
    denom: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean binary cross-entropy over all elements (optionally masked).

    weights: same shape as logits; 0 excludes an element from both the sum and
    the denominator (used for padded sample rows).  ``denom`` replaces the
    denominator (a mesh rank's share of a batch divides by the global one).
    """
    x, z = logits, targets
    per = torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    if weights is None:
        return per.mean()
    if denom is None:
        denom = torch.clamp_min(weights.sum(), 1.0)
    return (per * weights).sum() / denom


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels.

    logits [N, C], labels [N] int; weights [N] optional row mask.
    """
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, 1, labels[:, None].long())[:, 0]
    if weights is None:
        return -picked.mean()
    return -(picked * weights).sum() / torch.clamp_min(weights.sum(), 1.0)
