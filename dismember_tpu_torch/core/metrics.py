"""Retrieval metrics: precision / recall / nDCG @ k.

Copy of ``dismember_tpu/core/metrics.py`` (numpy only).

Definition parity with tdm/.../evaluation/Metrics.scala:5-26 (identical in the
otm/dr variants): for recommended list ``rec`` (ordered) and ground-truth
``labels``::

    common = |rec ∩ labels|
    precision = common / len(rec)
    recall    = common / len(labels)
    dcg  = sum over hit positions i (0-based): log(2)/log(i+2)
    idcg = sum over j in [0, common): log(2)/log(j+2)
    ndcg = dcg / idcg        (0 when common == 0)
"""

from __future__ import annotations

import dataclasses

import numpy as np


def compute_metrics(rec: np.ndarray, labels: np.ndarray) -> tuple[float, float, float]:
    """Single-query metrics; ``labels`` may contain -1 padding."""
    labels = labels[labels >= 0]
    k = len(rec)
    if k == 0 or len(labels) == 0:
        return 0.0, 0.0, 0.0
    hits = np.isin(rec, labels)
    common = int(hits.sum())
    if common == 0:
        return 0.0, 0.0, 0.0
    pos = np.flatnonzero(hits)
    dcg = float(np.sum(np.log(2.0) / np.log(pos + 2.0)))
    idcg = float(np.sum(np.log(2.0) / np.log(np.arange(common) + 2.0)))
    return common / k, common / len(labels), dcg / idcg


def compute_metrics_batch(
    rec: np.ndarray, labels: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized metrics over a batch.

    rec [B, K] recommended ids in rank order (-1 pad), labels [B, L] (-1 pad).
    Returns (precision [B], recall [B], ndcg [B]) with the same per-row
    definition as :func:`compute_metrics`.
    """
    rec_valid = rec >= 0
    lab_valid = labels >= 0
    k = rec_valid.sum(axis=1)  # actual recommended count per row
    n_labels = lab_valid.sum(axis=1)
    hits = (
        (rec[:, :, None] == labels[:, None, :]) & lab_valid[:, None, :]
    ).any(-1) & rec_valid  # [B, K]
    common = hits.sum(axis=1)
    # dcg over hit positions; idcg over the first `common` positions
    pos = np.arange(rec.shape[1])
    gain = np.log(2.0) / np.log(pos + 2.0)
    dcg = (hits * gain[None, :]).sum(axis=1)
    cum_ideal = np.concatenate([[0.0], np.cumsum(gain)])
    idcg = cum_ideal[common]
    nz = common > 0
    precision = np.where(nz & (k > 0), common / np.maximum(k, 1), 0.0)
    recall = np.where(nz & (n_labels > 0), common / np.maximum(n_labels, 1), 0.0)
    ndcg = np.where(nz, dcg / np.where(idcg > 0, idcg, 1.0), 0.0)
    return precision, recall, ndcg


@dataclasses.dataclass
class EvalResult:
    """Accumulator matching tdm/.../evaluation/EvalResult.scala."""

    loss: float = 0.0
    precision: float = 0.0
    recall: float = 0.0
    ndcg: float = 0.0
    count: int = 0

    def add_metrics(self, values: tuple[float, float, float]) -> None:
        self.precision += values[0]
        self.recall += values[1]
        self.ndcg += values[2]

    def merge(self, other: "EvalResult") -> "EvalResult":
        self.loss += other.loss
        self.precision += other.precision
        self.recall += other.recall
        self.ndcg += other.ndcg
        self.count += other.count
        return self

    def __str__(self) -> str:
        c = max(self.count, 1)
        return (
            f"{{eval loss: {self.loss / c:.4f}, "
            f"precision: {self.precision / c:.6f}, "
            f"recall: {self.recall / c:.6f}, "
            f"ndcg: {self.ndcg / c:.6f}}}"
        )
