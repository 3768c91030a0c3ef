"""Vectorized hierarchical negative sampling on the device.

Port of ``dismember_tpu/train/sampler.py`` (NegativeSampler.scala in the
reference):
- per target leaf, the positives are its ancestors at every level from
  ``start_sample_level`` to ``max_level`` (NegativeSampler.scala:76-114);
- per level, ``neg_counts[level]`` negatives are drawn *without replacement*
  from the existing nodes at that level, excluding the positive, either
  uniformly or weighted by node occurrence probability;
- the per-target output unit is ``[pos, negs...]`` per level, concatenated
  over levels, with labels 1/0.

Small levels draw Gumbel-perturbed logits over the level's candidate table
and take ``torch.topk`` (exact sampling without replacement); levels larger
than ``max_exact_level`` draw an oversampled batch of uniform codes and keep
the first ``neg`` valid ones (the reference's tolerance-bounded rejection
loop, memory O(B * neg)).  Randomness comes from an explicit
``torch.Generator`` on the sampler's device; it gives other numbers than
``jax.random`` from the same seed, so the tests compare invariants and
distributions, or feed both packages one sampled batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.index.arraytree import ArrayTree

_NEG_INF = -1e30


def pack_exists_rows(node_exists: np.ndarray, device="cuda") -> torch.Tensor:
    """node_exists [N] bool -> [ceil(N/128), 128] float32 rows (the JAX
    package's layout; the port reads it with plain indexing)."""
    n = len(node_exists)
    flat = np.pad(np.asarray(node_exists, np.float32), (0, (-n) % 128))
    return torch.as_tensor(flat.reshape(-1, 128), device=resolve_device(device))


def exists_lookup(exists_rows: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Existence bits for non-negative codes of any shape."""
    return exists_rows.reshape(-1)[codes] > 0


def parse_layer_neg_counts(layer_neg_counts: str, max_level: int) -> list[int]:
    """Parse the ``layer_negative_counts`` config string.

    Mirrors MiniBatch.computeSampleUnit (tdm MiniBatch.scala:19-38): the
    string must cover all ``max_level + 1`` levels and each count must be
    strictly less than the level's capacity 2^level.
    """
    counts = [int(float(x)) for x in layer_neg_counts.split(",")]
    if len(counts) < max_level + 1:
        raise ValueError(
            f"not enough negative sample layers: need {max_level + 1}, got {len(counts)}"
        )
    for i, c in enumerate(counts[: max_level + 1]):
        if c >= 2**i:
            raise ValueError(
                f"num of negative samples must not exceed max numbers in layer {i}"
            )
    return counts[: max_level + 1]


@dataclasses.dataclass
class TreeSampler:
    """Per-tree sampling state: level candidate tables + static layout.

    Exact levels (at most ``max_exact_level`` candidates, or any level when
    sampling with probabilities): Gumbel top-k over the level's candidate
    table.  Rejection levels: oversampled uniform codes, masked for
    existence, the positive and duplicates.
    """

    max_level: int
    start_level: int
    neg_counts: list[int]  # per level (index = level), only [start..max] used
    unit: int  # rows per target = sum(1 + neg) over levels
    level_tables: list[torch.Tensor | None]  # per level: candidate codes [n_l]
    level_logits: list[torch.Tensor | None]  # per level: base logits [n_l]
    level_exact: list[bool]
    exists_rows: torch.Tensor  # [ceil(total_codes/128), 128] float32
    unit_labels: np.ndarray  # [unit] float32, 1 for positives
    oversample: int = 2
    # extra constrained draws before relaxing, as the reference's
    # model.sample_tolerance (NegativeSampler.scala:19,120)
    tolerance: int = 20

    @classmethod
    def build(
        cls,
        tree: ArrayTree,
        layer_neg_counts: str,
        start_level: int = 1,
        with_prob: bool = False,
        max_exact_level: int = 1 << 18,
        tolerance: int = 20,
        device="cuda",
    ) -> "TreeSampler":
        """Candidate tables on ``device`` (raises if CUDA is asked for and
        missing)."""
        device = resolve_device(device)
        if start_level < 1:
            raise ValueError(f"start sample level should be at least 1, got {start_level}")
        counts = parse_layer_neg_counts(layer_neg_counts, tree.max_level)
        level_tables, level_logits, level_exact = [], [], []
        labels: list[float] = []
        unit = 0
        for level in range(start_level, tree.max_level + 1):
            codes = tree.level_codes[level]
            exact = len(codes) <= max_exact_level or with_prob
            level_exact.append(exact)
            if exact:
                level_tables.append(torch.as_tensor(codes, dtype=torch.long, device=device))
                if with_prob:
                    probs = tree.node_prob[codes].astype(np.float64)
                    logits = np.log(np.maximum(probs, 1e-30))
                else:
                    logits = np.zeros(len(codes), dtype=np.float64)
                level_logits.append(torch.as_tensor(logits, dtype=torch.float32, device=device))
            else:
                level_tables.append(None)
                level_logits.append(None)
            unit += 1 + counts[level]
            labels.extend([1.0] + [0.0] * counts[level])
        return cls(
            max_level=tree.max_level,
            start_level=start_level,
            neg_counts=counts,
            unit=unit,
            level_tables=level_tables,
            level_logits=level_logits,
            level_exact=level_exact,
            exists_rows=pack_exists_rows(tree.node_exists, device),
            unit_labels=np.asarray(labels, dtype=np.float32),
            tolerance=tolerance,
        )

    def _sample_rejection(self, gen: torch.Generator, pos: torch.Tensor, level: int,
                          neg: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Oversampled uniform draws + validity/dup masking; [B, neg].

        Tolerance semantics (NegativeSampler.scala:116-144): one pool of
        ``2*neg + tolerance + 8`` draws ranked strict-valid first (exists, not
        the positive, no duplicate), then relaxed-valid (exists, no
        duplicate); the first ``neg`` win.  A slot is zero-weighted (code -1)
        only if even relaxed draws ran out."""
        b = pos.shape[0]
        m = self.oversample * neg + self.tolerance + 8
        lo, hi = (1 << level) - 1, (1 << (level + 1)) - 1
        dev = pos.device
        cand = torch.randint(lo, hi, (b, m), generator=gen, device=dev)
        exists = exists_lookup(self.exists_rows, cand)
        not_pos = cand != pos[:, None]
        # first-occurrence mask within the row (O(m^2) compare; m is small)
        eq = cand[:, :, None] == cand[:, None, :]
        tri = torch.ones(m, m, dtype=torch.bool, device=dev).tril(-1)
        dup = (eq & tri).any(-1)
        ok_strict = exists & not_pos & ~dup
        ok_relaxed = exists & ~dup
        arange = torch.arange(m, device=dev).expand(b, m)
        rank = torch.where(ok_strict, arange,
                           torch.where(ok_relaxed, m + arange, 2 * m + arange))
        order = torch.argsort(rank, dim=1, stable=True)[:, :neg]
        picked_ok = torch.gather(ok_relaxed, 1, order)
        picked = torch.gather(cand, 1, order)
        return torch.where(picked_ok, picked, -1), picked_ok.float()

    def sample(
        self, gen: torch.Generator, target_codes: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Draw the per-level positives + negatives for a batch of targets.

        target_codes: [B] bottom-level leaf codes (long, on the sampler's
        device).  Returns (codes [B, U] long, labels [B, U], weights [B, U]);
        weights are 0 for unfillable slots (code -1)."""
        with profiling.span("sampler.sample"):
            b = target_codes.shape[0]
            dev = target_codes.device
            parts_codes: list[torch.Tensor] = []
            parts_weights: list[torch.Tensor] = []
            for i, level in enumerate(range(self.start_level, self.max_level + 1)):
                neg = self.neg_counts[level]
                # ancestor of the bottom-level code at `level`
                pos = ((target_codes + 1) >> (self.max_level - level)) - 1  # [B]
                parts_codes.append(pos[:, None])
                parts_weights.append(torch.ones(b, 1, device=dev))
                if neg == 0:
                    continue
                if self.level_exact[i]:
                    table, base = self.level_tables[i], self.level_logits[i]
                    u = torch.rand(b, table.shape[0], generator=gen, device=dev)
                    g = -torch.log(-torch.log(u.clamp_(min=1e-20)))
                    logits = base[None, :] + g
                    logits = torch.where(table[None, :] == pos[:, None], _NEG_INF, logits)
                    picked_logits, idx = torch.topk(logits, neg, dim=1)
                    ok = picked_logits > _NEG_INF / 2
                    parts_codes.append(torch.where(ok, table[idx], -1))
                    parts_weights.append(ok.float())
                else:
                    codes, ok = self._sample_rejection(gen, pos, level, neg)
                    parts_codes.append(codes)
                    parts_weights.append(ok)
            codes = torch.cat(parts_codes, dim=1)
            weights = torch.cat(parts_weights, dim=1)
            return codes, self._labels(dev).expand(b, self.unit), weights

    def _labels(self, dev: torch.device) -> torch.Tensor:
        """``unit_labels`` on ``dev``, uploaded once: a copy from pageable
        host memory each step would make the host wait for the card."""
        t = self.__dict__.get("_labels_dev")
        if t is None or t.device != dev:
            t = self._labels_dev = torch.as_tensor(self.unit_labels, device=dev)
        return t
