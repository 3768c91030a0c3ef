"""DIN (Zhou et al., arXiv:1706.06978, as the upstream dismember's DIN.scala
builds it) in plain PyTorch: the benchmark's reference scorer.

One embedding table over all tree-node codes, shared by the candidate and
the behaviour sequence.  Attention: Q = candidate, K = V = sequence, scores
scaled by 1/sqrt(E), padded positions set to the float32 minimum before the
softmax, then a bias-free Linear(E, E); concat([item, attention]) ->
Linear(2E, E) -> ReLU -> Linear(E, 1) is the logit.  Weights are applied as
``x @ W.T``.  ``rnd`` rounds every matmul operand (identity for float32;
the controls pass a lower precision).  Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

F32_MIN = float(torch.finfo(torch.float32).min)
PAD = -1  # the code of a padded position: a zero row, no gradient


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``codes`` (any shape), zero rows at PAD."""
    ok = codes != PAD
    return table[torch.where(ok, codes, 0)] * ok[..., None].to(table.dtype)


def logits(item_e: torch.Tensor, seq_e: torch.Tensor, pad: torch.Tensor, w: dict,
           rnd: Callable[[torch.Tensor], torch.Tensor] = _same) -> torch.Tensor:
    """[B, U, E] candidates, [B, L, E] sequence, [B, L] bool padding ->
    [B, U] logits."""
    e = item_e.shape[-1]
    s = torch.einsum("bue,ble->bul", rnd(item_e), rnd(seq_e)) / math.sqrt(e)
    s = torch.where(pad[:, None, :], F32_MIN, s)
    p = torch.softmax(s, dim=-1)
    att = torch.einsum("bul,ble->bue", rnd(p), rnd(seq_e))
    att = rnd(att) @ rnd(w["att_w"]).T
    h = rnd(item_e) @ rnd(w["w1"][:, :e]).T + rnd(att) @ rnd(w["w1"][:, e:]).T + w["b1"]
    h = torch.relu(h)
    return (rnd(h) @ rnd(w["w2"]).T)[..., 0] + w["b2"][0]


def bce(x: torch.Tensor, z: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Weighted mean binary cross-entropy with logits (weight 0 leaves an
    element out of the sum and the count)."""
    per = torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return (per * wt).sum() / torch.clamp_min(wt.sum(), 1.0)
