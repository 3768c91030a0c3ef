"""TDM serving in plain PyTorch: the upstream Recommender's beam search over
the tree (start at the deepest level with at most ``beam`` nodes, keep the
best ``beam`` nodes of a level, score all their children, the leaves of the
last level filtered of consumed items, the best ``topk`` returned), and the
numbers that judge a served list against it.  Imports nothing of the
program."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from reference import din

NEG = -math.inf


class Scorer:
    """DIN logits of candidate codes for a batch of sequences, context kept."""

    def __init__(self, table: torch.Tensor, w: dict, seq_codes: torch.Tensor,
                 rnd: Callable | None = None):
        self.table, self.w, self.rnd = table, w, rnd or (lambda x: x)
        self.seq_e = din.gather(table, seq_codes)
        self.pad = seq_codes == din.PAD

    def __call__(self, codes: torch.Tensor) -> torch.Tensor:
        """[B, U] codes (-1 allowed, scored as a zero row) -> [B, U] logits."""
        return din.logits(din.gather(self.table, codes), self.seq_e, self.pad, self.w, self.rnd)


def beam_search(scorer: Scorer, exists: torch.Tensor, max_level: int, beam: int,
                topk: int, consumed: torch.Tensor,
                levels: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(top-k leaf codes [B, topk], their logits), -1 / -inf where fewer
    leaves are left; ``consumed`` [B, C] leaf codes to filter (-1 pads).
    A list ``levels`` receives the search's levels as ``judge_levels``
    takes them."""
    dev = exists.device
    b = consumed.shape[0]
    start = int(math.floor(math.log2(beam))) if beam > 1 else 0
    lo = (1 << start) - 1
    level = torch.arange(lo, 2 * lo + 1, device=dev)
    level = level[exists[level]]
    frontier = level[None, :].expand(b, -1)
    scores = torch.zeros(frontier.shape, device=dev)
    for _ in range(max_level - start):
        k = min(beam, frontier.shape[1])
        top = torch.topk(scores, k, dim=1).indices
        parents = torch.gather(frontier, 1, top)
        alive = torch.gather(scores, 1, top) > NEG
        if levels is not None:
            levels.append({"frontier": frontier, "scores": scores, "top": parents,
                           "alive": alive})
        kids = torch.cat([2 * parents + 1, 2 * parents + 2], dim=1)
        ok = exists[kids] & alive.repeat(1, 2)
        frontier = torch.where(ok, kids, -1)
        scores = torch.where(ok, scorer(frontier), NEG)
    if levels is not None:
        levels.append({"frontier": frontier, "scores": scores})
    gone = (frontier[:, :, None] == consumed[:, None, :]).any(-1) | (frontier < 0)
    scores = torch.where(gone, NEG, scores)
    top_s, top = torch.topk(scores, min(topk, scores.shape[1]), dim=1)
    codes = torch.gather(frontier, 1, top)
    return torch.where(top_s > NEG, codes, -1), top_s


def sibling(codes: torch.Tensor) -> torch.Tensor:
    return torch.where(codes % 2 == 1, codes + 1, codes - 1)


def judge(scorer: Scorer, exists: torch.Tensor, served: torch.Tensor, consumed: torch.Tensor,
          ref_codes: torch.Tensor, ref_scores: torch.Tensor) -> dict:
    """Numbers of served lists ``served`` [B, K] (leaf codes in served
    order, -1 pads) against the reference:

    - ``bad_items``: served entries that are no leaf, repeat an earlier one,
      are consumed, or are missing where the reference has an item;
    - ``order_gap``: the widest gap by which a served item's logit lies
      below that of a candidate the program scored beside it (a served item
      ranked lower, or an unserved, unconsumed sibling of a served item),
      the program's own last level followed;
    - ``list_miss``: the share of the reference beam search's items that
      the served lists lack, over all sampled requests (a steady number:
      the widest gap to the reference's own beam swings with every near
      tie at a beam's edge).
    """
    b, k = served.shape
    n = exists.shape[0]
    leaf_lo = (n + 1) // 2 - 1
    present = served != -1
    is_leaf = present & (served >= leaf_lo) & (served < n) & exists[served.clamp(0, n - 1)]
    tri = torch.ones(k, k, dtype=torch.bool, device=served.device).tril(-1)
    dup = ((served[:, :, None] == served[:, None, :]) & tri).any(-1) & present
    cons = (served[:, :, None] == consumed[:, None, :]).any(-1) & present
    missing = ~present & (ref_codes[:, :k] >= 0)
    bad = (present & ~is_leaf) | dup | cons | missing

    s_served = torch.where(is_leaf, scorer(torch.where(is_leaf, served, -1)), NEG)
    sib = sibling(served)
    sib_ok = is_leaf & exists[sib.clamp(0, n - 1)]
    sib_ok &= ~(sib[:, :, None] == served[:, None, :]).any(-1)
    sib_ok &= ~(sib[:, :, None] == consumed[:, None, :]).any(-1)
    s_sib = torch.where(sib_ok, scorer(torch.where(sib_ok, sib, -1)), NEG)
    order = torch.zeros(b, device=served.device)
    for r in range(k):
        # the best candidate the program scored that it did not serve at or
        # above rank r
        best = torch.cat([s_served[:, r + 1:], s_sib], dim=1).max(dim=1).values
        gap = torch.where(is_leaf[:, r] & (best > NEG), best - s_served[:, r], 0.0)
        order = torch.maximum(order, gap.clamp_min(0.0))
    ref_ok = ref_codes[:, :k] >= 0
    hit = ((ref_codes[:, :k, None] == served[:, None, :]) & is_leaf[:, None, :]).any(-1)
    miss = float((ref_ok & ~hit).sum()) / max(int(ref_ok.sum()), 1)
    return {"bad_items": int(bad.sum()), "order_gap": float(order.max()), "list_miss": miss}


def judge_levels(scorer: Scorer, exists: torch.Tensor, levels: list, beam: int) -> dict:
    """Numbers of a beam search's levels against the reference, each level
    held to what the reference makes of the searcher's previous level
    (teacher forcing: a near tie that a rounding decided the other way
    shows as a small gap, not as another search).  ``levels``: per level
    the ``frontier`` [B, W] (codes), its ``scores`` (logits; dead slots at
    or below -1e30) and, but at the last level, the ``top`` [B, beam]
    codes kept with their ``alive`` mask; the last level may carry
    ``id_codes``, the leaf codes of the item ids the searcher returned.

    - ``level_score_gap``: the widest gap between a score of the searcher
      and the reference's logit of the same candidate, over every scored
      level (K3's outputs);
    - ``level_choice_gap``: the widest gap by which a candidate the searcher
      kept scores, in the reference, below one it dropped;
    - ``level_faults``: a first level other than the start level's nodes, a
      frontier not made of the kept parents' children, a live candidate
      scored dead or a dead one scored, a level keeping other than
      ``min(beam, live candidates)`` nodes, a kept node that is no live
      candidate, a returned id at another leaf than its candidate.
    """
    n = exists.shape[0]

    def live(codes):
        return (codes >= 0) & (codes < n) & exists[codes.clamp(0, n - 1)]

    def kept_of(lv, ok):
        chosen = lv["top"].masked_fill(~lv["alive"], -2)
        kept = (lv["frontier"][:, :, None] == chosen[:, None, :]).any(-1) & ok
        faults = int((kept.sum(1) != ok.sum(1).clamp(max=beam)).sum())
        faults += int((lv["alive"] & ~(lv["top"][:, :, None] == torch.where(
            ok, lv["frontier"], -3)[:, None, :]).any(-1)).sum())
        return kept, faults

    first = levels[0]
    start = int(math.floor(math.log2(beam))) if beam > 1 else 0
    lo = (1 << start) - 1
    start_ok = live(first["frontier"])
    at_start = (first["frontier"] >= lo) & (first["frontier"] <= 2 * lo)
    _, faults = kept_of(first, start_ok)
    faults += int((start_ok & ~at_start).sum())
    faults += int((start_ok.sum(1) != int(exists[lo: 2 * lo + 1].sum())).sum())
    score_gap = choice_gap = 0.0
    with torch.no_grad():
        for prev, cur in zip(levels, levels[1:]):
            f = cur["frontier"]
            par_alive = prev["alive"].repeat(1, 2)
            kids = torch.cat([2 * prev["top"] + 1, 2 * prev["top"] + 2], dim=1)
            faults += int(((f != kids) & par_alive).sum())
            ok = par_alive & live(f)
            ref = scorer(torch.where(ok, f, -1))
            dead = cur["scores"] <= -1e30
            faults += int((ok & dead).sum() + (~ok & ~dead).sum())
            gap = torch.where(ok & ~dead, (cur["scores"] - ref).abs(), 0.0)
            score_gap = max(score_gap, float(gap.max()))
            if "top" in cur:
                kept, bad = kept_of(cur, ok)
                faults += bad
                lo = torch.where(kept, ref, math.inf).min(1).values
                hi = torch.where(ok & ~kept, ref, NEG).max(1).values
                gap = torch.where((hi > NEG) & (lo < math.inf), hi - lo, 0.0).clamp_min(0.0)
                choice_gap = max(choice_gap, float(gap.max()))
            if "id_codes" in cur:
                faults += int(((cur["id_codes"] != f) & ok).sum()
                              + ((cur["id_codes"] != -1) & ~ok).sum())
    return {"level_score_gap": score_gap, "level_choice_gap": choice_gap,
            "level_faults": faults}


def codes_of(tree, lists: list, k: int) -> np.ndarray:
    """[N, k] leaf codes (reference tree) of served item-id lists, -1 pads;
    an id outside the catalog maps to -2 (no leaf)."""
    out = np.full((len(lists), k), -1, np.int64)
    for i, items in enumerate(lists):
        items = np.asarray(items, np.int64)[:k]
        c = tree.codes(items)
        out[i, : len(items)] = np.where(c >= 0, c, -2)
    return out
