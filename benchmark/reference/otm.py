"""OTM's frozen part in plain PyTorch (Zhuo et al., arXiv:2006.15408, as the
upstream OTMTree builds it): the beam trajectory of a batch over the
complete tree (start at level floor(log2(beam)), at each level both
children of the ``beam`` best nodes), the optimal pseudo targets built
bottom up (Algorithm 1: a target's label passes to its parent when the
target scores at least its sibling, else the sibling's label does; labels
of one parent summed and clipped to 1), and the level labels (a node's
label is the clipped sum of the target labels it matches).

``judge_batch`` holds a program's batch to it level by level from the
program's own state (its previous level's nodes, its lower level's
targets), so that a near tie decided the other way by rounding shows as a
small gap and not as a different batch.  ``run_batch`` computes a whole
batch itself, for a control put in the program's place.  Imports nothing
of the program.
"""

from __future__ import annotations

import math

import torch

NEG = -math.inf
BIG = 2**62


def start_nodes(start_level: int, beam: int, device) -> torch.Tensor:
    """[2 * beam] codes of the first scored level: both children of every
    node of ``start_level``, -1 padded."""
    lo = (1 << start_level) - 1
    parents = torch.arange(lo, 2 * lo + 1, device=device)
    kids = torch.stack([2 * parents + 1, 2 * parents + 2], -1).reshape(-1)
    out = torch.full((2 * beam,), -1, dtype=torch.long, device=device)
    out[: len(kids)] = kids[: 2 * beam]
    return out


def expand(nodes: torch.Tensor, scores: torch.Tensor, beam: int) -> torch.Tensor:
    """Both children of the ``beam`` best nodes of each row."""
    top = torch.topk(torch.where(nodes >= 0, scores, NEG), beam, dim=1).indices
    par = torch.gather(nodes, 1, top)
    return torch.stack([2 * par + 1, 2 * par + 2], -1).reshape(nodes.shape[0], -1)


def sibling(ids: torch.Tensor) -> torch.Tensor:
    return torch.where(ids >= 0, torch.where(ids % 2 == 1, ids + 1, ids - 1), -1)


def pseudo_up(ids: torch.Tensor, labels: torch.Tensor, pos_s: torch.Tensor,
              neg_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The parent level of a target set: (ids [B, J], each parent once,
    -1 elsewhere; labels), from the targets' scores ``pos_s`` and their
    siblings' ``neg_s``."""
    valid = ids >= 0
    sib = sibling(ids)
    # the sibling's label where the sibling is itself a target
    match = (sib[:, :, None] == ids[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    sib_label = (match.to(labels.dtype) * labels[:, None, :]).sum(-1)
    contrib = torch.where(valid, torch.where(pos_s >= neg_s, labels, sib_label), 0.0)
    parent = torch.where(valid, (ids - 1) // 2, BIG)
    key, order = torch.sort(parent, dim=1, stable=True)
    c = torch.gather(contrib, 1, order)
    same = key[:, :, None] == key[:, None, :]
    total = (same.to(c.dtype) * c[:, None, :]).sum(-1)
    first = torch.ones_like(key, dtype=torch.bool)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    keep = first & (key != BIG)
    return torch.where(keep, key, -1), torch.where(keep, total.clamp(0.0, 1.0), 0.0)


def canon(ids: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A target set in one order: ids ascending, -1 last, labels beside."""
    key, order = torch.sort(torch.where(ids >= 0, ids, BIG), dim=1, stable=True)
    return torch.where(key == BIG, -1, key), torch.gather(labels, 1, order)


def level_labels(nodes: torch.Tensor, t_ids: torch.Tensor, t_labels: torch.Tensor):
    """(codes with -1 at pads, labels, weights) of one level step."""
    valid = nodes >= 0
    eq = (nodes[:, :, None] == t_ids[:, None, :]) & (t_ids >= 0)[:, None, :]
    labels = (eq.to(t_labels.dtype) * t_labels[:, None, :]).sum(-1).clamp(0.0, 1.0)
    return torch.where(valid, nodes, -1), labels, valid.to(t_labels.dtype)


def run_batch(f, seq: torch.Tensor, targets: torch.Tensor, n_levels: int, start_level: int,
              beam: int) -> dict:
    """A whole batch by the follower ``f`` (its trajectory, pseudo targets
    and level steps), recorded as a program's batch is."""
    with torch.no_grad():
        nodes = [start_nodes(start_level, beam, seq.device).expand(seq.shape[0], -1)]
        for _ in range(n_levels - 1):
            nodes.append(expand(nodes[-1], f.logits(seq, nodes[-1]), beam))
        ids, labels = [targets], [(targets >= 0).float()]
        for _ in range(n_levels - 1):
            i, l = ids[-1], labels[-1]
            pi, pl = pseudo_up(i, l, f.logits(seq, i), f.logits(seq, sibling(i)))
            ids.append(pi)
            labels.append(pl)
    rec = {"seq": seq, "targets": targets, "nodes": torch.stack(nodes),
           "t_ids": torch.stack(ids[::-1]), "t_labels": torch.stack(labels[::-1]), "levels": []}
    for k in range(n_levels):
        codes, lab, wt = level_labels(rec["nodes"][k], rec["t_ids"][k], rec["t_labels"][k])
        loss = f.step(seq, codes, lab, wt)
        rec["levels"].append({"codes": codes, "labels": lab, "weights": wt, "loss": loss})
    return rec


def frozen_codes(rec: dict) -> torch.Tensor:
    """Every code a batch's check scores or steps on."""
    parts = [rec["seq"], rec["targets"], rec["nodes"], rec["t_ids"], sibling(rec["t_ids"])]
    return torch.cat([p.reshape(-1) for p in parts])


def judge_batch(f, rec: dict, start_level: int, beam: int) -> dict:
    """A program's batch against the follower's frozen weights (call before
    the batch's steps): ``traj_gap`` (the widest gap by which a parent the
    program kept scores below one it dropped), ``pseudo_gap`` (on every
    target row the program built otherwise than the reference would from
    the program's lower level, the smallest margin between a target's and
    its sibling's scores: what a rounding had to flip), and
    ``structure_faults`` (a first level, a level not made of kept parents'
    children, a bottom target set, or level labels other than the rules
    give)."""
    seq, nodes, t_ids, t_lab = rec["seq"], rec["nodes"], rec["t_ids"], rec["t_labels"]
    n_levels, b, w = nodes.shape
    faults = int((nodes[0] != start_nodes(start_level, beam, seq.device)).sum())
    traj = 0.0
    with torch.no_grad():
        for k in range(1, n_levels):
            prev, cur = nodes[k - 1], nodes[k]
            s = torch.where(prev >= 0, f.logits(seq, prev), NEG)
            par = (cur[:, 0::2] - 1) // 2
            faults += int(((cur[:, 0::2] % 2 != 1) | (cur[:, 1::2] != cur[:, 0::2] + 1)).sum())
            kept = (prev[:, :, None] == par[:, None, :]).any(-1) & (prev >= 0)
            faults += int(((par[:, :, None] == prev[:, None, :]) & (prev >= 0)[:, None, :])
                          .any(-1).logical_not().sum())
            faults += int((kept.sum(1) != par.shape[1]).sum())
            lo = torch.where(kept, s, math.inf).min(1).values
            hi = torch.where(~kept & (prev >= 0), s, NEG).max(1).values
            gap = torch.where((hi > NEG) & (lo < math.inf), hi - lo, 0.0).clamp_min(0.0)
            traj = max(traj, float(gap.max()))
        faults += int((t_ids[-1] != rec["targets"]).sum())
        faults += int((t_lab[-1] != (rec["targets"] >= 0).float()).sum())
        pseudo = 0.0
        for i in range(n_levels - 2, -1, -1):
            ids, lab = t_ids[i + 1], t_lab[i + 1]
            pos_s, neg_s = f.logits(seq, ids), f.logits(seq, sibling(ids))
            r_ids, r_lab = canon(*pseudo_up(ids, lab, pos_s, neg_s))
            p_ids, p_lab = canon(t_ids[i], t_lab[i])
            bad = ((r_ids != p_ids) | (r_lab != p_lab)).any(1)
            if bool(bad.any()):
                margin = torch.where(ids >= 0, (pos_s - neg_s).abs(), math.inf).min(1).values
                pseudo = max(pseudo, float(margin[bad].max()))
        for k, lv in enumerate(rec["levels"]):
            codes, lab, wt = level_labels(nodes[k], t_ids[k], t_lab[k])
            faults += int(((lv["codes"] != codes) | (lv["labels"] != lab)
                           | (lv["weights"] != wt)).sum())
    return {"traj_gap": traj, "pseudo_gap": pseudo, "structure_faults": faults}
