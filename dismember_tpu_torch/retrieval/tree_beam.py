"""Batched tree beam search: the classic level-synchronous serving loop.

Port of ``dismember_tpu/retrieval/tree_beam.py`` (Recommender.scala in the
reference):
- start at the level whose node count <= candidate_num, initial scores 0;
- per level: keep the top ``candidate_num`` frontier nodes by score, expand
  their children (2c+1, 2c+2), score the <= 2*candidate_num children with one
  scorer call (K1 for DIN), drop non-existent codes;
- the bottom level's frontier holds the leaves; consumed items are filtered
  and the top-k by score is returned (:func:`filter_topk`: one native host
  pass, ``csrc/serve_ops.cc``, with the numpy form as its fallback).

The levels are a Python loop over [B, 2*beam] frontiers; selection is
``torch.topk`` + ``torch.gather`` (the JAX package's one-hot select is a TPU
workaround).  ``torch.topk`` orders equal scores differently from
``lax.top_k``, so frontiers agree as sets, not as orders.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.data import native
from dismember_tpu_torch.index.arraytree import ArrayTree

NEG_INF = -3.4e38


@dataclasses.dataclass(frozen=True)
class TreeBeamConfig:
    beam: int  # candidate_num in the reference
    max_level: int
    start_level: int
    start_codes_padded: tuple[int, ...]  # codes at start level, -1 padded to 2*beam


def make_config(tree: ArrayTree, beam: int) -> TreeBeamConfig:
    start_level = int(np.floor(np.log2(beam))) if beam > 1 else 0
    start_level = min(start_level, tree.max_level)
    codes = tree.level_codes[start_level]
    width = 2 * beam
    padded = np.full(width, -1, dtype=np.int64)
    padded[: min(len(codes), width)] = codes[: min(len(codes), width)]
    return TreeBeamConfig(
        beam=beam,
        max_level=tree.max_level,
        start_level=start_level,
        start_codes_padded=tuple(int(c) for c in padded),
    )


def is_deep_catalog(tree: ArrayTree, beam: int) -> bool:
    """The packed-table serving rule: trees of ``max_level >= 8`` with a
    scored level below the beam's start level serve through the packed
    pair table; small trees stay on the classic loop rather than build a
    pair table for a toy catalog."""
    cfg = make_config(tree, beam)
    return tree.max_level >= 8 and cfg.max_level - cfg.start_level >= 1


def start_frontier(cfg: TreeBeamConfig, b: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, 2*beam] start codes, their scores: 0, or NEG_INF for padding)."""
    codes = torch.tensor(cfg.start_codes_padded, dtype=torch.long, device=device)
    frontier = codes.expand(b, -1)
    scores = torch.where(frontier >= 0, 0.0, NEG_INF).to(torch.float32)
    return frontier, scores


def select_top(frontier: torch.Tensor, scores: torch.Tensor, beam: int):
    """(top codes [B, beam], their alive mask) of a frontier."""
    top_scores, top_idx = torch.topk(scores, beam, dim=1)
    return torch.gather(frontier, 1, top_idx), top_scores > NEG_INF / 2


@torch.inference_mode()
def beam_search_batch(
    forward: Callable,
    params,
    seq_codes: torch.Tensor,  # [B, L] long
    node_meta: torch.Tensor,  # [total_codes, 2] float32 (exists, node id)
    cfg: TreeBeamConfig,
    precompute: Callable | None = None,
    apply: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (leaf item ids [B, 2*beam], scores [B, 2*beam]).

    Non-existent leaves carry id -1 and score NEG_INF.  With a (precompute,
    apply) pair the level-invariant sequence side is computed once per query
    instead of once per level."""
    b = seq_codes.shape[0]
    width = 2 * cfg.beam

    if precompute is not None and apply is not None:
        ctx = precompute(params, seq_codes)
        score_fn = lambda p, items: apply(p, items, ctx)  # noqa: E731
    else:
        score_fn = lambda p, items: forward(p, items, seq_codes)  # noqa: E731

    frontier, scores = start_frontier(cfg, b, seq_codes.device)
    max_code = node_meta.shape[0] - 1
    for _ in range(cfg.max_level - cfg.start_level):
        top_codes, top_alive = select_top(frontier, scores, cfg.beam)
        children = torch.stack(
            [2 * top_codes + 1, 2 * top_codes + 2], dim=-1
        ).reshape(b, width)
        child_alive = top_alive.repeat_interleave(2, dim=1)
        meta = node_meta[children.clamp(0, max_code)]
        exists = (meta[..., 0] > 0) & child_alive
        logits = score_fn(params, torch.where(exists, children, -1))
        frontier, scores = children, torch.where(exists, logits, NEG_INF)

    leaf_ok = scores > NEG_INF / 2
    meta = node_meta[frontier.clamp(0, max_code)]
    item_ids = torch.where(leaf_ok, meta[..., 1].long(), -1)
    return item_ids, scores


def make_beam_fn(
    forward: Callable,
    tree: ArrayTree,
    beam: int,
    precompute: Callable | None = None,
    apply: Callable | None = None,
    device="cuda",
) -> Callable:
    """``(params, seq_codes) -> (item_ids, scores)`` closure with the tree's
    node metadata resident on ``device``."""
    cfg = make_config(tree, beam)
    node_meta = torch.as_tensor(tree.node_meta, device=resolve_device(device))

    def run(params, seq_codes):
        return beam_search_batch(
            forward, params, seq_codes, node_meta, cfg,
            precompute=precompute, apply=apply,
        )

    return run


def filter_topk(
    item_ids: np.ndarray,  # [B, W]
    scores: np.ndarray,  # [B, W]
    topk: int,
    consumed: list[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """Host-side consumed filtering + final top-k per row
    (Recommender.recommendItems: filterNot consumed, sort by score desc,
    take topk), in one native pass over the batch where the serving library
    is there and the inputs are int64 ids, float32 scores and one consumed
    list a row; else in the numpy form, which gives the same lists."""
    with profiling.span("tree_beam.filter_topk"):
        lists = _filter_topk_native(item_ids, scores, topk, consumed)
        if lists is None:
            return _filter_topk_numpy(item_ids, scores, topk, consumed)
        profiling.count("tree_beam.filter_native")
        return lists


def _filter_topk_native(item_ids, scores, topk, consumed) -> list[np.ndarray] | None:
    """:func:`filter_topk` through ``native.filter_topk_native``: the lists
    as row views of one [B, k] array, or None for inputs it does not take."""
    if not (isinstance(item_ids, np.ndarray) and isinstance(scores, np.ndarray)
            and item_ids.dtype == np.int64 and scores.dtype == np.float32
            and item_ids.ndim == 2 and scores.shape == item_ids.shape
            and isinstance(topk, (int, np.integer)) and topk >= 0
            and (consumed is None or len(consumed) == len(item_ids))
            and native.get_serve_lib() is not None):
        return None
    b, w = item_ids.shape
    if consumed is None or b == 0:
        lengths = np.zeros(b, np.int64)
        flat = lengths[:0]
    else:
        lengths = np.fromiter(map(len, consumed), np.int64, count=b)
        # the numpy form's cast of each list into its int64 consumed matrix
        flat = np.concatenate(consumed, dtype=np.int64, casting="unsafe")
        if flat.ndim != 1:
            return None
    top, counts = native.filter_topk_native(
        np.ascontiguousarray(item_ids), np.ascontiguousarray(scores), flat, lengths,
        min(int(topk), w))
    lists = list(top)
    for i in np.flatnonzero(counts < top.shape[1]):
        lists[i] = top[i, : counts[i]]
    return lists


def _filter_topk_numpy(item_ids, scores, topk, consumed) -> list[np.ndarray]:
    """:func:`filter_topk` vectorized in numpy, the JAX package's form."""
    b, w = item_ids.shape
    ok = item_ids >= 0
    if consumed is not None:
        m = max((len(c) for c in consumed), default=0)
        if m > 0:
            cons = np.full((b, m), -1, dtype=item_ids.dtype)
            for i, c in enumerate(consumed):
                if len(c):
                    cons[i, : len(c)] = c
            ok &= ~(item_ids[:, :, None] == cons[:, None, :]).any(-1)
    # stable score-desc order with invalid rows pushed to the back
    sc = np.where(ok, scores, -np.inf)
    order = np.argsort(-sc, axis=1, kind="stable")[:, :topk]
    rows = np.arange(b)[:, None]
    top_ids = item_ids[rows, order]
    top_ok = ok[rows, order]
    return [top_ids[i][top_ok[i]] for i in range(b)]
