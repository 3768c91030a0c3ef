"""Deep Retrieval serving in plain PyTorch, float32 with TF32 off, and the
numbers that judge a served list and a served beam against it.  Imports
nothing of the program.

The model (Gao et al., "Deep Retrieval: Learning a Retrievable Structure for
Large-Scale Recommendations", arXiv 2007.07203; the upstream
DeepRetrieval.scala:26-46, LayerModel.scala, RerankModel.scala):

- layer d (0 <= d < D) is a softmax over the K nodes of
  ``Linear((L + d) E -> K)`` applied to the window's L item embeddings
  followed by the embeddings of the path's first d nodes, flattened;
- a path's probability is the product of its layers' softmaxes; the beam
  keeps the ``beam`` largest joint probabilities at each layer;
- the candidates are the union of the items on the kept paths;
- the rerank user vector is ``Linear(L E -> E)`` of the flattened window's
  rerank embeddings; item i scores ``w_i . u + b_i``;
- consumed items are left out, then the ``topk`` best are kept.

Departures from the paper, each the upstream's: the layer's network is the
single linear map above (the paper allows an MLP); the user is the flattened
window of item embeddings, a padding position (id -1) a zero row; the node
embedding of depth i is row ``num_items + i K + node`` of the layer table;
the first layer keeps min(beam, K) paths.  Departure from the program: no
path holds at most a fixed number of items here (the program cuts a path at
its ``max_items_per_path``), so a check against this reference requires the
program's truncated-path count to be 0.  Ties are broken by ``torch.topk``.

``rnd`` (a rounding, e.g. to float8) is applied where the program serves
bf16 operands: the window's rows, the user vector, the items' weights and
biases; it makes the control that must fail.  The path->items map is built
here from the item->paths mapping by one sort.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

NEG = -math.inf


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def path_keys(paths: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[..., D] nodes -> [...] base-K keys."""
    key = torch.zeros(paths.shape[:-1], dtype=torch.long, device=paths.device)
    for d in range(paths.shape[-1]):
        key = key * num_nodes + paths[..., d].long()
    return key


class PathMap:
    """Path key -> items: the (item, path) pairs sorted by key."""

    def __init__(self, item_paths: torch.Tensor, num_nodes: int):
        n, j, _ = item_paths.shape
        keys = path_keys(item_paths, num_nodes).reshape(-1)
        items = torch.arange(n, device=keys.device).repeat_interleave(j)
        self.keys, order = torch.sort(keys, stable=True)
        self.items = items[order]
        self.width = int(torch.unique_consecutive(self.keys, return_counts=True)[1].max())
        self.num_nodes = num_nodes

    def items_of(self, paths: torch.Tensor) -> torch.Tensor:
        """[B, W, D] paths -> [B, W * width] their items, each row's
        repeats and the padding -1."""
        q = path_keys(paths, self.num_nodes)
        lo = torch.searchsorted(self.keys, q)
        hi = torch.searchsorted(self.keys, q, right=True)
        at = lo[..., None] + torch.arange(self.width, device=q.device)
        got = torch.where(at < hi[..., None], self.items[at.clamp(max=len(self.items) - 1)], -1)
        got = torch.sort(got.reshape(len(paths), -1), dim=1).values
        repeat = torch.zeros_like(got, dtype=torch.bool)
        repeat[:, 1:] = got[:, 1:] == got[:, :-1]
        return torch.where(repeat, -1, got)


def window_rows(table: torch.Tensor, seqs: torch.Tensor, rnd: Callable = _same) -> torch.Tensor:
    """[B, L] ids (-1 pads) -> [B, L * E] flattened rows, a pad a zero row."""
    ok = (seqs >= 0)[..., None]
    return (rnd(table[seqs.clamp_min(0)]) * ok).reshape(len(seqs), -1)


@torch.no_grad()
def path_beam(layer: dict, seqs: torch.Tensor, beam: int, num_items: int, num_nodes: int,
              rnd: Callable = _same) -> tuple[torch.Tensor, torch.Tensor]:
    """(paths [B, W, D], joint probabilities [B, W]) of the beam, W =
    min(beam, K^D)."""
    _exact()
    emb, heads = layer["embedding"], layer["heads"]
    x = window_rows(emb, seqs, rnd)  # [B, L E]
    b = len(seqs)
    probs, nodes = torch.topk(torch.softmax(x @ heads[0]["weight"].T + heads[0]["bias"], -1),
                              min(beam, num_nodes), dim=1)
    paths = nodes[:, :, None]
    for d in range(1, len(heads)):
        w = paths.shape[1]
        rows = num_items + torch.arange(d, device=seqs.device) * num_nodes + paths
        feat = torch.cat([x[:, None, :].expand(b, w, -1), emb[rows].reshape(b, w, -1)], -1)
        joint = probs[:, :, None] * torch.softmax(feat @ heads[d]["weight"].T + heads[d]["bias"],
                                                  -1)
        probs, top = torch.topk(joint.reshape(b, -1), min(beam, w * num_nodes), dim=1)
        parents = torch.gather(paths, 1, (top // num_nodes)[:, :, None].expand(-1, -1, d))
        paths = torch.cat([parents, (top % num_nodes)[:, :, None]], 2)
    return paths, probs


def user_vectors(rerank: dict, seqs: torch.Tensor, rnd: Callable = _same) -> torch.Tensor:
    """[B, L] -> [B, E]."""
    _exact()
    lin = rerank["linear"]
    return window_rows(rerank["embedding"], seqs, rnd) @ lin["weight"].T + lin["bias"]


def logits(rerank: dict, u: torch.Tensor, items: torch.Tensor,
           rnd: Callable = _same) -> torch.Tensor:
    """[B, E] user vectors against items [B, C] -> [B, C] logits; -inf at
    a -1."""
    safe = items.clamp_min(0)
    s = (rnd(rerank["softmax_w"][safe]) * rnd(u)[:, None, :]).sum(-1)
    s = s + rnd(rerank["softmax_b"][safe])
    return torch.where(items >= 0, s, NEG)


def consumed_mask(items: torch.Tensor, consumed: torch.Tensor) -> torch.Tensor:
    """[B, C] bool: the item is among the row's consumed ids [B, Cc]."""
    return (items[:, :, None] == consumed[:, None, :]).any(-1) & (items >= 0)


@torch.no_grad()
def serve(layer: dict, rerank: dict, pmap: PathMap, seqs: torch.Tensor, consumed: torch.Tensor,
          beam: int, topk: int, num_items: int, rnd: Callable = _same) -> dict:
    """The reference's answer for windows ``seqs`` [B, L] with consumed ids
    [B, C] (-1 pads): ``paths`` [B, W, D] of the beam, ``ids`` [B, topk]
    (-1 where fewer items are left) and their ``logits``."""
    paths, _ = path_beam(layer, seqs, beam, num_items, pmap.num_nodes, rnd)
    cand = pmap.items_of(paths)
    s = logits(rerank, user_vectors(rerank, seqs, rnd), cand, rnd)
    s = torch.where(consumed_mask(cand, consumed), NEG, s)
    top_s, top = torch.topk(s, min(topk, s.shape[1]), dim=1)
    ids = torch.where(top_s > NEG, torch.gather(cand, 1, top), -1)
    if ids.shape[1] < topk:
        ids = torch.nn.functional.pad(ids, (0, topk - ids.shape[1]), value=-1)
    return {"paths": paths, "ids": ids}


@torch.no_grad()
def judge(rerank: dict, pmap: PathMap, seqs: torch.Tensor, consumed: torch.Tensor,
          served: torch.Tensor, ref: dict, num_items: int,
          served_paths: torch.Tensor | None = None) -> dict:
    """Numbers of served lists ``served`` [B, k] (dense ids in served order,
    -1 pads) against the reference's answer ``ref`` (``serve``'s) for the
    same windows; ``served_paths`` [B, W, D], the program's own beam where
    it was recorded.

    - ``bad_items``: entries outside the catalog, repeated in a row,
      consumed, missing where the reference has an item at that rank, or
      (with ``served_paths``) on none of the program's paths;
    - ``order_gap``: the widest gap by which a served item's logit lies
      below that of an item served after it or (with ``served_paths``) of
      an unserved, unconsumed item on the program's paths: what the
      program scored beside it;
    - ``list_miss``: the share of the reference's items that the served
      lists lack, over all rows (a rank-by-rank gap swings with near ties);
    - ``path_miss`` (with ``served_paths``): the share of the reference
      beam's paths missing from the program's beam, over all rows.
    """
    b, k = served.shape
    u = user_vectors(rerank, seqs)
    present = served != -1
    inside = present & (served >= 0) & (served < num_items)
    tri = torch.ones(k, k, dtype=torch.bool, device=served.device).tril(-1)
    dup = ((served[:, :, None] == served[:, None, :]) & tri).any(-1) & present
    bad = (present & ~inside) | dup | consumed_mask(served, consumed)
    bad |= ~present & (ref["ids"][:, :k] >= 0)
    ids = torch.where(inside, served, -1)
    s_served = logits(rerank, u, ids)
    others = s_served.new_full((b, 1), NEG)
    out = {}
    if served_paths is not None:
        cand = pmap.items_of(served_paths)
        on_path = (ids[:, :, None] == cand[:, None, :]).any(-1)
        bad |= inside & ~on_path
        free = (cand >= 0) & ~consumed_mask(cand, consumed) & ~(
            cand[:, :, None] == ids[:, None, :]).any(-1)
        others = torch.where(free, logits(rerank, u, cand), NEG)
        ref_keys = path_keys(ref["paths"], pmap.num_nodes)
        got_keys = path_keys(served_paths, pmap.num_nodes)
        missing = ~(ref_keys[:, :, None] == got_keys[:, None, :]).any(-1)
        out["path_miss"] = float(missing.sum()) / max(ref_keys.numel(), 1)
    order = torch.zeros(b, device=served.device)
    for r in range(k):
        best = torch.cat([s_served[:, r + 1:], others], 1).max(1).values
        gap = torch.where(inside[:, r] & (best > NEG), best - s_served[:, r], 0.0)
        order = torch.maximum(order, gap.clamp_min(0.0))
    ref_ok = ref["ids"][:, :k] >= 0
    hit = (ref["ids"][:, :k, None] == ids[:, None, :]).any(-1)
    out.update({"bad_items": int(bad.sum()), "order_gap": float(order.max()) if b else 0.0,
                "list_miss": float((ref_ok & ~hit).sum()) / max(int(ref_ok.sum()), 1)})
    return out
