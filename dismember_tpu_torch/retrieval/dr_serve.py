"""On-device Deep Retrieval serving: path beam -> items -> rerank -> top-k.

Port of ``dismember_tpu/retrieval/dr_serve.py``.  The reference serves one
query at a time through host dicts (DeepRetrieval.recommend:26-46); here
the inverted path->items map lives on the device:

- ``path_table``: dense [K^D] int32 of row indices (-1 = empty path), so a
  path's base-K key indexes it directly;
- ``path_items``: [n_paths, M] item ids (-1 pad), at most
  ``max_items_per_path`` a path, an overflowing path keeping the items of
  highest ``item_priority`` (training-target counts).

A batch is then path beam search, key lookup, one row gather, rerank
scoring of the [B, beam*M] candidates, in-row dedup (an item on several
retrieved paths counts once), the optional consumed filter and top-k.

``rerank_table`` picks what the rerank reads, and the port keeps each
route's arithmetic (what is rounded to bf16, where):

- ``"exact"``: f32 rows of the live params;
- ``"packed"``: the weights and the bias rounded to bf16, one [N, E+1] row
  an item, products and sums in f32;
- ``"block"``: one path-major bf16 row a path holding its items' slots
  (weights | bias | 4 base-256 id digits | valid, ``ops/dr_rerank.py``'s
  block format), gathered once a beam path; the sequence side reads a bf16
  [V, 2E] pack of both item embeddings.  The score of a slot is an f32
  multiply-add over the E weight planes in order l = 0..E-1 against the
  bf16-rounded user vector, plus the bias; dedup is top-(k*J) followed by
  masking every later copy of an id, exact because an item's copies carry
  identical scores (the same stored row, the same arithmetic), whatever
  order ``torch.topk`` gives ties.  What follows the path beam (keys,
  lookup, row reads, scores, consumed filter, dedup, top-k) is one CUDA
  kernel on the card, its plain chain on the CPU (both ``ops/dr_rerank.py``);
  the route is served packed instead where the block table would pass
  8 GB, the width has no slot, or on the card the kernel does not take the
  width, the beam or k (``dr_rerank.takes``);
- ``"auto"``: block at 2^18 items or more, exact below.

The JAX package's TPU layout workarounds are not ported: the path table
stays a flat int32 gather (not [S/128, 128] rows with a one-hot lane
select), and block slots are item-major (the same rows as its plane-major
lanes).  The bf16 tables (packed, block, seq pack) are built once, when
the closure is built, and the closure reads the heads and the node
embeddings live, as the JAX package's does; ``DRServing`` caches closures,
so it serves the tables of the moment it first served.  The exact and
packed routes launch no kernel: their products are small matmuls and a
16-term multiply-add.

Spans and counters (``core/profiling.py``, off by default): what follows
the path beam in a closure (path keys, row gather, scores, dedup, filter,
top-k) is the span ``dr_serve.rerank``; building a path map adds its
truncated paths to the counter ``dr_serve.truncated_paths``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dismember_tpu_torch.core import profiling
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.index.paths import PathIndex
from dismember_tpu_torch.models.dr_models import rerank_user_vector
from dismember_tpu_torch.ops import dr_rerank
from dismember_tpu_torch.ops.dr_rerank import consumed_hit, path_keys_and_dedup, top_items
from dismember_tpu_torch.retrieval.path_beam import path_beam_search

_PACKED_RERANK_MIN_ITEMS = 1 << 18
_BLOCK_TABLE_MAX_BYTES = 8 << 30
_SENTINEL = 2**30


@dataclasses.dataclass
class DevicePathMap:
    path_table: torch.Tensor  # [K^D] int32 row index or -1
    path_items: torch.Tensor  # [n_paths, M] int32 item ids, -1 pad
    num_nodes: int
    truncated_paths: int  # paths that overflowed M (items dropped)

    @classmethod
    def build(cls, index: PathIndex, max_items_per_path: int = 128,
              max_table: int = 1 << 24, item_priority: np.ndarray | None = None,
              device="cuda") -> "DevicePathMap | None":
        """The JAX package's arrays, built with numpy sorts instead of its
        loop over ``path_to_items``: rows in first-occurrence order of the
        paths over (item, j), each row's items in that order, and an
        overflowing path's items ordered by descending ``item_priority``
        (stable) before the cut.  None when K^D passes ``max_table``."""
        dev = resolve_device(device)
        k, d, j = index.num_nodes, index.num_layers, index.num_paths_per_item
        size = k**d
        if size > max_table:
            return None
        keys = index.path_key_of(index.item_paths).reshape(-1)  # (item, j) order
        items = np.repeat(np.arange(index.num_items, dtype=np.int64), j)
        uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
        n_paths = len(uniq)
        order_u = np.argsort(first, kind="stable")  # rows by first occurrence
        row_of_u = np.empty(n_paths, np.int64)
        row_of_u[order_u] = np.arange(n_paths)
        row = row_of_u[inv.reshape(-1)]
        counts = np.bincount(row, minlength=n_paths)
        m = min(max_items_per_path, int(counts.max()) if len(counts) else 1)
        prio = np.zeros(len(row), np.int64)
        over = counts[row] > m
        if item_priority is not None:
            prio = np.where(over, -np.asarray(item_priority)[items], 0)
        order = np.lexsort((np.arange(len(row)), prio, row))
        r_s, it_s = row[order], items[order]
        rank = np.arange(len(r_s)) - (np.cumsum(counts) - counts)[r_s]
        keep = rank < m
        path_items = np.full((max(n_paths, 1), m), -1, np.int32)
        path_items[r_s[keep], rank[keep]] = it_s[keep]
        table = np.full(size, -1, np.int32)
        table[uniq[order_u]] = np.arange(n_paths, dtype=np.int32)
        truncated = int((counts > m).sum())
        profiling.count("dr_serve.truncated_paths", truncated)
        return cls(path_table=torch.as_tensor(table, device=dev),
                   path_items=torch.as_tensor(path_items, device=dev),
                   num_nodes=k, truncated_paths=truncated)


def train_frequency_priority(trainer) -> np.ndarray | None:
    """Per-item training-target counts as the truncation priority for
    ``DevicePathMap.build`` (None when the trainer carries no data)."""
    data = getattr(trainer, "data", None)
    targets = getattr(data, "train_targets", None)
    if targets is None or len(targets) == 0:
        return None
    return np.bincount(np.asarray(targets, np.int64), minlength=data.num_items)


def _pack_rerank_table(softmax_w: torch.Tensor, softmax_b: torch.Tensor) -> torch.Tensor:
    """[N, E] weights + [N] bias -> [N, E+1] bf16 rows (lane E = bias)."""
    return torch.cat([softmax_w, softmax_b[:, None]], 1).to(torch.bfloat16)


def build_seq_pack(layer_emb: torch.Tensor, rerank_emb: torch.Tensor) -> torch.Tensor:
    """[V(+nodes), E] layer + [V, E] rerank item embeddings -> one [V, 2E]
    bf16 table (lanes 0:E layer, E:2E rerank)."""
    v = rerank_emb.shape[0]
    return torch.cat([layer_emb[:v], rerank_emb], 1).to(torch.bfloat16)


def window_parts(srows: torch.Tensor, layer_params, rerank_params, e: int):
    """The window's side of a block route from its seq-pack rows [B, L, 2E]
    f32 (zeros at padding): each head's sequence part (the path beam's
    ``seq_parts``) and the rerank user vector [B, E]."""
    b, l_seq = srows.shape[:2]
    layer_flat = srows[:, :, :e].reshape(b, l_seq * e)
    seq_parts = [layer_flat @ h["weight"][:, : l_seq * e].T for h in layer_params["heads"]]
    lin = rerank_params["linear"]
    user_vec = srows[:, :, e:].reshape(b, l_seq * e) @ lin["weight"].T + lin["bias"]
    return seq_parts, user_vec


def make_dr_serving_fn(trainer, beam: int | None = None, topk: int | None = None,
                       max_items_per_path: int = 128, rerank_table: str = "auto"):
    """``fn(layer_params, rerank_params, seqs[, consumed]) -> (item ids
    [B, topk] int64, scores [B, topk] f32)`` on the trainer's device, or
    None when the dense path table does not fit.  ``seqs`` [B, L] and
    ``consumed`` [B, C] (-1 pads) are tensors on that device."""
    dev = trainer.device
    dmap = DevicePathMap.build(trainer.path_index, max_items_per_path,
                               item_priority=train_frequency_priority(trainer), device=dev)
    if dmap is None:
        return None
    beam = beam or trainer.beam
    m = dmap.path_items.shape[1]
    # the candidate pool is beam * M wide; fewer than k candidates give -1
    k = min(topk or trainer.topk, beam * m)
    num_items, num_nodes = trainer.data.num_items, trainer.num_nodes
    num_layers = trainer.num_layers
    e = int(trainer.rerank_params["softmax_w"].shape[1])

    if rerank_table not in ("auto", "exact", "packed", "block"):
        raise ValueError(f"unknown rerank_table {rerank_table!r}")
    if rerank_table == "auto":
        rerank_table = "block" if num_items >= _PACKED_RERANK_MIN_ITEMS else "exact"
    geom = None
    if rerank_table == "block":
        geom = dr_rerank.block_geometry(e, m)
        if (geom is None
                or dmap.path_items.shape[0] * geom[0] * geom[1] * 2 > _BLOCK_TABLE_MAX_BYTES
                or not dr_rerank.takes(dmap.path_table.device, e, beam, k)):
            rerank_table = "packed"
    if rerank_table == "block":
        fn = _make_block_serving_fn(trainer, dmap, beam, k, geom)
        fn.route = "block"
        return fn

    packed_wb = None
    if rerank_table == "packed":
        packed_wb = _pack_rerank_table(trainer.rerank_params["softmax_w"],
                                       trainer.rerank_params["softmax_b"])

    @torch.no_grad()
    def fn(layer_params, rerank_params, seqs, consumed=None):
        b = seqs.shape[0]
        paths, _ = path_beam_search(layer_params, seqs, beam, num_items, num_nodes, num_layers)
        with profiling.span("dr_serve.rerank"):
            keys, _ = path_keys_and_dedup(paths, num_nodes)
            rows = dmap.path_table[keys].long()  # [B, beam]
            cand = torch.where((rows >= 0)[:, :, None], dmap.path_items[rows.clamp_min(0)],
                               -1).reshape(b, beam * m).long()
            # in-row dedup: value-sort (invalid -> a sentinel at the back),
            # keep the first occurrence of each item
            cs = torch.sort(torch.where(cand >= 0, cand, _SENTINEL), dim=1).values
            first = torch.ones_like(cs, dtype=torch.bool)
            first[:, 1:] = cs[:, 1:] != cs[:, :-1]
            ok = (cs < _SENTINEL) & first
            cs = torch.where(ok, cs, -1)
            if consumed is not None:
                ok &= ~consumed_hit(cs, consumed.long())
            user_vec = rerank_user_vector(rerank_params, seqs)
            safe = cs.clamp_min(0)
            if packed_wb is not None:
                rows_wb = packed_wb[safe].float()  # [B, C, E+1]
                w, bias = rows_wb[..., :e], rows_wb[..., e]
            else:
                w, bias = rerank_params["softmax_w"][safe], rerank_params["softmax_b"][safe]
            scores = torch.einsum("be,bce->bc", user_vec, w) + bias
            return top_items(torch.where(ok, scores, dr_rerank.NEG_INF), cs, k)

    fn.route = rerank_table
    fn._dmap = dmap
    return fn


def _make_block_serving_fn(trainer, dmap: DevicePathMap, beam: int, k: int, geom):
    """Path-major block serving (see the module docstring)."""
    num_items, num_nodes = trainer.data.num_items, trainer.num_nodes
    num_layers = trainer.num_layers
    e = int(trainer.rerank_params["softmax_w"].shape[1])
    j_paths = max(1, int(getattr(trainer, "num_paths", 1)))
    planes_n, m_pad = geom
    block_tab = dr_rerank.build_block_table(trainer.rerank_params["softmax_w"],
                                            trainer.rerank_params["softmax_b"],
                                            dmap.path_items.long(), planes_n, m_pad)
    seq_pack = build_seq_pack(trainer.layer_params["embedding"],
                              trainer.rerank_params["embedding"])

    @torch.no_grad()
    def fn(layer_params, rerank_params, seqs, consumed=None):
        # one bf16 [V, 2E] gather feeds the heads' sequence parts and the
        # rerank user vector
        svalid = seqs != -1
        srows = (seq_pack[torch.where(svalid, seqs, 0)].float()
                 * svalid[:, :, None])  # [B, L, 2E]
        seq_parts, user_vec = window_parts(srows, layer_params, rerank_params, e)
        paths, _ = path_beam_search(layer_params, seqs, beam, num_items, num_nodes,
                                    num_layers, seq_parts=seq_parts)
        with profiling.span("dr_serve.rerank"):
            return dr_rerank.block_rerank_topk(paths, dmap.path_table, block_tab, user_vec,
                                               consumed, num_nodes, e, k, j_paths)

    fn._dmap = dmap
    fn._block_tab = block_tab
    fn._seq_pack = seq_pack
    fn._geometry = geom
    return fn
