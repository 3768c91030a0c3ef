"""JTM tree learning: items re-assigned to subtrees by batched model scoring.

Port of ``dismember_tpu/train/jtm.py`` (jtm/.../optim/{JTM,JTMAsync,
TreeLearning}.scala in the reference): starting from all items at the root,
sweep levels in steps of ``gap``; at each step, every item assigned to a node
is scored against all 2^gap descendant candidates — the score of (item,
candidate) is the model forward summed over the item's training sequences and
over the chain from candidate up to the current node (aggregateWeights,
TreeLearning.scala:152-174) — then a greedy capacity-rebalance (2^(max_level-
level) per node, old assignment preferred to stay) fixes overflows
(reBalance:217-265).  The final sweep lands every item on a distinct leaf.

Scoring: every (training row, candidate, chain level) score of a sweep step
is one grouped scorer forward [b, 2^d] per batch of ``score_batch_rows``
rows, the model's ``forward`` under inference mode: K1 on CUDA for DIN,
plain ops for DeepFM.  Accumulation
(``weights_mode="device"``, the default): the rows live on the
device for the whole sweep, sorted by item position (``build_item_sequence_map``
already groups them by target), so within a batch the rows of one item form
one run.  :func:`add_runs` sums each run first, without atomics, and adds the
run sums — one row per item, never a repeated index — into the [N+1, W] f32
accumulator with ``ops.row_writer.add_rows`` (the add kernel on CUDA); W is
2^d padded to a multiple of 4, the add's width.  Two sweeps on the same
inputs give bitwise-equal weights.  ``weights_mode="host"`` keeps the
reference-ordered f64 host accumulation, the CPU-only parity twin of the
JAX package's host mode.  The greedy rebalance is a host loop in numpy.

Hierarchical preference (``idToCode`` with level, JTMTree.scala:59-113):
sequence items are replaced by their ancestors at the chain level when
``hierarchical`` and level >= min_level.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from dismember_tpu_torch.core import mesh as meshlib
from dismember_tpu_torch.core.device import resolve_device
from dismember_tpu_torch.index.arraytree import ArrayTree
from dismember_tpu_torch.index.tree_io import write_tree
from dismember_tpu_torch.models.scorer import TreeScorer
from dismember_tpu_torch.ops import row_writer
from dismember_tpu_torch.ops.din_kernel import check_kernel_width
from dismember_tpu_torch.train import spmd

logger = logging.getLogger("dismember_tpu_torch.jtm")

_LOW_WEIGHT = -1e6


def build_item_sequence_map(
    train_seqs: np.ndarray, train_targets: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Flatten the item -> training-sequences map (TreeLearning.readDataFile):
    returns (rows [R, L] raw item ids, row_item [R] target item id), rows
    grouped by target."""
    order = np.argsort(train_targets, kind="stable")
    return train_seqs[order], train_targets[order]


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of int64 x >= 1 by integer shifts (a binary search over
    the bit position), exact for every x below 2^63."""
    lev = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        lev += ((x >> (lev + s)) != 0).to(x.dtype) * s
    return lev


def add_runs(acc: torch.Tensor, idx: torch.Tensor, logits: torch.Tensor) -> None:
    """``acc[idx[i], :C] += logits[i]`` in place, for ``idx`` [b] sorted so
    that equal indices are adjacent; ``logits`` [b, C], ``acc`` [P, W] f32
    with W >= C a multiple of 4.

    Each run of equal indices is summed first: a float64 cumulative sum
    differenced at the run's end, exact to the f32 rounding of the sum, in a
    fixed order and without atomics.  The run's last row carries its index
    and sum; every other row carries index -1, which ``add_rows`` drops
    without reading its row, so the add never sees a repeated index."""
    b, c = logits.shape
    if b == 0:
        return
    pos = torch.arange(b, device=idx.device)
    start = torch.ones(b, dtype=torch.bool, device=idx.device)
    start[1:] = idx[1:] != idx[:-1]
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    first = torch.cummax(torch.where(start, pos, 0), dim=0).values  # the run's start
    cs = torch.zeros(b + 1, acc.shape[1], dtype=torch.float64, device=acc.device)
    cs[1:, :c] = logits.double().cumsum(0)
    sums = (cs[1:] - cs[first]).float()
    row_writer.add_rows(acc, torch.where(end, idx, -1), sums)


@dataclasses.dataclass
class GenericTreeLearner:
    """Shared machinery for JTM tree learning and OTM tree construction:
    batched (item, candidate, chain-level) scoring + greedy capacity
    rebalance over a binary tree of ``max_level`` levels.

    Subclasses/factories supply: ``items`` (ids), ``item_old_codes`` (current
    leaf code per item, for the stay-preference), ``rows_codes`` [R, L]
    sequence codes per training row, ``row_item_pos`` [R] item position per
    row.  ``model`` is the scorer (the port's ``DIN`` or ``DeepFM``) on
    ``device``.

    ``mesh``: a ("data", "model") DeviceMesh; every rank calls the sweep.
    The scoring pass runs sharded (``train/spmd.make_sharded_forward``: the
    score rows split on "data", the node table row-sharded on "model"),
    the scores come back to every rank in row order (:meth:`_scores`), and
    the accumulation and rebalance run on every rank as on one device, so
    the weights are the single-device sweep's up to the scorer's batch
    rounding and the projections equal it."""

    model: TreeScorer
    max_level: int
    items: np.ndarray  # [N] item ids
    item_old_codes: np.ndarray  # [N] current leaf codes
    rows_codes: np.ndarray  # [R, L] sequence codes (-1 pad)
    row_item_pos: np.ndarray  # [R] item position per row
    gap: int = 2
    score_batch_rows: int = 8192
    weights_mode: str = "device"  # "device" | "host" (the CPU parity twin)
    device: str | torch.device = "cuda"
    mesh: object = None  # a ("data", "model") DeviceMesh: sharded scoring

    def __post_init__(self):
        if self.weights_mode not in ("device", "host"):
            raise ValueError(f"unknown weights_mode {self.weights_mode!r}")
        dev = resolve_device(self.device)
        if self.weights_mode == "host" and dev.type != "cpu":
            raise ValueError(
                "weights_mode='host' is the CPU parity twin; on CUDA the sweep "
                "accumulates on the card through the add kernel (weights_mode='device')")
        check_kernel_width(self.model.model_type, self.model.embed_size, dev)
        if self.model.embedding.device.type != dev.type:
            raise ValueError(f"the model lies on {self.model.embedding.device}, not on {dev}")
        self.device = self.model.embedding.device
        self._weights_device = self.weights_mode == "device"
        self._dev_cache = None
        if self.mesh is not None:
            meshlib.check_mesh(self.mesh)
            self._score_fn, _ = spmd.make_sharded_forward(self.model, self.mesh)

    # ------------------------------------------------------------------
    def _seq_codes_at_level(self, level: int) -> np.ndarray:
        """Sequence codes for scoring at ``level`` (overridden for JTM's
        hierarchical preference)."""
        return self.rows_codes

    def _old_ancestors_at_level(self, level: int) -> np.ndarray:
        """Heap ancestor of each item's old code at ``level``, O(N): the
        ancestor k levels up of code c is ((c+1) >> k) - 1."""
        codes = self.item_old_codes.astype(np.int64)
        cur_level = np.floor(np.log2(np.maximum(codes, 0) + 1)).astype(np.int64)
        shift = np.maximum(cur_level - level, 0)
        return ((codes + 1) >> shift) - 1

    def _codes(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    @torch.inference_mode()
    def _scores(self, chain: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
        """chain codes [R, C], seqs [R, L] -> logits [R, C] (K1 on CUDA for
        DIN).  On a mesh the rows are padded with -1 rows to a "data"
        multiple, each rank scores its rows from the sharded table, the
        scores are all-gathered back in row order and the pad rows
        dropped, so every rank accumulates the single-device add sequence."""
        if self.mesh is None:
            return self.model(chain, seqs)
        r = chain.shape[0]
        pad = (-r) % meshlib.data_size(self.mesh)
        if pad:
            chain = torch.cat([chain, chain.new_full((pad, chain.shape[1]), -1)])
            seqs = torch.cat([seqs, seqs.new_full((pad, seqs.shape[1]), -1)])
        out = self._score_fn(meshlib.data_rows(chain, self.mesh),
                             meshlib.data_rows(seqs, self.mesh))
        return meshlib.all_gather_rows(out, self.mesh, meshlib.DATA_AXIS)[:r]

    # ------------------------------------------------------------------
    # device-resident weight computation: rows and item positions live on
    # the device across the whole sweep, and the [N, 2^d] weight matrix
    # accumulates there; a sweep step downloads its argmax column and the
    # weight rows of over-capacity segments only
    # ------------------------------------------------------------------
    def _hierarchical_level(self, level: int) -> int:
        """Device twin of _seq_codes_at_level's routing: the ancestor level
        to map sequence codes to, or -1 for raw codes."""
        return -1

    def _ensure_device_rows(self):
        """(rows [R_pad, L], row positions [R_pad], batches): the rows sorted
        by item position (stable: each item's rows keep their order), padded
        to whole batches with -1 rows at the tail."""
        if self._dev_cache is None:
            r, l = self.rows_codes.shape
            b = self.score_batch_rows
            r_pad = -(-max(r, 1) // b) * b
            order = np.argsort(self.row_item_pos, kind="stable")
            rows = np.full((r_pad, l), -1, np.int64)
            rows[:r] = self.rows_codes[order]
            pos = np.full(r_pad, -1, np.int64)
            pos[:r] = self.row_item_pos[order]
            self._dev_cache = (self._codes(rows), self._codes(pos), r_pad // b)
        return self._dev_cache

    @torch.inference_mode()
    def _accumulate_device(self, proj: np.ndarray, old_level: int, level: int) -> torch.Tensor:
        """Run the step's whole scoring pass on the device; returns the
        [N+1, W] f32 accumulator (row N collects padding, columns past 2^d
        stay zero)."""
        rows_dev, pos_dev, n_batches = self._ensure_device_rows()
        d = level - old_level
        n_cand = 1 << d
        n_items = len(self.items)
        b = self.score_batch_rows
        base = torch.where(pos_dev >= 0,
                           self._codes(proj)[pos_dev.clamp(min=0)] * n_cand + (n_cand - 1), 0)
        offsets = torch.arange(n_cand, device=self.device)
        acc = torch.zeros(n_items + 1, -(-n_cand // 4) * 4, device=self.device)
        for k in range(d):
            seq_lvl = self._hierarchical_level(level - k)
            for bi in range(n_batches):
                rows_b = rows_dev[bi * b : (bi + 1) * b]
                pos_b = pos_dev[bi * b : (bi + 1) * b]
                chain = ((base[bi * b : (bi + 1) * b, None] + offsets + 1) >> k) - 1
                seqs = rows_b
                if seq_lvl >= 0:
                    valid = rows_b >= 0
                    c1 = torch.where(valid, rows_b, 0) + 1
                    shift = (floor_log2(c1) - seq_lvl).clamp(min=0)
                    seqs = torch.where(valid, (c1 >> shift) - 1, -1)
                logits = self._scores(chain, seqs)
                add_runs(acc, torch.where(pos_b >= 0, pos_b, n_items), logits)
        return acc

    def _has_rows(self) -> np.ndarray:
        has_rows = np.zeros(len(self.items), dtype=bool)
        has_rows[self.row_item_pos[self.row_item_pos >= 0]] = True
        return has_rows

    def _compute_weights_device(self, proj: np.ndarray, old_level: int, level: int) -> np.ndarray:
        acc = self._accumulate_device(proj, old_level, level)
        n_cand = 1 << (level - old_level)
        weights = acc[: len(self.items), :n_cand].cpu().numpy().astype(np.float64)
        weights[~self._has_rows()] = _LOW_WEIGHT
        return weights

    def _compute_choice_device(self, proj: np.ndarray, old_level: int, level: int):
        """(choice_j [N] argmax column, fetch_rows(idx) -> f64 weight rows):
        the step downloads the argmax vector, and only over-capacity
        segments fetch their weight rows (a small device gather), since the
        greedy rebalance is their only consumer."""
        acc = self._accumulate_device(proj, old_level, level)
        n_items = len(self.items)
        n_cand = 1 << (level - old_level)
        # torch.argmax returns the first maximal index, as np.argmax does
        choice_j = torch.argmax(acc[:n_items, :n_cand], dim=1).cpu().numpy()
        has_rows = self._has_rows()

        def fetch_rows(idx: np.ndarray) -> np.ndarray:
            rows = acc[self._codes(idx), :n_cand].cpu().numpy().astype(np.float64)
            rows[~has_rows[np.asarray(idx)]] = _LOW_WEIGHT
            return rows

        return choice_j, fetch_rows

    def compute_weights(self, proj: np.ndarray, old_level: int, level: int) -> np.ndarray:
        """Weight matrix [num_items, 2^d]: candidate j of item i is descendant
        j of proj[i]; weight = sum over chain levels and the item's training
        rows of the model score.  Items without training rows get -1e6.

        The device-resident path accumulates in f32 on the device;
        ``weights_mode="host"`` (CPU only) keeps the reference-ordered f64
        host accumulation (the parity twin: same scores, another summation
        order and precision)."""
        if self._weights_device:
            return self._compute_weights_device(proj, old_level, level)
        d = level - old_level
        n_cand = 1 << d
        n_items = len(self.items)
        weights = np.full((n_items, n_cand), 0.0, dtype=np.float64)

        # candidates per item: proj*2^d + (2^d - 1) + j
        cand = (proj.astype(np.int64)[:, None] * n_cand + (n_cand - 1)) + np.arange(n_cand)

        # chain level k (0 = candidate's own level, increasing = up the tree)
        for k in range(d):
            lvl = level - k
            chain = cand.copy()
            for _ in range(k):
                chain = (chain - 1) >> 1  # ancestor at lvl
            seq_codes = self._seq_codes_at_level(lvl)
            row_chain = chain[self.row_item_pos]  # [R, 2^d]
            for s in range(0, len(seq_codes), self.score_batch_rows):
                e = min(s + self.score_batch_rows, len(seq_codes))
                out = self._scores(self._codes(row_chain[s:e]), self._codes(seq_codes[s:e]))
                np.add.at(weights, self.row_item_pos[s:e], out.double().cpu().numpy())

        weights[~self._has_rows()] = _LOW_WEIGHT
        return weights

    # ------------------------------------------------------------------
    def rebalance(
        self,
        node_items: np.ndarray,  # positions of items assigned to this node
        candidates: np.ndarray,  # [2^d] candidate child codes
        weights: np.ndarray,  # [len(node_items), 2^d]
        old_codes: np.ndarray,  # old ancestor (at `level`) per item position
        max_assign: int,
        no_evidence: np.ndarray | None = None,  # [len(node_items)] bool
    ) -> dict[int, list[int]]:
        """Greedy capacity rebalance (TreeLearning.reBalance:217-265).

        Returns candidate code -> item positions."""
        order = np.argsort(-weights, axis=1, kind="stable")  # per item: cands desc
        # zero-training-row items carry no evidence (their rows are flat
        # _LOW_WEIGHT ties): the stable argsort would claim candidate 0 for
        # all of them; claim their OLD node first instead, matching
        # optimize()'s keep-old override.  Keyed on the caller-supplied
        # evidence mask, not on value flatness, so host and device weights
        # reorder the same items.
        if no_evidence is not None:
            for r in np.flatnonzero(no_evidence):
                jo = np.flatnonzero(candidates == old_codes[node_items[r]])
                if len(jo):
                    j = jo[0]
                    order[r] = np.concatenate(([j], order[r][order[r] != j]))
        assign: dict[int, list[tuple[int, float, int]]] = {}
        for r, pos in enumerate(node_items):
            j = order[r, 0]
            node = int(candidates[j])
            assign.setdefault(node, []).append((int(pos), float(weights[r, j]), 1))
        row_of_pos = {int(pos): r for r, pos in enumerate(node_items)}

        processed: set[int] = set()
        while True:
            best_node, best_count = 0, -1
            for node in candidates:
                node = int(node)
                if node not in processed and node in assign:
                    if len(assign[node]) > best_count:
                        best_count, best_node = len(assign[node]), node
            if best_count <= max_assign:
                break
            processed.add(best_node)
            entries = assign[best_node]
            # keep items whose OLD ancestor is this node first (reference
            # reBalance's stay preference); old_codes is indexed by item
            # position (t[0])
            entries.sort(key=lambda t: (old_codes[t[0]] != best_node, -t[1]))
            assign[best_node] = entries[:max_assign]
            for pos, _w, next_idx in entries[max_assign:]:
                r = row_of_pos[pos]
                idx = next_idx
                while idx < len(candidates):
                    j = order[r, idx]
                    node = int(candidates[j])
                    if node not in processed:
                        assign.setdefault(node, []).append(
                            (pos, float(weights[r, j]), idx + 1)
                        )
                        break
                    idx += 1
        return {node: [pos for pos, _, _ in items] for node, items in assign.items()}

    # ------------------------------------------------------------------
    def optimize(self) -> dict[int, int]:
        """Full level sweep; returns item id -> leaf code projection.  Each
        level logs its seconds (``score_s``: scoring up to the download;
        ``rebalance_s``: the rest) and its over-capacity segment count, also
        as fields of the log record."""
        n_items = len(self.items)
        proj = np.zeros(n_items, dtype=np.int64)  # all at root
        max_level = self.max_level

        for old_level in range(0, max_level, self.gap):
            level = min(max_level, old_level + self.gap)
            d = level - old_level
            t0 = time.perf_counter()
            if self._weights_device:
                choice_j, fetch_rows = self._compute_choice_device(proj, old_level, level)
            else:
                weights = self.compute_weights(proj, old_level, level)
                choice_j = np.argmax(weights, axis=1)
                fetch_rows = lambda idx: weights[idx]  # noqa: E731
            t_score = time.perf_counter() - t0
            old_codes = self._old_ancestors_at_level(level)
            max_assign = 1 << (max_level - level)
            n_cand = 1 << d

            # items with NO training rows carry no score evidence (every
            # candidate ties at _LOW_WEIGHT) and the argmax would dump them
            # all on candidate 0, scrambling their neighborhoods; keep them
            # under their OLD tree's ancestor instead (valid whenever that
            # ancestor lies inside the item's current candidate subtree)
            has_rows = self._has_rows()
            if not has_rows.all():
                j_old = old_codes - (proj.astype(np.int64) * n_cand + (n_cand - 1))
                keep = (~has_rows) & (j_old >= 0) & (j_old < n_cand)
                choice_j = np.where(keep, j_old, choice_j)

            # vectorized fast path: every item takes its argmax candidate
            # (== rebalance's first greedy pick); the sequential greedy only
            # changes assignments under a child node that exceeded capacity,
            # so only parent segments holding an over-capacity child need it
            choice = proj * n_cand + (n_cand - 1) + choice_j
            uniq_child, counts = np.unique(choice, return_counts=True)
            over_children = uniq_child[counts > max_assign]
            over_parents = np.unique((over_children - (n_cand - 1)) // n_cand)

            new_proj = choice
            if len(over_parents):
                new_proj = choice.copy()
                order_items = np.argsort(proj, kind="stable")
                sorted_proj = proj[order_items]
                seg_starts = np.flatnonzero(
                    np.concatenate([[True], sorted_proj[1:] != sorted_proj[:-1]])
                )
                seg_ends = np.append(seg_starts[1:], len(sorted_proj))
                seg_nodes = sorted_proj[seg_starts]
                need = np.isin(seg_nodes, over_parents)
                # one batched weight fetch for every over-capacity segment
                need_rows = [
                    order_items[s0:e0]
                    for s0, e0 in zip(seg_starts[need], seg_ends[need])
                ]
                all_idx = np.concatenate(need_rows) if need_rows else np.zeros(0, np.int64)
                all_rows = fetch_rows(all_idx)
                off = 0
                for node_items in need_rows:
                    node = int(proj[node_items[0]])
                    seg_rows = all_rows[off : off + len(node_items)]
                    off += len(node_items)
                    candidates = node * n_cand + (n_cand - 1) + np.arange(n_cand)
                    balanced = self.rebalance(
                        node_items, candidates, seg_rows, old_codes, max_assign,
                        no_evidence=~has_rows[node_items],
                    )
                    for child, positions in balanced.items():
                        if len(positions) > max_assign:
                            raise RuntimeError(f"rebalance overfilled node {child}")
                        new_proj[positions] = child
            proj = new_proj
            total = time.perf_counter() - t0
            logger.info(
                f"level {level} assign time: {total:.3f}s (score {t_score:.3f}s, "
                f"rebalance {total - t_score:.3f}s over {len(over_parents)} segments)",
                extra={"level": level, "score_s": t_score, "rebalance_s": total - t_score,
                       "segments": len(over_parents)},
            )

        return {int(self.items[i]): int(proj[i]) for i in range(n_items)}


class TreeLearner(GenericTreeLearner):
    """JTM tree learning over a persisted ArrayTree (reference JTM/JTMAsync).
    ``model`` is the scorer trained on ``tree`` (on ``device``)."""

    def __init__(
        self,
        tree: ArrayTree,
        model: TreeScorer,
        train_seqs: np.ndarray,  # [R, L] raw item ids
        train_targets: np.ndarray,  # [R] raw item ids
        gap: int = 2,
        hierarchical: bool = False,
        min_level: int = 0,
        score_batch_rows: int = 8192,
        weights_mode: str = "device",
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.tree = tree
        self.hierarchical = hierarchical
        self.min_level = min_level
        rows, row_item = build_item_sequence_map(train_seqs, train_targets)
        items = np.asarray(tree.item_ids)
        item_index = {int(v): i for i, v in enumerate(items)}
        # rows whose target is not a tree leaf are dropped
        pos = np.asarray([item_index.get(int(t), -1) for t in row_item], dtype=np.int64)
        keep = pos >= 0
        super().__init__(
            model=model,
            max_level=tree.max_level,
            items=items,
            item_old_codes=np.asarray(tree.item_codes, np.int64),
            rows_codes=tree.ids_to_codes(rows[keep]),
            row_item_pos=pos[keep],
            gap=gap,
            score_batch_rows=score_batch_rows,
            weights_mode=weights_mode,
            device=device,
            mesh=mesh,
        )

    def _seq_codes_at_level(self, level: int) -> np.ndarray:
        """JTMTree.idToCode: hierarchical preference replaces sequence items
        by their ancestors at the chain level."""
        if self.hierarchical and level >= self.min_level:
            codes = self.rows_codes
            valid = codes >= 0
            anc = self.tree.ancestor_at_level(
                np.where(valid, codes, 0).astype(np.int64), level
            )
            return np.where(valid, anc, -1).astype(np.int32)
        return self.rows_codes

    def _hierarchical_level(self, level: int) -> int:
        return level if self.hierarchical and level >= self.min_level else -1


def otm_tree_learner(
    model: TreeScorer,
    item_to_code: dict[int, int],
    train_seqs_codes: np.ndarray,  # [N, L] mapped codes (-1 pad)
    train_labels_codes: np.ndarray,  # [N, label_num] mapped codes (-1 pad)
    gap: int = 2,
    score_batch_rows: int = 8192,
    weights_mode: str = "device",
    device: str | torch.device = "cuda",
    mesh=None,
) -> GenericTreeLearner:
    """OTM tree construction (otm/.../tree/TreeConstruction.scala): the same
    assignment algorithm over the implicit complete tree; each (sequence,
    label) pair contributes the sequence to the label item's row set."""
    import math

    leaf_level = int(math.ceil(math.log2(len(item_to_code))))
    items = np.asarray(sorted(item_to_code), dtype=np.int64)
    code_of_item = np.asarray([item_to_code[int(i)] for i in items], dtype=np.int64)

    # vectorized (seq, label) -> row expansion: np.nonzero is row-major, so
    # row order matches the reference's nested loop exactly
    labels_arr = np.asarray(train_labels_codes, np.int64)
    pos_of_code = np.full(int(code_of_item.max(initial=0)) + 2, -1, np.int64)
    pos_of_code[code_of_item] = np.arange(len(code_of_item))
    safe = np.clip(labels_arr, 0, len(pos_of_code) - 1)
    mask = (labels_arr >= 0) & (pos_of_code[safe] >= 0)
    row_idx, _col = np.nonzero(mask)
    rows = np.asarray(train_seqs_codes, np.int64)[row_idx]
    row_pos = pos_of_code[labels_arr[mask]]
    return GenericTreeLearner(
        model=model,
        max_level=leaf_level,
        items=items,
        item_old_codes=code_of_item,
        rows_codes=np.asarray(rows, np.int64),
        row_item_pos=np.asarray(row_pos, np.int64),
        gap=gap,
        score_batch_rows=score_batch_rows,
        weights_mode=weights_mode,
        device=device,
        mesh=mesh,
    )


def write_projection_tree(tree: ArrayTree, projection: dict[int, int], path: str) -> None:
    """Persist a learned projection as a pb tree (JTMTree.writeTree parity):
    leaf probability = the item's *old* leaf-node probability; ancestor
    probabilities = sums over descendant leaves."""
    ids = np.asarray(sorted(projection), dtype=np.int64)
    codes = np.asarray([projection[int(i)] for i in ids], dtype=np.int64)
    old_codes = tree.ids_to_codes(ids)
    probs = {int(i): float(tree.node_prob[c]) for i, c in zip(ids, old_codes) if c >= 0}
    write_tree(path, ids, codes, stat=probs)
