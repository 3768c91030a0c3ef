"""Tree persistence: the reference's length-prefixed KV protobuf format.

Port of ``dismember_tpu/index/tree_io.py``.  A file is a stream of records,
each a 4-byte big-endian length followed by a ``KVItem``; keys are UTF-8
strings: a numeric node code, ``Part_i`` (id/code pairs, 512 per part), or
``tree_meta``.  The bytes equal those the JAX package writes.  Reads and
writes go through the native host library (``data/native.py``) when it
loads, else through the Python codec here, which gives the same bytes and
arrays.

:func:`build_tree` computes the tree in memory (leaf sinking, ancestor
records and probabilities) and :func:`write_tree` serializes it, so a large
catalog can go straight to ``ArrayTree.from_loaded`` without a round trip
through the Python codec.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from dismember_tpu_torch.core.io import stage_in, stage_out
from dismember_tpu_torch.data.native import read_tree_native, write_tree_native
from dismember_tpu_torch.index.proto import (
    IdCodePair,
    IdCodePart,
    KVItem,
    Node,
    TreeMeta,
)


@dataclasses.dataclass
class LoadedTree:
    """Host-side decoded tree.

    Columnar: ``node_*`` arrays hold every code-keyed record (leaves +
    internal) in ascending code order; ``item_ids``/``leaf_codes`` are the
    ``Part_i`` id/code pairs in file order (ascending leaf code)."""

    max_level: int
    item_ids: np.ndarray  # [num_items] leaf item ids
    leaf_codes: np.ndarray  # [num_items]
    node_codes: np.ndarray  # [n_nodes]
    node_ids: np.ndarray  # [n_nodes]
    node_probs: np.ndarray  # [n_nodes] float32
    node_is_leaf: np.ndarray  # [n_nodes] bool

    @property
    def code_nodes(self) -> dict[int, Node]:
        """The legacy code -> ``Node`` dict, built on demand from the
        columnar arrays."""
        return {
            int(c): Node(id=int(i), probality=float(p), is_leaf=bool(leaf))
            for c, i, p, leaf in zip(
                self.node_codes, self.node_ids, self.node_probs, self.node_is_leaf)
        }


def sink_leaf_codes(codes: np.ndarray, max_level: int) -> np.ndarray:
    """Sink every leaf code down to the deepest level: repeatedly
    ``code = 2*code + 1`` until ``code >= 2^max_level - 1``
    (TreeBuilder.flattenLeaves)."""
    min_leaf_code = (1 << max_level) - 1
    out = codes.astype(np.int64).copy()
    while True:
        mask = out < min_leaf_code
        if not mask.any():
            return out
        out[mask] = out[mask] * 2 + 1


def ancestors_of(code: int, max_level: int) -> list[int]:
    """All ancestors up to (and including) the root, mirroring
    TreeBuilder.getAncestors: exactly ``max_level`` hops of (c-1)//2."""
    out = []
    c = code
    for _ in range(max_level):
        c = (c - 1) // 2
        out.append(c)
    return out


def build_tree(
    tree_ids: np.ndarray,
    tree_codes: np.ndarray,
    stat: dict[int, int] | None = None,
) -> LoadedTree:
    """The tree that :func:`write_tree` persists, built in memory
    (TreeBuilder.build): leaves sunk to the bottom level and sorted by code,
    internal nodes with id = code + offset and occurrence-summed
    probabilities."""
    tree_ids = np.asarray(tree_ids, dtype=np.int64)
    tree_codes = np.asarray(tree_codes, dtype=np.int64)
    offset = max(0, int(tree_ids.max())) + 1
    max_level = int(math.floor(math.log2(int(tree_codes.max()) + 1)))
    leaf_codes = sink_leaf_codes(tree_codes, max_level)
    order = np.argsort(leaf_codes, kind="stable")
    ids_sorted = tree_ids[order]
    codes_sorted = leaf_codes[order]

    if stat:
        leaf_probs = np.asarray(
            [float(stat.get(int(i), 1.0)) for i in ids_sorted], dtype=np.float32
        )
        leaf_counts = np.asarray(
            [float(stat[int(i)]) if int(i) in stat else 0.0 for i in ids_sorted],
            dtype=np.float64,
        )
    else:
        leaf_probs = np.ones(len(ids_sorted), dtype=np.float32)
        leaf_counts = np.zeros(len(ids_sorted), dtype=np.float64)

    # ancestor occurrence sums (computeNodeOccurrence), one level at a time
    total = (1 << (max_level + 1)) - 1
    anc_sum = np.zeros(total, dtype=np.float64)
    anc_seen = np.zeros(total, dtype=bool)
    cur = codes_sorted.copy()
    for _ in range(max_level):
        cur = (cur - 1) >> 1
        np.add.at(anc_sum, cur, leaf_counts)
        anc_seen[cur] = True
    anc_codes = np.flatnonzero(anc_seen).astype(np.int64)
    if stat:
        anc_probs = np.where(
            anc_sum[anc_codes] > 0, anc_sum[anc_codes], 1.0
        ).astype(np.float32)
    else:
        anc_probs = np.ones(len(anc_codes), dtype=np.float32)

    # ancestors sit above the bottom level and leaves on it, so ancestors
    # followed by leaves is ascending code order
    return LoadedTree(
        max_level=max_level,
        item_ids=ids_sorted,
        leaf_codes=codes_sorted,
        node_codes=np.concatenate([anc_codes, codes_sorted]),
        node_ids=np.concatenate([anc_codes + offset, ids_sorted]),
        node_probs=np.concatenate([anc_probs, leaf_probs]),
        node_is_leaf=np.concatenate(
            [np.zeros(len(anc_codes), bool), np.ones(len(codes_sorted), bool)]
        ),
    )


def write_tree(
    path: str,
    tree_ids: np.ndarray,
    tree_codes: np.ndarray,
    stat: dict[int, int] | None = None,
) -> None:
    """Serialize the tree of :func:`build_tree`: leaf records in code order,
    then internal-node records, then the Part_i id/code chunks and the
    tree_meta record."""
    tree = build_tree(tree_ids, tree_codes, stat)
    n_anc = len(tree.node_codes) - len(tree.item_ids)  # ancestors come first
    with stage_out(path) as local:
        if write_tree_native(
            local, tree.item_ids, tree.leaf_codes, tree.node_probs[n_anc:],
            tree.node_codes[:n_anc], tree.node_ids[:n_anc], tree.node_probs[:n_anc],
            tree.max_level,
        ):
            return
        _write_tree_python(local, tree)


def _write_tree_python(path: str, tree: LoadedTree) -> None:
    leaf = tree.node_is_leaf
    with open(path, "wb") as f:

        def write_kv(key: str, value: bytes) -> None:
            rec = KVItem(key=key.encode("utf-8"), value=value).encode()
            f.write(struct.pack(">i", len(rec)))
            f.write(rec)

        for code, iid, prob in zip(
            tree.node_codes[leaf], tree.node_ids[leaf], tree.node_probs[leaf]
        ):
            node = Node(id=int(iid), probality=float(prob), is_leaf=True)
            write_kv(str(int(code)), node.encode())
        for code, iid, prob in zip(
            tree.node_codes[~leaf], tree.node_ids[~leaf], tree.node_probs[~leaf]
        ):
            node = Node(id=int(iid), probality=float(prob), is_leaf=False)
            write_kv(str(int(code)), node.encode())

        parts: list[IdCodePart] = []
        for start in range(0, len(tree.item_ids), 512):
            pairs = [
                IdCodePair(id=int(i), code=int(c))
                for i, c in zip(
                    tree.item_ids[start : start + 512],
                    tree.leaf_codes[start : start + 512],
                )
            ]
            part_id = f"Part_{len(parts) + 1}".encode("utf-8")
            parts.append(IdCodePart(part_id=part_id, id_code_list=pairs))
        for p in parts:
            write_kv(p.part_id.decode("utf-8"), p.encode())
        meta = TreeMeta(
            max_level=tree.max_level, id_code_part=[p.part_id for p in parts]
        )
        write_kv("tree_meta", meta.encode())


def read_tree(path: str) -> LoadedTree:
    """Load a KV tree file (local or remote URL), mirroring
    DistTree.loadData/loadItems."""
    with stage_in(path) as local:
        native = read_tree_native(local)
        if native is None:
            return _read_tree_python(local)
    # the native reader keeps file order (leaves, then internal nodes, each
    # ascending): a stable sort merges the two runs in linear time
    order = np.argsort(native["node_codes"], kind="stable")
    for k in ("node_codes", "node_ids", "node_probs", "node_is_leaf"):
        native[k] = native[k][order]
    return LoadedTree(**native)


def _read_tree_python(path: str) -> LoadedTree:
    with open(path, "rb") as f:
        data = f.read()

    code_nodes: dict[int, Node] = {}
    parts: list[IdCodePart] = []
    meta: TreeMeta | None = None
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        (rec_len,) = struct.unpack(">i", data[pos : pos + 4])
        pos += 4
        item = KVItem.decode(data[pos : pos + rec_len])
        pos += rec_len
        key = item.key.decode("utf-8")
        if key.startswith("tree_meta"):
            meta = TreeMeta.decode(item.value)
        elif key.startswith("Part_"):
            parts.append(IdCodePart.decode(item.value))
        else:
            code_nodes[int(key)] = Node.decode(item.value)
    if meta is None:
        raise ValueError(f"tree file {path} has no tree_meta record")
    pairs = [p for part in parts for p in part.id_code_list]
    codes = np.asarray(sorted(code_nodes), dtype=np.int64)
    return LoadedTree(
        max_level=meta.max_level,
        item_ids=np.asarray([p.id for p in pairs], dtype=np.int64),
        leaf_codes=np.asarray([p.code for p in pairs], dtype=np.int64),
        node_codes=codes,
        node_ids=np.asarray([code_nodes[int(c)].id for c in codes], dtype=np.int64),
        node_probs=np.asarray(
            [code_nodes[int(c)].probality for c in codes], dtype=np.float32
        ),
        node_is_leaf=np.asarray(
            [code_nodes[int(c)].is_leaf for c in codes], dtype=bool
        ),
    )


def category_sorted_codes(
    item_ids: np.ndarray, categories: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Initial tree codes by category sort + recursive half-split
    (TreeInit.initializeTree): items sorted by (category, id); the *right*
    half of a range goes to child 2c+1 and the left half to 2c+2.
    Returns (sorted_ids, codes) aligned arrays."""
    order = np.lexsort((item_ids, categories))
    ids_sorted = np.asarray(item_ids)[order]
    codes = np.zeros(len(ids_sorted), dtype=np.int64)

    # iterative genCode to avoid Python recursion limits on big catalogs
    stack = [(0, len(ids_sorted), 0)]
    while stack:
        start, end, code = stack.pop()
        if end <= start:
            continue
        if end == start + 1:
            codes[start] = code
            continue
        mid = (start + end) >> 1
        stack.append((mid, end, 2 * code + 1))
        stack.append((start, mid, 2 * code + 2))
    return ids_sorted, codes
