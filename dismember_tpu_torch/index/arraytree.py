"""Dense array representation of the retrieval tree (host numpy).

Copy of ``dismember_tpu/index/arraytree.py``: the tree lives as dense arrays
indexed by heap code (parent = (c-1)>>1, children = 2c+1 / 2c+2), so id→code
conversion and child expansion are array arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dismember_tpu_torch.constants import PADDING_ID, PADDING_IDX
from dismember_tpu_torch.index.tree_io import LoadedTree, read_tree


@dataclasses.dataclass
class ArrayTree:
    """Dense tree arrays.

    - ``id_to_code[item_id]`` -> leaf code (or -1), with the non-leaf
      "item id" = code + offset trick (TDMTree.scala:35-56).
    - ``node_exists[code]``, ``node_id[code]``, ``node_prob[code]``,
      ``is_leaf[code]`` over all codes in [0, 2^(max_level+1)-1).
    """

    max_level: int
    num_items: int
    non_leaf_offset: int  # = max leaf item id + 1
    max_code: int  # max leaf code
    total_codes: int  # 2^(max_level+1) - 1
    node_exists: np.ndarray  # [total_codes] bool
    node_id: np.ndarray  # [total_codes] int32 (-1 absent)
    node_prob: np.ndarray  # [total_codes] float32
    is_leaf: np.ndarray  # [total_codes] bool
    item_ids: np.ndarray  # [num_items] int32, ascending
    item_codes: np.ndarray  # [num_items] int32, aligned with item_ids
    id_to_code: np.ndarray  # [non_leaf_offset] int32, -1 for unknown/padding
    level_codes: list[np.ndarray]  # level -> existing codes at that level

    @classmethod
    def from_loaded(cls, loaded: LoadedTree) -> "ArrayTree":
        max_level = loaded.max_level
        total = (1 << (max_level + 1)) - 1
        node_exists = np.zeros(total, dtype=bool)
        node_id = np.full(total, -1, dtype=np.int32)
        node_prob = np.zeros(total, dtype=np.float32)
        is_leaf = np.zeros(total, dtype=bool)
        codes = np.asarray(loaded.node_codes, dtype=np.int64)
        keep = codes < total
        codes = codes[keep]
        node_exists[codes] = True
        node_id[codes] = loaded.node_ids[keep]
        node_prob[codes] = loaded.node_probs[keep]
        is_leaf[codes] = loaded.node_is_leaf[keep]

        order = np.argsort(loaded.item_ids, kind="stable")
        item_ids = loaded.item_ids[order].astype(np.int32)
        item_codes = loaded.leaf_codes[order].astype(np.int32)
        non_leaf_offset = int(item_ids.max()) + 1 if len(item_ids) else 1
        id_to_code = np.full(non_leaf_offset, -1, dtype=np.int32)
        id_to_code[item_ids] = item_codes
        id_to_code[PADDING_ID] = PADDING_IDX

        level_codes = []
        for level in range(max_level + 1):
            start = (1 << level) - 1
            end = 2 * start + 1
            level_codes.append(
                (np.flatnonzero(node_exists[start:end]) + start).astype(np.int32)
            )

        return cls(
            max_level=max_level,
            num_items=len(item_ids),
            non_leaf_offset=non_leaf_offset,
            max_code=int(item_codes.max()) if len(item_codes) else -1,
            total_codes=total,
            node_exists=node_exists,
            node_id=node_id,
            node_prob=node_prob,
            is_leaf=is_leaf,
            item_ids=item_ids,
            item_codes=item_codes,
            id_to_code=id_to_code,
            level_codes=level_codes,
        )

    @classmethod
    def from_file(cls, path: str) -> "ArrayTree":
        return cls.from_loaded(read_tree(path))

    def ids_to_codes(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized idToCode: item ids below ``non_leaf_offset`` map through
        the leaf table (unknown -> -1); ids at/above it are internal-node
        pseudo-ids (code = id - offset, invalid -> -1).  Padding (item id 0)
        -> -1."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.full(ids.shape, PADDING_IDX, dtype=np.int32)
        leaf_mask = (ids >= 0) & (ids < self.non_leaf_offset)
        out[leaf_mask] = self.id_to_code[ids[leaf_mask]]
        anc = ids >= self.non_leaf_offset
        anc_codes = ids - self.non_leaf_offset
        ok = anc & (anc_codes <= self.max_code)
        out[ok] = anc_codes[ok].astype(np.int32)
        return out

    def ancestor_at_level(self, codes: np.ndarray, level: int) -> np.ndarray:
        """Ancestor of each (bottom-level) code at ``level`` via heap shifts."""
        codes = np.asarray(codes, dtype=np.int64)
        levels = np.floor(np.log2(np.maximum(codes, 0) + 1)).astype(np.int64)
        out = codes.copy()
        for _ in range(int((levels - level).max(initial=0))):
            shift = levels > level
            out[shift] = (out[shift] - 1) >> 1
            levels = levels - shift
        out[codes < 0] = -1
        return out

    def ancestor_matrix(self, leaf_codes: np.ndarray) -> np.ndarray:
        """[N, max_level+1] int32 ancestors per leaf: column l = ancestor at
        level l, so column ``max_level`` is the leaf itself and column 0 the
        root.  Invalid (negative) codes give rows of -1."""
        leaf_codes = np.asarray(leaf_codes, dtype=np.int64)
        out = np.empty((len(leaf_codes), self.max_level + 1), dtype=np.int32)
        cur = leaf_codes.copy()
        for level in range(self.max_level, -1, -1):
            out[:, level] = cur
            cur = (cur - 1) >> 1
        out[leaf_codes < 0, :] = -1
        return out

    def codes_to_item_ids(self, codes: np.ndarray) -> np.ndarray:
        """Leaf codes -> item ids (-1 for non-existent)."""
        codes = np.asarray(codes, dtype=np.int64)
        valid = (codes >= 0) & (codes < self.total_codes)
        out = np.full(codes.shape, -1, dtype=np.int32)
        out[valid] = self.node_id[codes[valid]]
        return out

    @property
    def node_meta(self) -> np.ndarray:
        """float32 [total_codes, 2] rows: (exists, node id).  float32 holds
        ids exactly up to 2^24, enough for every leaf item id read through
        it."""
        if not hasattr(self, "_node_meta"):
            m = np.zeros((self.total_codes, 2), np.float32)
            m[:, 0] = self.node_exists
            m[:, 1] = self.node_id
            self._node_meta = m
        return self._node_meta
