"""The TDM tree that ``tdm-initialize-tree`` builds (the upstream TreeInit
and TreeBuilder), worked out again in numpy: items sorted by (category,
id), the range split recursively in halves (the right half to child 2c+1,
the left half to 2c+2), every leaf sunk to the bottom level by 2c+1 steps.
Imports nothing of the program."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Tree:
    max_level: int
    item_ids: np.ndarray  # [n] ascending
    leaf_codes: np.ndarray  # [n] int64, aligned with item_ids
    exists: np.ndarray  # [2^(max_level+1) - 1] bool
    leaf_item: np.ndarray  # [2^(max_level+1) - 1] int64 item id at a leaf code, else -1

    @property
    def total_codes(self) -> int:
        return len(self.exists)

    def codes(self, ids: np.ndarray) -> np.ndarray:
        """Leaf codes of item ids; -1 for id 0 (padding) and unknown ids."""
        ids = np.asarray(ids, np.int64)
        pos = np.clip(np.searchsorted(self.item_ids, ids), 0, len(self.item_ids) - 1)
        return np.where(self.item_ids[pos] == ids, self.leaf_codes[pos], -1)


def split_codes(n: int) -> np.ndarray:
    """Codes of positions 0..n-1 of a sorted range under the recursive half
    split, one level of ranges at a time."""
    codes = np.zeros(n, np.int64)
    start = np.zeros(1, np.int64)
    end = np.full(1, n, np.int64)
    code = np.zeros(1, np.int64)
    while len(start):
        single = end - start == 1
        codes[start[single]] = code[single]
        keep = end - start > 1
        start, end, code = start[keep], end[keep], code[keep]
        mid = (start + end) >> 1
        start = np.concatenate([start, mid])
        end = np.concatenate([mid, end])
        code = np.concatenate([2 * code + 2, 2 * code + 1])
    return codes


def category_tree(item_ids: np.ndarray, categories: np.ndarray) -> Tree:
    order = np.lexsort((item_ids, categories))
    ids_sorted = np.asarray(item_ids, np.int64)[order]
    codes = split_codes(len(ids_sorted))
    max_level = int(math.floor(math.log2(int(codes.max()) + 1)))
    lo = (1 << max_level) - 1
    while (codes < lo).any():
        codes = np.where(codes < lo, 2 * codes + 1, codes)
    total = (1 << (max_level + 1)) - 1
    exists = np.zeros(total, bool)
    cur = codes.copy()
    for _ in range(max_level + 1):
        exists[cur] = True
        cur = (cur - 1) >> 1
        cur = cur[cur >= 0]
    leaf_item = np.full(total, -1, np.int64)
    leaf_item[codes] = ids_sorted
    by_id = np.argsort(ids_sorted)
    return Tree(max_level, ids_sorted[by_id], codes[by_id], exists, leaf_item)
