"""Deep Retrieval path index: item -> J paths of D nodes, inverted mapping.

Copy of ``dismember_tpu/index/paths.py``: the same numpy draws from the same
seed, and the same ItemSet blob, so a mapping written by either package
reads in the other.

Parity with deep-retrieval/.../model/MappingOp.scala:15-100 and
item_mapping.proto: the mapping persists as one length-prefixed ``ItemSet``
protobuf blob; random initialization draws J·D uniform node indices per item.
The inverted path->items map is kept both as a host dict (serving) and as a
padded CSR for on-device expansion.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from dismember_tpu_torch.index.proto import Item, ItemSet, Path


@dataclasses.dataclass
class PathIndex:
    item_paths: np.ndarray  # [num_items, J, D] int32 node indices
    num_nodes: int  # K

    @property
    def num_items(self) -> int:
        return self.item_paths.shape[0]

    @property
    def num_paths_per_item(self) -> int:
        return self.item_paths.shape[1]

    @property
    def num_layers(self) -> int:
        return self.item_paths.shape[2]

    @classmethod
    def random_init(
        cls,
        num_items: int,
        num_layers: int,
        num_nodes: int,
        num_paths_per_item: int,
        seed: int = 0,
    ) -> "PathIndex":
        rng = np.random.default_rng(seed)
        paths = rng.integers(
            0, num_nodes, size=(num_items, num_paths_per_item, num_layers)
        ).astype(np.int32)
        return cls(item_paths=paths, num_nodes=num_nodes)

    # ------------------------------------------------------------------
    def path_to_items(self) -> dict[tuple, list[int]]:
        """Inverted map path-tuple -> item ids (MappingOp.pathToItems)."""
        out: dict[tuple, list[int]] = {}
        for item in range(self.num_items):
            for j in range(self.num_paths_per_item):
                key = tuple(int(x) for x in self.item_paths[item, j])
                out.setdefault(key, []).append(item)
        return out

    def path_key_of(self, paths: np.ndarray) -> np.ndarray:
        """Encode [..., D] node indices into scalar keys (base-K digits)."""
        paths = np.asarray(paths, dtype=np.int64)
        key = np.zeros(paths.shape[:-1], dtype=np.int64)
        for d in range(paths.shape[-1]):
            key = key * self.num_nodes + paths[..., d]
        return key

    # ------------------------------------------------------------------
    def write(self, path: str, item_to_id: dict[int, int]) -> None:
        """Persist as the reference's single length-prefixed ItemSet blob."""
        items = []
        for raw_item, dense_id in item_to_id.items():
            paths = [
                Path(index=[int(x) for x in self.item_paths[dense_id, j]])
                for j in range(self.num_paths_per_item)
            ]
            items.append(Item(item=raw_item, id=dense_id, paths=paths))
        blob = ItemSet(items=items).encode()
        from dismember_tpu_torch.core.io import open_file

        with open_file(path, "wb") as f:
            f.write(struct.pack(">i", len(blob)))
            f.write(blob)

    @classmethod
    def read(cls, path: str, num_nodes: int) -> tuple["PathIndex", dict[int, int]]:
        from dismember_tpu_torch.core.io import open_file

        with open_file(path, "rb") as f:
            (size,) = struct.unpack(">i", f.read(4))
            blob = f.read(size)
        itemset = ItemSet.decode(blob)
        item_to_id = {it.item: it.id for it in itemset.items}
        num_items = max(item_to_id.values()) + 1 if item_to_id else 0
        j = len(itemset.items[0].paths) if itemset.items else 0
        d = len(itemset.items[0].paths[0].index) if j else 0
        paths = np.zeros((num_items, j, d), dtype=np.int32)
        for it in itemset.items:
            for jj, p in enumerate(it.paths):
                paths[it.id, jj] = p.index
        return cls(item_paths=paths, num_nodes=num_nodes), item_to_id
