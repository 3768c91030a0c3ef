"""CSV ingestion and per-user interaction extraction.

Port of ``dismember_tpu/data/ingest.py``: rows are
``user,item,label,timestamp,category``; rows whose first field is
non-numeric (the header) are skipped; per user the items are sorted by
timestamp (stable) and de-duplicated keeping the first occurrence.  Parsing
and grouping run in the native host library (``data/native.py``) when it
loads, else in the Python forms here, which give the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dismember_tpu_torch.core.io import open_file, stage_in
from dismember_tpu_torch.data.native import parse_csv_native, user_interactions_native


@dataclasses.dataclass
class InitSamples:
    """Columnar raw interactions (mirrors TreeInit.InitSample)."""

    user: np.ndarray  # int64
    item: np.ndarray  # int64
    category: np.ndarray  # int32 codes, first-occurrence order
    label: np.ndarray  # float32 codes, first-occurrence order
    timestamp: np.ndarray  # int64
    category_names: list[str]  # code -> original category string


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def read_csv(path: str) -> InitSamples:
    """CSV ingest (local or remote URL)."""
    with stage_in(path) as local:
        native = parse_csv_native(local)
        if native is not None:
            users, items, cats, labels, timestamps, cat_names = native
            return InitSamples(user=users, item=items, category=cats, label=labels,
                               timestamp=timestamps, category_names=cat_names)
        return _read_csv_python(local)


def _read_csv_python(path: str) -> InitSamples:
    users: list[int] = []
    items: list[int] = []
    cats: list[int] = []
    labels: list[float] = []
    times: list[int] = []
    cat_dict: dict[str, int] = {}
    label_dict: dict[str, float] = {}
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            arr = line.strip().split(",")
            if len(arr) != 5 or not _is_number(arr[0]):
                continue
            users.append(int(arr[0]))
            items.append(int(arr[1]))
            times.append(int(arr[3]))
            if arr[2] not in label_dict:
                label_dict[arr[2]] = float(len(label_dict))
            labels.append(label_dict[arr[2]])
            if arr[4] not in cat_dict:
                cat_dict[arr[4]] = len(cat_dict)
            cats.append(cat_dict[arr[4]])
    return InitSamples(
        user=np.asarray(users, dtype=np.int64),
        item=np.asarray(items, dtype=np.int64),
        category=np.asarray(cats, dtype=np.int32),
        label=np.asarray(labels, dtype=np.float32),
        timestamp=np.asarray(times, dtype=np.int64),
        category_names=list(cat_dict.keys()),
    )


def user_interactions(samples: InitSamples) -> dict[int, np.ndarray]:
    """user -> time-sorted distinct item sequence (first occurrence kept),
    mirroring TreeInit.getUserInteracted: a stable sort by timestamp within
    each user, then ``distinct``."""
    native = user_interactions_native(samples.user, samples.item, samples.timestamp)
    if native is not None:
        return native
    order = np.argsort(samples.timestamp, kind="stable")
    users = samples.user[order]
    items = samples.item[order]
    out: dict[int, np.ndarray] = {}
    uorder = np.argsort(users, kind="stable")
    users_s = users[uorder]
    items_s = items[uorder]
    boundaries = np.flatnonzero(np.diff(users_s)) + 1
    for chunk_items, u in zip(
        np.split(items_s, boundaries),
        np.concatenate([[users_s[0]], users_s[boundaries]]) if len(users_s) else [],
    ):
        _, first_idx = np.unique(chunk_items, return_index=True)
        out[int(u)] = chunk_items[np.sort(first_idx)]
    return out


def unique_items_with_category(samples: InitSamples) -> tuple[np.ndarray, np.ndarray]:
    """Distinct items (first occurrence) with their categories
    (TreeInit.initializeTree's ``distinctBy(_.itemId)``)."""
    _, first_idx = np.unique(samples.item, return_index=True)
    first_idx = np.sort(first_idx)
    return samples.item[first_idx], samples.category[first_idx]
