"""Deep Retrieval dataset: dense item ids + user windowing.

Copy of ``dismember_tpu/data/dr_dataset.py`` on the port's ``data/ingest.py``.

Parity with deep-retrieval/.../dataset/LocalDataSet.scala:14-210:
- items map to dense ids 0..num_items-1 in first-occurrence order
  (``uniqueItems.zipWithIndex``);
- per user (time-sorted distinct, mapped): windows of seq_len+1 over
  ``[-1]*(seq_len-min_seq_len) ++ items`` up to the split point; a user with
  exactly min_seq_len+1 items contributes one train sample; eval labels are
  the future items minus the consumed prefix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from dismember_tpu_torch.constants import PADDING_IDX
from dismember_tpu_torch.data.ingest import read_csv


@dataclasses.dataclass
class DRData:
    item_to_id: dict[int, int]  # raw item -> dense id
    id_to_item: dict[int, int]
    num_items: int
    train_seqs: np.ndarray  # [N, L] dense ids, -1 pad
    train_targets: np.ndarray  # [N] dense ids
    eval_seqs: np.ndarray  # [M, L]
    eval_labels: np.ndarray  # [M, max_labels] dense ids, -1 pad
    eval_users: np.ndarray  # [M]
    user_consumed: dict[int, np.ndarray]  # dense ids


def build_dr_data(
    data_path: str,
    seq_len: int,
    min_seq_len: int,
    split_ratio: float,
    item_to_id: dict[int, int] | None = None,
) -> DRData:
    raw = read_csv(data_path)
    if item_to_id is None:
        _, fi = np.unique(raw.item, return_index=True)
        uniq = raw.item[np.sort(fi)]
        item_to_id = {int(v): i for i, v in enumerate(uniq)}
    id_to_item = {v: k for k, v in item_to_id.items()}

    order = np.argsort(raw.timestamp, kind="stable")
    users_t, items_t = raw.user[order], raw.item[order]
    uorder = np.argsort(users_t, kind="stable")
    users_s, items_s = users_t[uorder], items_t[uorder]
    boundaries = np.flatnonzero(np.diff(users_s)) + 1
    groups = np.split(items_s, boundaries)
    group_users = (
        np.concatenate([[users_s[0]], users_s[boundaries]]) if len(users_s) else []
    )

    train_seqs: list[np.ndarray] = []
    train_targets: list[int] = []
    eval_seqs: list[np.ndarray] = []
    eval_labels: list[np.ndarray] = []
    eval_users: list[int] = []
    user_consumed: dict[int, np.ndarray] = {}
    pad = np.full(seq_len - min_seq_len, PADDING_IDX, dtype=np.int64)

    for items_u, user in zip(groups, group_users):
        _, fi = np.unique(items_u, return_index=True)
        distinct = items_u[np.sort(fi)]
        ids = np.asarray([item_to_id[int(i)] for i in distinct], dtype=np.int64)
        n = len(ids)
        user = int(user)
        if n <= min_seq_len:
            user_consumed[user] = ids
            continue
        if n == min_seq_len + 1:
            full = np.concatenate([pad, ids[:-1]])
            train_seqs.append(full[:seq_len])
            train_targets.append(int(ids[-1]))
            user_consumed[user] = ids
            continue
        full = np.concatenate([pad, ids])
        split_point = math.ceil((n - min_seq_len) * split_ratio)
        head = full[: split_point + seq_len]
        for i in range(len(head) - seq_len):
            win = head[i : i + seq_len + 1]
            train_seqs.append(win[:seq_len])
            train_targets.append(int(win[seq_len]))
        consumed = ids[: split_point + min_seq_len]
        user_consumed[user] = consumed
        cset = set(consumed.tolist())
        labels = np.asarray(
            [x for x in full[split_point + seq_len :] if int(x) not in cset],
            dtype=np.int64,
        )
        if len(labels) > 0:
            eval_seqs.append(head[-seq_len:])
            eval_labels.append(labels)
            eval_users.append(user)

    max_el = max((len(l) for l in eval_labels), default=1)
    el = np.full((len(eval_labels), max_el), -1, dtype=np.int64)
    for i, l in enumerate(eval_labels):
        el[i, : len(l)] = l

    return DRData(
        item_to_id=item_to_id,
        id_to_item=id_to_item,
        num_items=len(item_to_id),
        train_seqs=(
            np.stack(train_seqs)
            if train_seqs
            else np.zeros((0, seq_len), dtype=np.int64)
        ),
        train_targets=np.asarray(train_targets, dtype=np.int64),
        eval_seqs=(
            np.stack(eval_seqs) if eval_seqs else np.zeros((0, seq_len), dtype=np.int64)
        ),
        eval_labels=el,
        eval_users=np.asarray(eval_users, dtype=np.int64),
        user_consumed=user_consumed,
    )
