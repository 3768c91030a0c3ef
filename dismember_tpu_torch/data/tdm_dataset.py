"""TDM sample generation: user-sequence windowing and the train/eval split.

Port of ``generate_split_samples`` from ``dismember_tpu/data/tdm_dataset.py``
(TreeInit.writeEither in the reference).  The file writers and readers are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from dismember_tpu_torch.constants import PADDING_ID


@dataclasses.dataclass
class TDMSamples:
    """In-memory result of sample generation."""

    train_seqs: np.ndarray  # [N, seq_len] raw item ids (0 = padding)
    train_targets: np.ndarray  # [N]
    train_users: np.ndarray  # [N]
    eval_seqs: np.ndarray  # [M, seq_len]
    eval_labels: np.ndarray  # [M, max_labels], -1 padded
    eval_users: np.ndarray  # [M]
    stat: dict[int, int]  # target item -> occurrence count
    user_consumed: dict[int, np.ndarray]


def generate_split_samples(
    interactions: dict[int, np.ndarray],
    seq_len: int,
    min_seq_len: int,
    split_ratio: float,
) -> TDMSamples:
    """Split-mode sample generation.

    Per user with items ``v`` (time-sorted distinct):
    - ``len(v) <= min_seq_len``: consumed only, no samples.
    - train: windows ``arr[i : i+seq_len+1]`` for ``i < ceil((len(v)-min_seq_len)
      * ratio)`` over ``arr = [0]*(seq_len-min_seq_len) + v``.
    - eval: one sample per user with sequence ``arr[split : split+seq_len]`` and
      labels = the future items not consumed during training.
    """
    if not seq_len >= min_seq_len > 0:
        raise ValueError(f"need seq_len >= min_seq_len > 0, got {seq_len}, {min_seq_len}")
    if not 0 < split_ratio < 1:
        raise ValueError(f"split_ratio must lie in (0, 1), got {split_ratio}")

    train_seqs: list[np.ndarray] = []
    train_targets: list[int] = []
    train_users: list[int] = []
    eval_seqs: list[np.ndarray] = []
    eval_labels: list[np.ndarray] = []
    eval_users: list[int] = []
    stat: dict[int, int] = {}
    user_consumed: dict[int, np.ndarray] = {}

    pad = np.full(seq_len - min_seq_len, PADDING_ID, dtype=np.int64)
    for user in interactions:
        items = interactions[user]
        n = len(items)
        if n <= min_seq_len:
            user_consumed[user] = items
            continue
        arr = np.concatenate([pad, items])
        train_num = math.ceil((n - min_seq_len) * split_ratio)
        if n == min_seq_len + 1:
            user_consumed[user] = items
        else:
            user_consumed[user] = items[: train_num + min_seq_len]
        for i in range(train_num):
            win = arr[i : i + seq_len + 1]
            train_seqs.append(win[:seq_len])
            t = int(win[seq_len])
            train_targets.append(t)
            train_users.append(user)
            stat[t] = stat.get(t, 0) + 1

        if n > min_seq_len + 1:
            split_point = math.ceil((n - min_seq_len) * split_ratio)
            consumed = set(int(x) for x in user_consumed[user])
            seq = arr[split_point : split_point + seq_len]
            future = arr[split_point + seq_len :]
            labels = np.asarray(
                [x for x in future if int(x) not in consumed], dtype=np.int64
            )
            if len(labels) > 0:
                eval_seqs.append(seq)
                eval_labels.append(labels)
                eval_users.append(user)

    max_labels = max((len(l) for l in eval_labels), default=1)
    eval_labels_padded = np.full((len(eval_labels), max_labels), -1, dtype=np.int64)
    for i, l in enumerate(eval_labels):
        eval_labels_padded[i, : len(l)] = l

    empty = np.zeros((0, seq_len), dtype=np.int64)
    return TDMSamples(
        train_seqs=np.stack(train_seqs) if train_seqs else empty,
        train_targets=np.asarray(train_targets, dtype=np.int64),
        train_users=np.asarray(train_users, dtype=np.int64),
        eval_seqs=np.stack(eval_seqs) if eval_seqs else empty,
        eval_labels=eval_labels_padded,
        eval_users=np.asarray(eval_users, dtype=np.int64),
        stat=stat,
        user_consumed=user_consumed,
    )
