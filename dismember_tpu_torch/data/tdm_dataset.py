"""TDM/JTM sample generation: user-sequence windowing, train/eval split, files.

Port of ``dismember_tpu/data/tdm_dataset.py``.  Byte-level parity targets
(reference files):
- train/eval/stat/user_consumed writers: tdm/.../tree/TreeInit.scala:228-333
  (``writeTrain``, ``writeEither``, ``writeStat``, ``writeUserConsumed``)
- readers: tdm/.../dataset/LocalDataSet.scala:137-182

File formats:
- train:      ``user_{user}_{i},s1,...,sL,target``   (split mode), or
              ``{user}_{i},s1,...,sL,target``        (no-split mode)
- eval:       ``user_{user},s1,...,sL,label1,label2,...``
- stat:       ``{item}, {count}``
- consumed:   ``user_{user},i1,i2,...``
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from dismember_tpu_torch.constants import PADDING_ID
from dismember_tpu_torch.core.io import open_file
from dismember_tpu_torch.data.ingest import InitSamples, read_csv, user_interactions


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


def generate_full_samples(
    interactions: dict[int, np.ndarray], seq_len: int, min_seq_len: int
) -> TDMSamples:
    """No-split mode, mirroring TreeInit.writeTrain: all windows become train."""
    train_seqs: list[np.ndarray] = []
    train_targets: list[int] = []
    train_users: list[int] = []
    stat: dict[int, int] = {}
    user_consumed: dict[int, np.ndarray] = {}
    pad = np.full(seq_len - min_seq_len, PADDING_ID, dtype=np.int64)
    for user, items in interactions.items():
        user_consumed[user] = items
        if len(items) > min_seq_len:
            arr = np.concatenate([pad, items])
            for i in range(len(arr) - seq_len):
                win = arr[i : i + seq_len + 1]
                train_seqs.append(win[:seq_len])
                t = int(win[seq_len])
                train_targets.append(t)
                train_users.append(user)
                stat[t] = stat.get(t, 0) + 1
    return TDMSamples(
        train_seqs=(
            np.stack(train_seqs) if train_seqs else np.zeros((0, seq_len), dtype=np.int64)
        ),
        train_targets=np.asarray(train_targets, dtype=np.int64),
        train_users=np.asarray(train_users, dtype=np.int64),
        eval_seqs=np.zeros((0, seq_len), dtype=np.int64),
        eval_labels=np.zeros((0, 1), dtype=np.int64),
        eval_users=np.zeros(0, dtype=np.int64),
        stat=stat,
        user_consumed=user_consumed,
    )


# ---------------------------------------------------------------------------
# File writers / readers (format parity with the reference)
# ---------------------------------------------------------------------------


def write_train_file(path: str, samples: TDMSamples, split_mode: bool = True) -> None:
    per_user_counter: dict[int, int] = {}
    with open_file(path, "w", encoding="utf-8") as f:
        for seq, target, user in zip(
            samples.train_seqs, samples.train_targets, samples.train_users
        ):
            i = per_user_counter.get(int(user), 0)
            per_user_counter[int(user)] = i + 1
            prefix = f"user_{user}_{i}" if split_mode else f"{user}_{i}"
            fields = ",".join(str(int(x)) for x in seq) + f",{int(target)}"
            f.write(f"{prefix},{fields}\n")


def write_eval_file(path: str, samples: TDMSamples) -> None:
    with open_file(path, "w", encoding="utf-8") as f:
        for seq, labels, user in zip(
            samples.eval_seqs, samples.eval_labels, samples.eval_users
        ):
            valid = labels[labels >= 0]
            fields = ",".join(str(int(x)) for x in seq)
            lab = ",".join(str(int(x)) for x in valid)
            f.write(f"user_{user},{fields},{lab}\n")


def write_stat_file(path: str, stat: dict[int, int]) -> None:
    with open_file(path, "w", encoding="utf-8") as f:
        for item, count in stat.items():
            f.write(f"{item}, {count}\n")


def write_user_consumed_file(path: str, user_consumed: dict[int, np.ndarray]) -> None:
    with open_file(path, "w", encoding="utf-8") as f:
        for user, items in user_consumed.items():
            tail = ",".join(str(int(x)) for x in items)
            f.write(f"user_{user},{tail}\n")


def read_train_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (seqs [N, L], targets [N]).

    Mirrors LocalDataSet.readTrainData: the first column (sample id) is
    dropped; rows whose sequence is entirely padding are filtered out.
    """
    seqs: list[list[int]] = []
    targets: list[int] = []
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            arr = line.strip().split(",")
            if len(arr) < 3:
                continue
            seq = [int(float(x)) for x in arr[1:-1]]
            if not any(x != PADDING_ID for x in seq):
                continue
            seqs.append(seq)
            targets.append(int(arr[-1]))
    return (
        np.asarray(seqs, dtype=np.int64),
        np.asarray(targets, dtype=np.int64),
    )


def read_eval_file(path: str, seq_len: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (seqs [M, L], labels [M, max_labels] padded with -1, users [M])."""
    seqs: list[list[int]] = []
    labels: list[list[int]] = []
    users: list[int] = []
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            arr = line.strip().split(",")
            users.append(int(arr[0][5:]))  # strip "user_"
            seqs.append([int(x) for x in arr[1 : seq_len + 1]])
            labels.append([int(x) for x in arr[seq_len + 1 :]])
    max_labels = max((len(l) for l in labels), default=1)
    padded = np.full((len(labels), max_labels), -1, dtype=np.int64)
    for i, l in enumerate(labels):
        padded[i, : len(l)] = l
    return (
        np.asarray(seqs, dtype=np.int64),
        padded,
        np.asarray(users, dtype=np.int64),
    )


def read_user_consumed_file(path: str) -> dict[int, np.ndarray]:
    out: dict[int, np.ndarray] = {}
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            arr = line.strip().split(",")
            out[int(arr[0][5:])] = np.asarray([int(x) for x in arr[1:]], dtype=np.int64)
    return out


def read_stat_file(path: str) -> dict[int, int]:
    out: dict[int, int] = {}
    with open_file(path, "r", encoding="utf-8") as f:
        for line in f:
            arr = line.strip().split(",")
            if len(arr) == 2:
                out[int(arr[0].strip())] = int(arr[1].strip())
    return out


def generate_all(
    data_path: str,
    seq_len: int,
    min_seq_len: int,
    split_for_eval: bool,
    split_ratio: float,
) -> tuple[TDMSamples, InitSamples]:
    """End-to-end ingest + windowing (the data half of TreeInit.generate)."""
    raw = read_csv(data_path)
    inter = user_interactions(raw)
    if split_for_eval:
        samples = generate_split_samples(inter, seq_len, min_seq_len, split_ratio)
    else:
        samples = generate_full_samples(inter, seq_len, min_seq_len)
    return samples, raw
